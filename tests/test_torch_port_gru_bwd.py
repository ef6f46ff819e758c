"""The launch plans and decompositions of the port's GRU backward (CPU).

`cuda_gru.bwd_plan` lays the reverse recurrence over thread-block clusters
(csrc/gru.cu `gru_bwd_cluster_kernel`) or, for a hidden size whose rows of
W_hh^T fit no cluster, over the whole grid (`gru_bwd_grid_kernel`, by
`grid_plan`). What a block owns is checked here without a card, and a
float64 emulation of each
decomposition (groups, slices, the exchange of the gate gradients and the
order of the split sum) equals the plain backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.ops import pallas_gru
from stemgnn_tpu_torch.ops import cuda_gru, torch_impl

torch.set_num_threads(1)

HIDDEN = [1, 20, 37, 140, 228, 358, 360, 361, 512]
BATCH = [1, 5, 26, 32, 64]
PORTABLE_FIT = 360  # the largest H whose slices fit a cluster of 8 blocks
H100 = (132, 232_448)  # an H100 SXM's SMs and the shared memory a block can opt in to


def _covers_once(ranges, total):
    seen = np.zeros(total, dtype=np.int64)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= total
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("b", BATCH)
def test_bwd_plan_covers_units_and_rows_once(b, h):
    plan = cuda_gru.bwd_plan(b, h, *H100)
    assert _covers_once(plan.slices(h), h)
    assert _covers_once(plan.batch_groups(b), b)
    assert plan.smem <= cuda_gru.SMEM_PER_BLOCK
    assert plan.threads % 32 == 0
    # the same route as the forward's plan at every shape
    assert plan.route == cuda_gru.launch_plan(b, h, *H100).route
    if plan.route == "cluster":
        assert h <= PORTABLE_FIT and 1 <= plan.cluster <= cuda_gru.MAX_CLUSTER
        assert plan.rows == cuda_gru.ROWS and plan.groups == -(-b // plan.rows)
        assert len(plan.slices(h)) == plan.cluster
        assert plan.slice * plan.rows <= plan.threads <= 256
        # a resident row holds the 3H weights of one unit, padded to the
        # k-parts and then to 4 (mod 32) floats, by fewer than 32
        c3 = -(-3 * h // plan.rows) * plan.rows
        assert c3 <= plan.row_stride < c3 + 32 and plan.row_stride % 32 == 4
        assert plan.smem == 16 + 4 * (plan.slice * plan.row_stride + 2 * c3 * plan.rows)
    else:
        assert h > PORTABLE_FIT and plan.route == "grid"
        assert plan == cuda_gru.grid_plan(b, h, *H100, backward=True)
        assert plan.rows == -(-b // 8) * 8 and plan.groups == 1
        assert len(plan.slices(h)) == plan.cluster <= H100[0]
        # the counter and two dcat buffers [3H][rows]
        assert plan.workspace == 16 + 4 * 2 * 3 * h * plan.rows


def test_bwd_plan_routes_the_forwards_range():
    for b in (1, 32, 64):
        fwd = [cuda_gru.launch_plan(b, h, *H100).route for h in range(1, 530)]
        bwd = [cuda_gru.bwd_plan(b, h, *H100).route for h in range(1, 530)]
        assert bwd == fwd
        assert bwd[:PORTABLE_FIT] == ["cluster"] * PORTABLE_FIT
        assert set(bwd[PORTABLE_FIT:]) == {"grid"}
    # the flagship: 8 clusters of 5 blocks, 28 units a block
    assert cuda_gru.bwd_plan(32, 140, *H100)[:7] == ("cluster", 4, 8, 5, 28, 420, 128)
    # the widest model: the grid route at both batches, forward and backward,
    # 128 blocks of 4 units; the backward keeps its rows of W_hh^T resident
    # and reads each step's dcat [1536][rows] from L2, which does not fit
    # beside them
    for b in (32, 64):
        for plan in (cuda_gru.launch_plan(b, 512, *H100), cuda_gru.bwd_plan(b, 512, *H100)):
            assert plan[:5] == ("grid", b, 1, 128, 4)
        # the dcat [1536][rows] of a step in 2 (B = 32) or 3 (B = 64) chunks
        assert cuda_gru.bwd_plan(b, 512, *H100)[-2:] == (True, 768 if b == 32 else 512)
    # past the shared memory of a block: the rows of W_hh^T read from L2 too
    wide = cuda_gru.bwd_plan(1, 1300, *H100)
    assert wide[:5] == ("grid", 8, 1, 130, 10)
    assert (wide.resident, cuda_gru.bwd_plan(1, 2500, *H100).resident) == (True, False)


def _transpose_reduce_sum(parts):
    """What `transpose_reduce` (csrc/device_utils.cuh) makes of the R = 4
    partial sums of a row: a fixed tree, pairs 2 apart first."""
    p0, p1, p2, p3 = parts
    return (p0 + p2) + (p1 + p3)


def _emulate_bwd_cluster(plan, saved, g, a_all):
    """The reverse recurrence as the cluster kernel cuts it. Per batch group
    and step: each block's lanes do the gate math of their (unit, row) with
    the dh each keeps, and send (dr, dz, dn * r) into the dcat [C3][R] that
    every block then holds; each block sums over all of it for its own units,
    the sum split into R k-parts (c = q, q + R, ...) added by the fixed tree."""
    n, _, b, h = saved.shape
    r_ = plan.rows
    c3 = -(-3 * h // r_) * r_
    a_pad = np.zeros((h, c3))
    a_pad[:, : 3 * h] = a_all  # row j: the resident weights of unit j
    dxp = np.zeros((n, b, 3 * h))
    for lo, hi in plan.batch_groups(b):
        live = hi - lo
        dh = np.zeros((r_, h))  # lane (j, p)'s register
        for t in range(n - 1, -1, -1):
            dcat = np.zeros((c3, r_))
            dh_z = np.zeros((r_, h))
            for j0, j1 in plan.slices(h):  # each block's gate math, then its sends
                r, z, hpn, c, hmc = (np.zeros((r_, j1 - j0)) for _ in range(5))
                gt = np.zeros((r_, j1 - j0))
                for arr, q in zip((r, z, hpn, c, hmc), range(5)):
                    arr[:live] = saved[t, q, lo:hi, j0:j1]
                gt[:live] = g[lo:hi, t, j0:j1]
                dh_total = gt + dh[:, j0:j1]
                dz = dh_total * hmc * z * (1.0 - z)
                dn = dh_total * (1.0 - z) * (1.0 - c * c)
                dr = dn * hpn * r * (1.0 - r)
                for gate, v in enumerate((dr, dz, dn * r)):
                    dcat[gate * h + j0 : gate * h + j1] = v.T
                dxp[t, lo:hi, j0:j1] = dr[:live]
                dxp[t, lo:hi, h + j0 : h + j1] = dz[:live]
                dxp[t, lo:hi, 2 * h + j0 : 2 * h + j1] = dn[:live]
                dh_z[:, j0:j1] = dh_total * z
            for j0, j1 in plan.slices(h):  # each block's product, its own units
                parts = [a_pad[j0:j1, q::r_] @ dcat[q::r_] for q in range(r_)]
                dh[:, j0:j1] = dh_z[:, j0:j1] + _transpose_reduce_sum(parts).T
    return dxp


def _tree8(parts):
    """`transpose_reduce` of R = 8 partial sums: a fixed tree, pairs 4 apart first."""
    return (((parts[0] + parts[4]) + (parts[2] + parts[6]))
            + ((parts[1] + parts[5]) + (parts[3] + parts[7])))


def _emulate_bwd_grid(plan, saved, g, a_all):
    """The reverse recurrence as the grid kernel cuts it. Per step: each block
    does the gate math of its slice for all rows with the dh it keeps and
    writes (dr, dz, dn * r) into the exchange buffer dcat [3H][rows] (its rows
    past B zero); after every block has counted the step, each reads all of
    dcat, `plan.chunk` rows at a time, and sums it for its own units, the sum
    split into 8 k-parts and `ksplit` splits (in a chunk from c0: c = c0 + p +
    8 ks, c0 + p + 8 ks + 8 KS, ...), the parts added by the fixed tree to
    their split's sum chunk after chunk, the splits in order."""
    n, _, b, h = saved.shape
    step = 8 * plan.ksplit
    dxp = np.zeros((n, b, 3 * h))
    dh = np.zeros((plan.rows, h))
    for t in range(n - 1, -1, -1):
        dcat = np.zeros((3 * h, plan.rows))
        dh_z = np.zeros((plan.rows, h))
        for j0, j1 in plan.slices(h):  # each block's gate math and its writes
            r, z, hpn, c, hmc = (saved[t, q, :, j0:j1] for q in range(5))
            dh_total = g[:, t, j0:j1] + dh[:b, j0:j1]
            dz = dh_total * hmc * z * (1.0 - z)
            dn = dh_total * (1.0 - z) * (1.0 - c * c)
            dr = dn * hpn * r * (1.0 - r)
            for gate, v in enumerate((dr, dz, dn * r)):
                dcat[gate * h + j0 : gate * h + j1, :b] = v.T
            dxp[t, :, j0:j1], dxp[t, :, h + j0 : h + j1] = dr, dz
            dxp[t, :, 2 * h + j0 : 2 * h + j1] = dn
            dh_z[:b, j0:j1] = dh_total * z
        for j0, j1 in plan.slices(h):  # each block's product, its own units
            splits = [0.0] * plan.ksplit
            for c0 in range(0, 3 * h, plan.chunk):
                c1 = min(3 * h, c0 + plan.chunk)
                for ks in range(plan.ksplit):
                    ks_c = [slice(c0 + p + 8 * ks, c1, step) for p in range(8)]
                    splits[ks] = splits[ks] + _tree8([a_all[j0:j1, c] @ dcat[c] for c in ks_c])
            total = splits[0]
            for part in splits[1:]:
                total = total + part
            dh[:, j0:j1] = dh_z[:, j0:j1] + total.T
    return dxp


@pytest.mark.parametrize("b,h,sms,smem", [(13, 45, 4, None), (3, 70, 6, None),
                                          (9, 37, 5, None), (13, 45, 4, 23_000),
                                          (13, 30, 4, None), (20, 41, 6, None)])
def test_bwd_grid_decomposition_equals_the_plain_backward(b, h, sms, smem):
    rng = np.random.default_rng(80 + b)
    _, a_all, _, saved, g = _saved_and_g(rng, 9, b, h)
    # few SMs cut these small H into several slices, the last one short, and
    # the 3H-long sums into ragged k-splits; a small shared memory stages dcat
    # in chunks
    plan = cuda_gru.grid_plan(b, h, sms, smem or H100[1], backward=True)
    assert plan.cluster > 1 and h % plan.slice and b % 8 and plan.ksplit > 1
    assert (plan.chunk < 3 * h) == (smem is not None)
    got = _emulate_bwd_grid(plan, saved.numpy(), g.numpy(), a_all.numpy())
    want = torch_impl.gru_scan_bwd(saved, g, a_all)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("b,h,sms", [(13, 45, 4), (3, 397, 7)])
def test_bwd_grid_decomposition_matches_the_pallas_vjp(b, h, sms):
    # ragged grid cases straight against the JAX package's Pallas backward
    # (interpret mode) on float32 inputs, the emulation in float64 on them:
    # 45 units on 4 SMs (12 a block, the last 9), 397 on 7 (57, the last 55)
    n = 9
    rng = np.random.default_rng(85 + b)
    bound = 1.0 / np.sqrt(h)
    x_proj = rng.standard_normal((n, b, 3 * h)).astype(np.float32)
    a_all = rng.uniform(-bound, bound, (h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-bound, bound, 3 * h).astype(np.float32)
    g = rng.standard_normal((b, n, h)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, res = pallas_gru._vjp_fwd(
            jnp.asarray(x_proj.reshape(n, b, 3, h).transpose(0, 2, 1, 3)),
            jnp.asarray(a_all.reshape(h, 3, h).transpose(1, 0, 2)),
            jnp.asarray(b_hh.reshape(3, 1, h)))
        want, _, _ = pallas_gru._vjp_bwd(res, jnp.asarray(g.transpose(1, 0, 2)))
    _, saved = torch_impl.gru_scan(*(torch.from_numpy(a).double()
                                     for a in (x_proj, a_all, b_hh)), save=True)
    plan = cuda_gru.grid_plan(b, h, sms, H100[1], backward=True)
    assert plan.cluster == sms and h % plan.slice and b % 8
    got = _emulate_bwd_grid(plan, saved.numpy(), g.astype(np.float64),
                            a_all.astype(np.float64))
    # f32 there, 9 dependent steps: 1e-5 absolute on gradients of order 1
    np.testing.assert_allclose(
        np.asarray(got).reshape(n, b, 3, h).transpose(0, 2, 1, 3), np.asarray(want),
        rtol=0, atol=1e-5)


def _saved_and_g(rng, n, b, h):
    """A forward of the plain recurrence in float64 on seeded inputs: its
    saved activations, a cotangent and W_hh^T."""
    bound = 1.0 / np.sqrt(h)
    x_proj = torch.from_numpy(rng.standard_normal((n, b, 3 * h)))
    a_all = torch.from_numpy(rng.uniform(-bound, bound, (h, 3 * h)))
    b_hh = torch.from_numpy(rng.uniform(-bound, bound, 3 * h))
    _, saved = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
    g = torch.from_numpy(rng.standard_normal((b, n, h)))
    return x_proj, a_all, b_hh, saved, g


@pytest.mark.parametrize("b,h", [(6, 37), (26, 45)])
def test_bwd_cluster_decomposition_equals_the_plain_backward(b, h):
    rng = np.random.default_rng(60 + b)
    _, a_all, _, saved, g = _saved_and_g(rng, 9, b, h)
    # a cluster size that cuts these small H into several ragged slices
    plan = cuda_gru._bwd_cluster_plan(b, h, 4)
    assert plan.cluster > 1 and h % plan.slice and b % plan.rows and (3 * h) % plan.rows
    got = _emulate_bwd_cluster(plan, saved.numpy(), g.numpy(), a_all.numpy())
    want = torch_impl.gru_scan_bwd(saved, g, a_all)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


def test_plain_backward_matches_the_pallas_vjp_at_a_ragged_shape():
    n, b, h = 9, 6, 37
    rng = np.random.default_rng(66)
    bound = 1.0 / np.sqrt(h)
    x_proj = rng.standard_normal((n, b, 3 * h)).astype(np.float32)
    a_all = rng.uniform(-bound, bound, (h, 3 * h)).astype(np.float32)
    b_hh = rng.uniform(-bound, bound, 3 * h).astype(np.float32)
    g = rng.standard_normal((b, n, h)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        # the JAX package's layouts: x_proj [N, 3, B, H], a3 [3, H, H], bh3 [3, 1, H]
        _, res = pallas_gru._vjp_fwd(
            jnp.asarray(x_proj.reshape(n, b, 3, h).transpose(0, 2, 1, 3)),
            jnp.asarray(a_all.reshape(h, 3, h).transpose(1, 0, 2)),
            jnp.asarray(b_hh.reshape(3, 1, h)))
        want, _, _ = pallas_gru._vjp_bwd(res, jnp.asarray(g.transpose(1, 0, 2)))
    _, saved = torch_impl.gru_scan(torch.from_numpy(x_proj), torch.from_numpy(a_all),
                                   torch.from_numpy(b_hh), save=True)
    got = torch_impl.gru_scan_bwd(saved, torch.from_numpy(g), torch.from_numpy(a_all))
    # f32, 9 dependent steps: 1e-5 absolute on gradients of order 1
    np.testing.assert_allclose(
        got.numpy().reshape(n, b, 3, h).transpose(0, 2, 1, 3), np.asarray(want),
        atol=1e-5)
