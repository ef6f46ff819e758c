"""The launch plans of the port's GRU forward and graph convolution (CPU).

The CUDA kernels take their decomposition from pure-Python functions of the
shape (`cuda_gru.launch_plan`, `cuda_gru.grid_plan`, `cuda_graph.launch_plan`),
so what a block owns is checked here without a card: slices and batch groups
cover every hidden unit and batch row once, shared memory stays within a
block's, and a plain PyTorch emulation of each decomposition (across a
cluster, across the grid) equals the plain recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.ops.pallas_gru import gru_scan_pallas
from stemgnn_tpu_torch.ops import cuda_graph, cuda_gru, torch_impl

torch.set_num_threads(1)

HIDDEN = [140, 170, 228, 307, 358, 512]
BATCH = [1, 6, 26, 32, 64]
PORTABLE_FIT = 360  # the largest H whose slices fit a cluster of 8 blocks
# an H100 SXM: its SMs and the shared memory a block can opt in to (the plans
# take the card's own, which the wrappers read from the CUDA runtime)
H100 = (132, 232_448)


def _covers_once(ranges, total):
    seen = np.zeros(total, dtype=np.int64)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= total
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("b", BATCH)
def test_gru_plan_covers_units_and_rows_once(b, h):
    plan = cuda_gru.launch_plan(b, h, *H100)
    assert _covers_once(plan.slices(h), h)
    assert _covers_once(plan.batch_groups(b), b)
    assert plan.smem <= cuda_gru.SMEM_PER_BLOCK
    assert plan.threads % 32 == 0
    if plan.route == "cluster":
        assert 1 <= plan.cluster <= cuda_gru.MAX_CLUSTER
        assert h <= PORTABLE_FIT
        assert plan.rows == cuda_gru.ROWS and plan.groups == -(-b // plan.rows)
        assert len(plan.slices(h)) == plan.cluster
        # a thread for every (unit of the slice, row of the group), at most
        # the kernel's launch bound
        assert plan.slice * plan.rows <= plan.threads <= 256
        # the three gates of a slice side by side in a row of the resident
        # weights; the row stride an odd multiple of the units a warp holds
        units_per_warp = 32 // plan.rows
        assert plan.row_stride >= 3 * plan.slice
        assert plan.row_stride % units_per_warp == 0
        assert plan.row_stride // units_per_warp % 2 == 1
        hp = -(-h // plan.rows) * plan.rows
        assert plan.smem == 4 * (hp * plan.row_stride + 2 * hp * plan.rows)
    else:
        # one cooperative grid: a block an SM at most, each a slice for all rows
        assert h > PORTABLE_FIT and plan.route == "grid"
        assert plan == cuda_gru.grid_plan(b, h, *H100)
        assert plan.rows == -(-b // 8) * 8 and plan.groups == 1
        assert plan.cluster <= H100[0]


def test_gru_plan_fit_rule_and_routes():
    routes = [cuda_gru.launch_plan(32, h, *H100).route for h in range(1, 520)]
    assert routes[:PORTABLE_FIT] == ["cluster"] * PORTABLE_FIT
    assert set(routes[PORTABLE_FIT:]) == {"grid"}
    assert cuda_gru.launch_plan(32, 140, *H100)[:7] == ("cluster", 4, 8, 5, 28, 88, 128)
    assert cuda_gru.launch_plan(32, 358, *H100).cluster == 8
    # a larger cluster limit takes H = 512 in; at the portable limit every
    # hidden size past 360 goes across the grid: at H = 512 128 blocks of 4
    # units, every batch row a block, the slice and h in shared memory
    assert cuda_gru.launch_plan(32, 512, *H100, max_cluster=16).route == "cluster"
    assert cuda_gru.launch_plan(64, 512, *H100)[:5] == ("grid", 64, 1, 128, 4)
    assert cuda_gru.launch_plan(32, 512, *H100)[:5] == ("grid", 32, 1, 128, 4)
    big = cuda_gru.launch_plan(32, 512, *H100)
    assert (big.threads, big.ksplit, big.resident, big.chunk) == (512, 4, True, 512)
    assert big.workspace == 16 + 4 * 2 * 512 * 32
    # the card's own SM count and shared memory make the plan
    assert cuda_gru.launch_plan(8, 1024, 114, H100[1]).cluster == 114
    assert cuda_gru.launch_plan(8, 1024, H100[0], 100_000).resident is False
    # the grid route streams the slice of W_hh^T from L2 where it does not
    # fit (H = 2500: 19 units a block, [2500][60] floats)
    assert cuda_gru.launch_plan(32, 2500, *H100)[:5] == ("grid", 32, 1, 132, 19)
    assert cuda_gru.launch_plan(32, 2500, *H100).resident is False
    with pytest.raises(ValueError):
        cuda_gru.launch_plan(0, 140, *H100)
    with pytest.raises(ValueError):
        cuda_gru.grid_plan(1, 512, 0, H100[1])
    with pytest.raises(ValueError, match="no 8 rows"):
        cuda_gru.grid_plan(64, 512, H100[0], 10_000)


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("h", [361, 512, 1024, 1300, 2500])
@pytest.mark.parametrize("b", [1, 8, 32, 64])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_grid_plan_covers_units_and_rows_once(backward, b, h, sms):
    plan = cuda_gru.grid_plan(b, h, sms, H100[1], backward=backward)
    assert plan.route == "grid"
    # every hidden unit in one block's slice, no slice empty, a block an SM at most
    assert _covers_once(plan.slices(h), h)
    assert len(plan.slices(h)) == plan.cluster <= sms
    assert plan.slice == -(-h // sms)
    # every batch row in the one group, padded to the 8 rows of a warp's task
    assert _covers_once(plan.batch_groups(b), b)
    assert plan.groups == 1 and plan.rows % 8 == 0 and plan.rows - 8 < b <= plan.rows
    # whole warps, at most the kernels' launch bound; the k-splits at most
    # fill the 16 warps
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    tasks = -(-plan.slice // 4) * (plan.rows // 8)
    assert plan.ksplit >= 1 and (plan.ksplit == 1 or tasks * plan.ksplit <= 16)
    assert plan.smem <= H100[1]
    k_len = 3 * h if backward else h
    assert plan.workspace == 16 + 4 * 2 * k_len * plan.rows
    # a step's exchanged values staged in the fewest chunks of equal rows that
    # fit, a multiple of 8 (one chunk fewer would not fit)
    chunks = -(-k_len // plan.chunk)
    assert plan.chunk % 8 == 0 and plan.chunk - 8 < -(-k_len // chunks) <= plan.chunk
    row_bytes = 4 * (plan.rows + 4)
    if chunks > 1:
        fewer = -(-k_len // (chunks - 1) // 8) * 8
        assert plan.smem - row_bytes * plan.chunk + row_bytes * fewer > H100[1]
    if backward:  # a resident row of 3H weights, padded to 8 (mod 32) floats
        assert k_len <= plan.row_stride < k_len + 32 and plan.row_stride % 32 == 8
    else:  # the three gates side by side, an odd multiple of 4 floats
        assert plan.row_stride >= 3 * plan.slice and plan.row_stride % 8 == 4
    # the slice stays resident up to about H = 1,400 on 132 SMs at B <= 8
    if sms == 132 and h <= 1024 and b <= 8:
        assert plan.resident


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_grid_plan_keeps_what_fits_in_shared_memory(backward):
    """The slice of W_hh^T stays resident while it fits beside the fixed
    buffers and a step's exchanged values, staged in chunks where they do not
    fit whole; past that it is read from L2 and the exchanged values get the
    room. A smaller card takes more units a block and the same rule."""
    k_len = lambda h: 3 * h if backward else h  # noqa: E731
    whole = cuda_gru.grid_plan(8, 512, *H100, backward=backward)
    assert whole.resident and whole.chunk >= k_len(512)
    streamed = cuda_gru.grid_plan(8, 2500, *H100, backward=backward)
    assert not streamed.resident and streamed.slice == 19
    # less shared memory: the same slices, the exchanged values in more chunks
    tight = cuda_gru.grid_plan(32, 1024, H100[0], 60_000, backward=backward)
    roomy = cuda_gru.grid_plan(32, 1024, *H100, backward=backward)
    assert tight.slices(1024) == roomy.slices(1024)
    assert -(-k_len(1024) // tight.chunk) > -(-k_len(1024) // roomy.chunk)
    assert tight.smem <= 60_000
    # fewer SMs: wider slices
    assert cuda_gru.grid_plan(8, 1024, 114, H100[1], backward=backward).slice == 9


def _emulate(plan, x_proj, a_all, b_hh):
    """The recurrence as the cluster kernel cuts it: every batch group on its
    own, h' of a step computed slice by slice from the whole h of the group
    and concatenated."""
    n, b, _ = x_proj.shape
    h_dim = a_all.shape[0]
    outs = []
    for lo, hi in plan.batch_groups(b):
        h = x_proj.new_zeros((hi - lo, h_dim))
        steps = []
        for t in range(n):
            parts = []
            for j0, j1 in plan.slices(h_dim):
                cols = [g * h_dim + j for g in range(3) for j in range(j0, j1)]
                hp = (h @ a_all[:, cols] + b_hh[cols]).reshape(hi - lo, 3, j1 - j0)
                xp = x_proj[t, lo:hi][:, cols].reshape(hi - lo, 3, j1 - j0)
                r = torch.sigmoid(xp[:, 0] + hp[:, 0])
                z = torch.sigmoid(xp[:, 1] + hp[:, 1])
                c = torch.tanh(xp[:, 2] + r * hp[:, 2])
                parts.append((1.0 - z) * c + z * h[:, j0:j1])
            h = torch.cat(parts, dim=1)
            steps.append(h)
        outs.append(torch.stack(steps, dim=1))
    return torch.cat(outs, dim=0)


def _gru_inputs(rng, n, b, h, dtype):
    bound = 1.0 / np.sqrt(h)
    return (rng.standard_normal((n, b, 3 * h)).astype(dtype),
            rng.uniform(-bound, bound, (h, 3 * h)).astype(dtype),
            rng.uniform(-bound, bound, 3 * h).astype(dtype))


@pytest.mark.parametrize("b,h", [(6, 37), (26, 45)])
def test_gru_decomposition_equals_the_plain_recurrence(b, h):
    rng = np.random.default_rng(40 + b)
    args = [torch.from_numpy(a) for a in _gru_inputs(rng, 9, b, h, np.float64)]
    # a cluster limit that cuts these small H into several ragged slices
    plan = cuda_gru._cluster_plan(b, h, 4)
    assert plan.cluster > 1 and h % plan.slice and b % plan.rows
    got = _emulate(plan, *args)
    want = torch_impl.gru_scan(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def _tree8(parts):
    """What `transpose_reduce` (csrc/device_utils.cuh) makes of the R = 8
    partial sums of a row: a fixed tree, pairs 4 apart first."""
    return (((parts[0] + parts[4]) + (parts[2] + parts[6]))
            + ((parts[1] + parts[5]) + (parts[3] + parts[7])))


def _grid_sum(plan, lhs, rhs, k_len):
    """lhs [rows, k_len] @ rhs [k_len, cols] as a grid block sums it: chunk by
    chunk of `plan.chunk` rows, the k of split ks and k-part p in a chunk from
    c0 are c0 + p + 8 ks, c0 + p + 8 ks + 8 KS, ...; the 8 parts of a split by
    the fixed tree, added to the split's sum chunk after chunk, then the
    splits in order."""
    step = 8 * plan.ksplit
    splits = [0.0] * plan.ksplit
    for c0 in range(0, k_len, plan.chunk):
        c1 = min(k_len, c0 + plan.chunk)
        for ks in range(plan.ksplit):
            ks_k = [slice(c0 + p + 8 * ks, c1, step) for p in range(8)]
            splits[ks] = splits[ks] + _tree8([lhs[:, k] @ rhs[k] for k in ks_k])
    total = splits[0]
    for part in splits[1:]:
        total = total + part
    return total


def _emulate_grid(plan, x_proj, a_all, b_hh):
    """The recurrence as the grid kernel cuts it: per step, every block reads
    the whole h of the exchange buffer (its rows past B zero), computes h' of
    its slice for all rows and writes it into the other buffer."""
    n, b, _ = x_proj.shape
    h_dim = a_all.shape[0]
    hx = x_proj.new_zeros((plan.rows, h_dim))
    steps = []
    for t in range(n):
        nxt = x_proj.new_zeros((plan.rows, h_dim))
        for j0, j1 in plan.slices(h_dim):
            cols = [g * h_dim + j for g in range(3) for j in range(j0, j1)]
            hp = (_grid_sum(plan, hx, a_all[:, cols], h_dim)[:b] + b_hh[cols]).reshape(
                b, 3, j1 - j0)
            xp = x_proj[t][:, cols].reshape(b, 3, j1 - j0)
            r = torch.sigmoid(xp[:, 0] + hp[:, 0])
            z = torch.sigmoid(xp[:, 1] + hp[:, 1])
            c = torch.tanh(xp[:, 2] + r * hp[:, 2])
            nxt[:b, j0:j1] = (1.0 - z) * c + z * hx[:b, j0:j1]
        hx = nxt
        steps.append(hx[:b])
    return torch.stack(steps, dim=1)


@pytest.mark.parametrize("b,h,sms,smem", [(13, 45, 4, None), (3, 70, 6, None),
                                          (9, 37, 5, None), (13, 45, 4, 17_000)])
def test_grid_decomposition_equals_the_plain_recurrence(b, h, sms, smem):
    rng = np.random.default_rng(50 + b)
    args = [torch.from_numpy(a) for a in _gru_inputs(rng, 9, b, h, np.float64)]
    # few SMs cut these small H into several slices, the last one short, and
    # the sums into ragged k-splits; a small shared memory stages h in chunks
    plan = cuda_gru.grid_plan(b, h, sms, smem or H100[1])
    assert plan.cluster > 1 and h % plan.slice and b % 8 and plan.ksplit > 1
    assert (plan.chunk < h) == (smem is not None)
    got = _emulate_grid(plan, *args)
    want = torch_impl.gru_scan(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("b,n,w,sms", [(13, 45, 7, 4), (3, 397, 12, 7)])
def test_grid_decomposition_matches_the_jax_package(b, n, w, sms):
    # ragged grid cases straight against the JAX package's GRU over the
    # nodes (hidden size = N): x [B, W, N] and the gru tree in float32 there,
    # the emulation in float64 on the same values. 45 units on 4 SMs: 12 a
    # block, the last 9, the sums in k-splits; 397 on 7: 57 a block, the last
    # 55, 3 rows padded to 8
    rng = np.random.default_rng(59 + b)
    bound = 1.0 / np.sqrt(n)
    gru = {"w_ih": rng.uniform(-bound, bound, (3 * n, w)),
           "w_hh": rng.uniform(-bound, bound, (3 * n, n)),
           "b_ih": rng.uniform(-bound, bound, 3 * n),
           "b_hh": rng.uniform(-bound, bound, 3 * n)}
    gru = {k: v.astype(np.float32) for k, v in gru.items()}
    x = rng.standard_normal((b, w, n)).astype(np.float32)
    want = jax_stemgnn.gru_over_nodes({k: jnp.asarray(v) for k, v in gru.items()},
                                      jnp.asarray(x))  # [B, N, H]
    g64 = {k: torch.from_numpy(v).double() for k, v in gru.items()}
    x_proj = torch_impl.gru_input_projection(g64, torch.from_numpy(x).double())
    plan = cuda_gru.grid_plan(b, n, sms, H100[1])
    assert plan.cluster == sms and n % plan.slice and b % 8
    got = _emulate_grid(plan, x_proj, g64["w_hh"].T.contiguous(), g64["b_hh"])
    # f32 there, N dependent steps: 1e-5 absolute on values below 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_gru_plain_recurrence_matches_pallas_at_a_ragged_shape():
    rng = np.random.default_rng(46)
    x_proj, a_all, b_hh = _gru_inputs(rng, 9, 6, 37, np.float32)
    with pltpu.force_tpu_interpret_mode():
        # the Pallas entry takes the gates on an axis of their own
        n, b, h = 9, 6, 37
        want = gru_scan_pallas(
            jnp.asarray(x_proj.reshape(n, b, 3, h).transpose(0, 2, 1, 3)),
            jnp.asarray(a_all.reshape(h, 3, h).transpose(1, 0, 2)),
            jnp.asarray(b_hh.reshape(3, 1, h)))  # [N, B, H]
    got = torch_impl.gru_scan(torch.from_numpy(x_proj), torch.from_numpy(a_all),
                              torch.from_numpy(b_hh))  # [B, N, H]
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("n,b,w", [(140, 32, 12), (228, 6, 12), (37, 5, 7)])
def test_graph_plan_tiles_cover_the_output_once(n, b, w):
    k = 4
    plan = cuda_graph.launch_plan(k, n, b, w)
    seen = np.zeros((b, k, n), dtype=np.int64)
    for order, (n0, n1), (b0, b1) in plan.tiles(n, b):
        assert n1 - n0 <= cuda_graph.ROW_TILE and b1 - b0 <= cuda_graph.BATCH_TILE
        seen[b0:b1, order, n0:n1] += 1
    assert (seen == 1).all()
    assert plan.grid == (-(-b // 4), -(-n // 32), k - 1)
    assert plan.smem <= cuda_graph.SMEM_PER_BLOCK
    assert plan.panel % 8 == 0 and plan.panel >= n  # one panel at these sizes
    assert plan.row_stride >= plan.panel and plan.batch_stride >= plan.panel * w + 4
    assert plan.threads == 128 * min(-(-w // 4), cuda_graph.MAX_CHUNKS)
    assert plan.vec == (w % 4 == 0)


def test_graph_plan_walks_a_large_n_in_panels():
    plan = cuda_graph.launch_plan(4, 800, 3, 12)
    assert plan.panel % 8 == 0 and 8 <= plan.panel < 800
    assert plan.smem <= cuda_graph.SMEM_PER_BLOCK
    # one more row of eight would not fit
    assert cuda_graph._smem(plan.panel + 8, 12) > cuda_graph.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="window"):
        cuda_graph.launch_plan(4, 100, 2, 5000)
