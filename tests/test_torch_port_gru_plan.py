"""The launch plans of the port's GRU forward and graph convolution (CPU).

The CUDA kernels take their decomposition from pure-Python functions of the
shape (`cuda_gru.launch_plan`, `cuda_graph.launch_plan`), so what a block owns
is checked here without a card: slices and batch groups cover every hidden
unit and batch row once, shared memory stays within a block's, and a plain
PyTorch emulation of the decomposition equals the plain recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.ops.pallas_gru import gru_scan_pallas
from stemgnn_tpu_torch.ops import cuda_graph, cuda_gru, torch_impl

torch.set_num_threads(1)

HIDDEN = [140, 170, 228, 307, 358, 512]
BATCH = [1, 6, 26, 32, 64]
PORTABLE_FIT = 360  # the largest H whose slices fit a cluster of 8 blocks


def _covers_once(ranges, total):
    seen = np.zeros(total, dtype=np.int64)
    for lo, hi in ranges:
        assert 0 <= lo < hi <= total
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("b", BATCH)
def test_gru_plan_covers_units_and_rows_once(b, h):
    plan = cuda_gru.launch_plan(b, h)
    assert _covers_once(plan.slices(h), h)
    assert _covers_once(plan.batch_groups(b), b)
    assert plan.smem <= cuda_gru.SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= cuda_gru.MAX_CLUSTER
    assert plan.threads % 32 == 0
    if plan.route == "cluster":
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
        # a block per group of 8 batch rows, each thread one unit of the group
        assert h > PORTABLE_FIT
        assert plan.rows == 8 and plan.groups == -(-b // 8)
        assert (plan.cluster, plan.slice) == (1, h)
        assert min(h, 1024) <= plan.threads <= 1024
        assert plan.smem == 4 * 2 * h * (plan.rows + 4) and plan.workspace == 0


def test_gru_plan_fit_rule_and_routes():
    routes = [cuda_gru.launch_plan(32, h).route for h in range(1, 520)]
    assert routes[:PORTABLE_FIT] == ["cluster"] * PORTABLE_FIT
    assert set(routes[PORTABLE_FIT:]) == {"one_block"}
    assert cuda_gru.launch_plan(32, 140)[:7] == ("cluster", 4, 8, 5, 28, 88, 128)
    assert cuda_gru.launch_plan(32, 358).cluster == 8
    # a larger cluster limit takes H = 512 in; at the portable limit every
    # batch the JAX package's Pallas GRU takes (B <= 64, H <= 512) has a plan,
    # the one-block route in groups of 8 rows
    assert cuda_gru.launch_plan(32, 512, max_cluster=16).route == "cluster"
    assert cuda_gru.launch_plan(64, 512)[:4] == ("one_block", 8, 8, 1)
    # past the shared memory of a block (H > 2421 forward, > 1210 backward) the
    # group buffers go to a device workspace: [H][12] floats, 2 (forward) or 4
    # (backward) of them a group of 8 rows
    fwd, bwd = cuda_gru.launch_plan(1, 2500), cuda_gru.bwd_plan(1, 1300)
    assert fwd.route == bwd.route == "one_block"
    assert (fwd.smem, fwd.workspace) == (0, 4 * 2 * 2500 * 12)
    assert (bwd.smem, bwd.workspace) == (0, 4 * 4 * 1300 * 12)
    assert cuda_gru.launch_plan(17, 2500).workspace == 3 * 4 * 2 * 2500 * 12
    assert cuda_gru.launch_plan(1, 2421).workspace == 0
    assert cuda_gru.bwd_plan(1, 1210).workspace == 0
    with pytest.raises(ValueError):
        cuda_gru.launch_plan(0, 140)
    with pytest.raises(ValueError):
        cuda_gru.one_block_plan(1, 0)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_gru_one_block_plan_workspace_route_on_request(backward):
    """The workspace route can be asked for at a hidden size whose buffers fit
    shared memory (chip_smoke.py holds it bitwise against the shared-memory
    route there): the same launch, its buffers moved to the workspace."""
    shared = cuda_gru.one_block_plan(32, 512, backward=backward)
    ws = cuda_gru.one_block_plan(32, 512, backward=backward, in_workspace=True)
    assert shared.workspace == 0 and shared.smem == 4 * (4 if backward else 2) * 512 * 12
    assert ws.smem == 0 and ws.workspace == shared.groups * shared.smem
    assert ws._replace(smem=shared.smem, workspace=0) == shared
    big = cuda_gru.one_block_plan(8, 2500, backward=backward, in_workspace=False)
    assert big.workspace == 0 and big.smem > cuda_gru.SMEM_PER_BLOCK


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
