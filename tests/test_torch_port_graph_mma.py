"""The bf16 graph conv on the tensor cores (csrc/graph.cu
`cheb_graph_conv_mma_kernel`) on the CPU: its plan (`cuda_graph.mma_plan`,
handed to the C entry as it stands) and a torch emulation of its sum order.

- Every (order, row, batch, column) of the output [B, K, M, W], the zero
  slab of order 0 among them, is stored by exactly one block of the plan.
- The node sum's segments are the plan's MMA_KC-node chunks in rank order,
  none empty, together all of N.
- Shared memory, the cluster size, the tile's columns and the grid stay
  within an H100's limits; at synthetic-1k's shapes the plan gives at least
  as many blocks as the card has SMs; at M = N the row-block call plans as
  the square call does.
- The emulation (each segment an f32 sum of exact bf16 products, the
  segments added in rank order) against `cheb_graph_conv_pallas(...,
  bfloat16)` in interpret mode, as tests/test_torch_port_bf16.py runs it, at
  the ECG shape and at synthetic-1k's (1, 2) block: within 1e-5 of the
  largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.ops.pallas_graph import cheb_graph_conv_pallas
from stemgnn_tpu_torch.ops import cuda_graph

torch.set_num_threads(1)

H100 = (132, 232_448)  # an H100 SXM's SMs and the shared memory a block can opt in to
MAX_GRID_Y = 65_535
# (K, N, B, W, M): the ECG flagship, synthetic-1k's blocks on 'graph' 2 and 4
# and whole, COVID-19, ragged N, B and W, a window past 128 columns, the
# zero order alone, the flagship's node blocks on 'graph' 2 and 4
SHAPES = [(4, 140, 32, 12, 140), (4, 1024, 8, 12, 512), (4, 1024, 8, 12, 256),
          (4, 1024, 8, 12, 1024), (4, 25, 32, 28, 25), (4, 37, 5, 7, 37), (4, 141, 7, 13, 141),
          (4, 100, 3, 300, 100), (3, 70, 2, 130, 70), (1, 140, 6, 12, 140),
          (4, 140, 32, 12, 70), (4, 140, 32, 12, 35)]
S1K = [(4, 1024, 8, 12, 512), (4, 1024, 8, 12, 256), (4, 1024, 8, 12, 1024)]


def _ids(shapes):
    return [f"K{k}-N{n}-B{b}-W{w}-M{m}" for k, n, b, w, m in shapes]


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("k,n,b,w,m", SHAPES, ids=_ids(SHAPES))
def test_mma_plan_stores_every_output_once(k, n, b, w, m):
    plan = cuda_graph.mma_plan(k, n, b, w, H100[0], m=m)
    seen = np.zeros((b, k, m, w), dtype=np.int64)
    for order, (r0, r1), (b0, b1), (w0, w1), rank in plan.tiles(m, b, w):
        assert 0 <= rank < plan.cluster and r1 - r0 <= plan.tm // plan.cluster
        assert b1 - b0 <= plan.tb and w1 - w0 <= plan.tw
        seen[b0:b1, order, r0:r1, w0:w1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k,n,b,w,m", SHAPES, ids=_ids(SHAPES))
def test_mma_plan_segments_cover_n_in_rank_order(k, n, b, w, m):
    plan = cuda_graph.mma_plan(k, n, b, w, H100[0], m=m)
    segs = plan.segments()
    assert len(segs) == plan.cluster and segs[0][0] == 0 and segs[-1][1] == plan.chunks
    assert all(lo < hi for lo, hi in segs)
    assert all(segs[z][1] == segs[z + 1][0] for z in range(len(segs) - 1))
    assert plan.chunks * cuda_graph.MMA_KC >= n > (plan.chunks - 1) * cuda_graph.MMA_KC


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("k,n,b,w,m", SHAPES, ids=_ids(SHAPES))
def test_mma_plan_keeps_the_cards_limits(k, n, b, w, m, sms):
    plan = cuda_graph.mma_plan(k, n, b, w, sms, m=m)
    assert plan.tm in cuda_graph.MMA_ROW_TILES
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= plan.chunks
    assert plan.cluster == 1 or k > 1
    assert plan.tn % 16 == 0 and plan.tb * plan.tw <= plan.tn <= cuda_graph.MMA_MAX_TN
    assert plan.tb == 1 or plan.tw == w  # whole batches, or one batch's w in pieces
    assert plan.tw % 4 == 0 or plan.tw == w
    assert plan.smem == cuda_graph._mma_smem(plan.tm, plan.tn) <= H100[1]
    assert plan.grid[0] % plan.cluster == 0 and plan.grid[1] <= MAX_GRID_Y
    assert plan.grid == (plan.cluster * -(-b // plan.tb) * -(-w // plan.tw), -(-m // plan.tm),
                         max(k - 1, 1))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("k,n,b,w,m", S1K, ids=_ids(S1K))
def test_mma_plan_fills_the_card_at_synthetic_1k(k, n, b, w, m, sms):
    plan = cuda_graph.mma_plan(k, n, b, w, sms, m=m)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= sms


@pytest.mark.parametrize("k,n,b,w,m", SHAPES, ids=_ids(SHAPES))
def test_rows_plan_is_the_square_plan_at_m_eq_n(k, n, b, w, m):
    assert cuda_graph.mma_plan(k, n, b, w, H100[0], m=n) == cuda_graph.mma_plan(
        k, n, b, w, H100[0])


def test_mma_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        cuda_graph.mma_plan(4, 0, 2, 12, H100[0])
    with pytest.raises(ValueError):
        cuda_graph.mma_plan(4, 1 << 23, 1, 12, H100[0])  # more row tiles than a grid's y


def emulate(mul_L, x, plan):
    """The kernel's sum order in torch: L and x rounded to bf16, each
    segment's sum over its nodes an f32 sum of exact products, the segments
    added in rank order, the zero slab of order 0."""
    k, m, n = mul_L.shape
    lb, xb = mul_L.to(torch.bfloat16).float(), x.to(torch.bfloat16).float()
    out = None
    for c0, c1 in plan.segments():
        n0, n1 = c0 * cuda_graph.MMA_KC, min(c1 * cuda_graph.MMA_KC, n)
        part = torch.einsum("kmn,bnw->bkmw", lb[:, :, n0:n1], xb[:, n0:n1])
        out = part if out is None else out + part
    out[:, 0] = 0.0
    return out


@pytest.mark.parametrize("k,n,b,w,m", [(4, 140, 32, 12, 140), (4, 1024, 8, 12, 512)],
                         ids=["ecg", "synthetic-1k-block"])
def test_mma_emulation_matches_pallas(interpret, k, n, b, w, m):
    rng = np.random.default_rng(n + m)
    mul_l = (rng.standard_normal((k, n, n)) / np.sqrt(n)).astype(np.float32)
    mul_l[0] = 0.0
    x = rng.standard_normal((b, n, w)).astype(np.float32)
    want = np.asarray(cheb_graph_conv_pallas(jnp.asarray(mul_l), jnp.asarray(x),
                                             jnp.bfloat16))[:, :, n - m:]
    plan = cuda_graph.mma_plan(k, n, b, w, H100[0], m=m)
    assert plan.cluster > 1 or m == n  # the (1, 2) block splits its sum
    got = emulate(torch.from_numpy(mul_l[:, n - m:]), torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
