"""Node-sharded sparse latent graph over the 'graph' mesh axis, in PyTorch
(stemgnn_tpu/parallel/sparse_shard.py).

The stretch path's top-k sparse latent graph (`ops/sparse.py`: O(N·k) storage,
feature-space Chebyshev) with the node axis partitioned into blocks over the
'graph' axis. Each rank holds only its row block of the column-block matrix C
[Nl, k]; nothing [N, N]- or even [N, k]-shaped is held by one rank, so
per-rank state is O(Nl·k + k·W).

Collective structure (all over the 'graph' group):
- graph build: distributed top-k — a local `torch.topk` of the [Nl] query
  block, an all-gather of the P·min(k, Nl) (value, index) candidates, a global
  top-k of the candidates. Any global top-k element is necessarily in its own
  shard's local top-k, so this is exact, not approximate.
- A·x: every row of A only reads the k selected columns, so one all-reduce
  assembles x[idx] ([k, W], the only globally shared activation) and the
  product is a local [Nl, k] x [k, W] matmul.
- Aᵀ·x: a local Cᵀ·x_blk partial ([k, W]) and an all-reduce, copied into the
  rows of idx that lie in this rank's block.

The collectives' backwards are those of `parallel/mesh.py`. Every gather and
scatter is an `index_select` or an `index_copy` on the k distinct indices, as
in `ops/sparse.py`: a rerun gives the same bits, and nothing waits on the
host, so the step captures into a CUDA graph. On a graph axis of 1 every
value is the single-device build's.

Semantics are identical to ops/sparse.py (same reference quirks: row softmax
over selected columns, pre-symmetrization degree base_model.py:141,
A ← ½(A+Aᵀ) :143, D̂ = diag(1/(√deg+1e-7)) :145, T0 = 0 zeroing the k=0
Chebyshev branch :129).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stemgnn_tpu_torch.ops.sparse import SparseLatentGraph
from stemgnn_tpu_torch.parallel.mesh import Mesh, all_gather, all_gather_cat, all_reduce_sum


def _local_block_meta(idx, nl: int, mesh: Mesh):
    """Positions of the global column set `idx` inside this rank's row block:
    (safe local positions [k], membership mask [k])."""
    pos = idx - mesh.graph_index * nl
    mask = (pos >= 0) & (pos < nl)
    return pos.clamp(0, nl - 1), mask


def _build_graph_local(key_blk, query_blk, alpha: float, k: int, mesh: Mesh,
                       dropout_mask=None, dropout_rate: float = 0.0) -> SparseLatentGraph:
    """Per-rank graph build. key_blk/query_blk: [Nl]. Returns a
    SparseLatentGraph whose c/degree/inv_sqrt hold only the local row block
    (idx is replicated — identical on every rank)."""
    nl = query_blk.shape[0]
    # exact distributed top-k over the global query vector
    vals, locs = torch.topk(query_blk, min(k, nl))
    cand_vals = all_gather(vals, mesh.graph_group)  # [P*min(k,Nl)]
    cand_idx = all_gather_cat(locs + mesh.graph_index * nl, mesh.graph_group)
    top_vals, sel = torch.topk(cand_vals, k)
    idx = cand_idx.index_select(0, sel)  # [k], same on every rank
    # local row block of the rectangular score matrix (ops/sparse.py)
    scores = key_blk[:, None] + top_vals[None, :]  # query[idx] == top_vals
    scores = F.leaky_relu(scores, negative_slope=alpha)
    c = torch.softmax(scores, dim=-1)  # [Nl, k]
    if dropout_rate > 0.0 and dropout_mask is not None:
        # the same dropout as the single-device build: `dropout_mask` is the
        # step's global [N, k] mask, which every rank holds (drawn from one
        # generator state), and each rank takes its row block, so the sharded
        # and the single-device steps drop the same entries
        keep = 1.0 - dropout_rate
        mask = dropout_mask[mesh.graph_index * nl: (mesh.graph_index + 1) * nl]
        c = torch.where(mask, c / keep, torch.zeros_like(c))
    degree = c.sum(dim=1)  # pre-symmetrization (base_model.py:141)
    inv_sqrt = 1.0 / (torch.sqrt(degree) + 1e-7)
    return SparseLatentGraph(idx=idx, c=c, degree=degree, inv_sqrt=inv_sqrt)


def _gather_selected_rows(y_blk, idx, mesh: Mesh):
    """y[idx] for node-sharded y: [..., Nl, W] -> [..., k, W] (one all-reduce)."""
    nl = y_blk.shape[-2]
    pos, mask = _local_block_meta(idx, nl, mesh)
    rows = y_blk.index_select(-2, pos)
    contrib = torch.where(mask[:, None], rows, torch.zeros_like(rows))
    return all_reduce_sum(contrib, mesh.graph_group)


def _apply_sym_adjacency_local(g: SparseLatentGraph, x_blk, mesh: Mesh):
    """Local row block of ½(A + Aᵀ)·x (sharded twin of ops/sparse.py
    `_apply_sym_adjacency`)."""
    nl = x_blk.shape[-2]
    x_sel = _gather_selected_rows(x_blk, g.idx, mesh)  # [..., k, W]
    ax = torch.matmul(g.c, x_sel)  # [..., Nl, W]
    # [..., k, W] = Aᵀx restricted to rows idx (all other rows are 0)
    ct = all_reduce_sum(torch.matmul(g.c.T, x_blk), mesh.graph_group)
    # copied into the rows of idx in this block; the others go to a spare
    # row Nl that is cut off
    pos, mask = _local_block_meta(g.idx, nl, mesh)
    dim = x_blk.dim() - 2
    shape = list(x_blk.shape)
    shape[dim] = nl + 1
    atx = x_blk.new_zeros(shape).index_copy(dim, torch.where(mask, pos, nl), ct)
    return 0.5 * (ax + atx.narrow(dim, 0, nl))


def _laplacian_apply_local(g: SparseLatentGraph, x_blk, mesh: Mesh):
    """Local row block of L·x, L = D̂(D − A_sym)D̂ (base_model.py:144-147)."""
    s = g.inv_sqrt[:, None]
    xs = s * x_blk
    return s * (g.degree[:, None] * xs - _apply_sym_adjacency_local(g, xs, mesh))


def _cheb_conv_local(g: SparseLatentGraph, x_blk, mesh: Mesh):
    """[., Nl, W] -> [., 4, Nl, W]: T0=0, t1=Lx, t2=2L t1, t3=2L t2 − t1
    (the reference's nonstandard recursion, base_model.py:129-133)."""
    t0 = torch.zeros_like(x_blk)
    t1 = _laplacian_apply_local(g, x_blk, mesh)
    t2 = 2.0 * _laplacian_apply_local(g, t1, mesh) - t0
    t3 = 2.0 * _laplacian_apply_local(g, t2, mesh) - t1
    return torch.stack([t0, t1, t2, t3], dim=1)


# ---------------------------------------------------------------------------
# mesh-level entry points
# ---------------------------------------------------------------------------


def build_sharded_graph(mesh: Mesh, key_blk, query_blk, alpha: float, k: int, *,
                        dropout_mask=None, dropout_rate: float = 0.0) -> SparseLatentGraph:
    """Distributed twin of ops.sparse.topk_latent_graph.

    key_blk/query_blk: this rank's [Nl] blocks of the batch-meaned rank-1
    projections [N], N = Nl · graph. `dropout_mask`: the step's global [N, k]
    mask (True keeps). Returns a SparseLatentGraph whose c [Nl, k] / degree
    [Nl] / inv_sqrt [Nl] are this rank's rows and idx [k] is replicated.
    """
    n = query_blk.shape[0] * mesh.graph
    if k > n:
        raise ValueError(f"k={k} > N={n}")
    return _build_graph_local(key_blk, query_blk, alpha, k, mesh,
                              dropout_mask=dropout_mask, dropout_rate=dropout_rate)


def sharded_sparse_cheb_conv(mesh: Mesh, g: SparseLatentGraph, x_blk):
    """Distributed twin of ops.sparse.sparse_cheb_conv.

    x_blk: [B, Nl, W], this rank's node block. Returns [B, 4, Nl, W].
    """
    return _cheb_conv_local(g, x_blk, mesh)
