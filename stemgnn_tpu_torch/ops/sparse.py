"""Sparse top-k latent graph of the large-N stretch path, in PyTorch
(stemgnn_tpu/ops/sparse.py).

The reference's latent graph is a dense row-softmax [N, N] attention and its
Chebyshev stack materializes L^2 and L^3 (base_model.py:121-162): O(N^2)
memory, O(N^3) work. At the stretch configuration's 102,400 nodes one such
[N, N] f32 array is 42 GB. The stretch path keeps O(N * k):

1. **Rank-1 top-k.** score[i, j] = LeakyReLU(key_i + query_j) is additive
   and LeakyReLU is monotone, so every row's top-k columns are the top-k
   entries of `query`: one `torch.topk` of an [N] vector. The adjacency is a
   column block C = softmax_rows(scores[:, idx]) [N, k] on one shared index
   set idx [k].
2. **Feature-space Chebyshev.** t1 = L x, t2 = 2 L t1, t3 = 2 L t2 - t1, the
   dense stack's recursion (T0 = 0) applied to the features, with L never
   materialized.
3. **Batch-meaned scores.** key and query are meaned over the batch before
   the softmax (exact at B = 1; PARITY.md).

Kept from the reference: the softmax over the selected columns, the degree
from the asymmetric matrix before symmetrization, A <- (A + A^T) / 2,
L = D^(-1/2) (D - A) D^(-1/2) with D^(-1/2) = 1 / (sqrt(deg) + 1e-7).

Every gather and scatter is an `index_select` or an `index_copy` on the k
distinct indices, whose backward adds into distinct rows: a step rerun on
the card gives the same bits, and nothing here waits on the host, so the
step captures into a CUDA graph. Dropout on the sparse path is a [N, k] mask
on C (`dropout_mask`, True keeps), where the JAX package draws
Bernoulli(keep) over C's shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class SparseLatentGraph(NamedTuple):
    """Column-block sparse latent graph: the asymmetric attention is A with
    A[:, idx] = c and zeros elsewhere."""

    idx: torch.Tensor  # [k] int64 column indices (top-k of query, largest first)
    c: torch.Tensor  # [N, k] row-softmaxed scores over the selected columns
    degree: torch.Tensor  # [N] row sums of the asymmetric A (pre-symmetrization)
    inv_sqrt: torch.Tensor  # [N] 1 / (sqrt(degree) + 1e-7)


def topk_latent_graph(key_vec, query_vec, alpha: float, k: int, *,
                      dropout_mask=None, dropout_rate: float = 0.0) -> SparseLatentGraph:
    """The sparse latent graph from batch-meaned rank-1 projections.

    key_vec, query_vec: [N]. With `dropout_mask` ([N, k] bool, True keeps) and
    `dropout_rate` > 0, C is dropped out as the JAX package drops it:
    where(mask, C / keep, 0), before the degree."""
    n = key_vec.shape[0]
    if k > n:
        raise ValueError(f"k={k} > N={n}")
    _, idx = torch.topk(query_vec, k)  # [k], largest first
    scores = key_vec[:, None] + query_vec.index_select(0, idx)[None, :]  # [N, k]
    scores = F.leaky_relu(scores, negative_slope=alpha)
    c = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_mask is not None:
        keep = 1.0 - dropout_rate
        c = torch.where(dropout_mask, c / keep, torch.zeros_like(c))
    degree = c.sum(dim=1)
    inv_sqrt = 1.0 / (torch.sqrt(degree) + 1e-7)
    return SparseLatentGraph(idx=idx, c=c, degree=degree, inv_sqrt=inv_sqrt)


def _apply_sym_adjacency(g: SparseLatentGraph, x):
    """y = A_sym @ x, A_sym = (A + A^T) / 2, for x [..., N, W]:
    (A x) = C @ x[idx] and (A^T x)[idx] = C^T @ x, zero off idx."""
    ax = torch.matmul(g.c, x.index_select(-2, g.idx))
    ctx = torch.matmul(g.c.T, x)  # [..., k, W]
    atx = torch.zeros_like(x).index_copy(x.dim() - 2, g.idx, ctx)
    return 0.5 * (ax + atx)


def laplacian_apply(g: SparseLatentGraph, x):
    """y = L @ x with L = D^(-1/2) (D - A_sym) D^(-1/2) (base_model.py:144-147):
    inv_sqrt * (degree * (inv_sqrt * x) - A_sym (inv_sqrt * x)). x [..., N, W]."""
    s = g.inv_sqrt[:, None]
    xs = s * x
    return s * (g.degree[:, None] * xs - _apply_sym_adjacency(g, xs))


def sparse_cheb_conv(g: SparseLatentGraph, x):
    """Feature-space Chebyshev conv, [B, N, W] -> [B, 4, N, W]: t0 = 0,
    t1 = L x, t2 = 2 L t1 - t0, t3 = 2 L t2 - t1 (the dense stack's T0 = 0,
    T1 = L, T2 = 2L^2, T3 = 4L^3 - L applied to x)."""
    t0 = torch.zeros_like(x)
    t1 = laplacian_apply(g, x)
    t2 = 2.0 * laplacian_apply(g, t1) - t0
    t3 = 2.0 * laplacian_apply(g, t2) - t1
    return torch.stack([t0, t1, t2, t3], dim=1)


def dense_attention_equivalent(g: SparseLatentGraph, n: int):
    """The symmetrized [N, N] attention (tests and small N only)."""
    a = torch.zeros((n, n), dtype=g.c.dtype, device=g.c.device).index_copy(1, g.idx, g.c)
    return 0.5 * (a + a.T)
