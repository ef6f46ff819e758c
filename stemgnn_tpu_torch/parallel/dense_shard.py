"""The dense latent graph partitioned by node rows over the 'graph' mesh axis
(the JAX package's GSPMD layout of the dense path, stemgnn_tpu/models/
stemgnn.py:343-367 and :407-411, stated here as explicit collectives).

Each of the P ranks of a 'graph' group holds a block of Nl = N / P nodes.
The GRU is not sharded (nor is it in the JAX package): every rank runs it
whole, and takes the key of its own nodes [B, Nl] and every node's query
[B, N]. From there each rank holds only rows of the quadratic terms:

- the attention's rows [B, Nl, N] (the row-block arm of the attention kernel,
  `ops.attention_rows`, with `use_ring` too), dropped out by its
  rows of the step's [B, N, N] mask (bitwise the unsharded step's entries),
  meaned over the batch (summed over 'data' where the batch is sharded);
- the degree, from its rows' sums before symmetrisation (the reference's
  quirk, base_model.py:141), and every node's 1 / (sqrt(degree) + 1e-7) by an
  all-gather of the blocks;
- its rows of the symmetrised attention, (A + A^T) / 2: A^T's rows of this
  block are the transposes of the other ranks' [Nl, Nl] blocks of its
  columns, which one all-to-all brings;
- its rows of the Laplacian L and of the Chebyshev stack (T0 = 0, T1 = L,
  T2 = 2 L L, T3 = 2 L T2 - L): T2's and T3's rows need the whole L and T2,
  each assembled by an all-gather of the ranks' row blocks ([N, N] on every
  rank for the two products, O(N^2 / P) of work each);
- its rows of the graph conv, mul_L [4, Nl, N] against every node's x (the
  row-block arm of the graph-conv kernel, `ops.cheb_graph_conv_rows`, after
  an all-gather of x's node blocks), whose output [B, 4, Nl, W] the spectral
  cell and the heads take on the rank's node block.

The collectives' backwards are those of `parallel/mesh.py`: each rank's
backward starts from its own share of the loss, and the replicated GRU's
gradients are summed over the group with every other leaf's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.parallel.mesh import Mesh, all_gather, all_to_all_blocks, batch_mean


def _transpose_rows(att, mesh: Mesh):
    """Rows of A^T for this rank's node block from the ranks' rows of A: att
    [Nl, N] (rows of A) -> [Nl, N] (the same rows of A^T). Rank s sends its
    block of our columns, A[blk_s, blk], and we lay each one's transpose at
    the columns of block s."""
    nl, n = att.shape
    cols = att.reshape(nl, mesh.graph, nl).transpose(0, 1)  # block s: A[blk, blk_s]
    got = all_to_all_blocks(cols, mesh.graph_group)  # block s: A[blk_s, blk]
    return got.permute(2, 0, 1).reshape(nl, n)


def laplacian_rows(mesh: Mesh, att, batch_sharded: bool = False):
    """The rank's rows of `ops.laplacian_from_attention`: att [B, Nl, N] (its
    rows of the step's attention, after dropout; with `batch_sharded` its
    rows of the batch too) -> (mul_L [4, Nl, N], the symmetrised attention's
    rows [Nl, N])."""
    blk = mesh.node_block(att.shape[-1])
    att = batch_mean(att, mesh, batch_sharded)  # [Nl, N]
    degree = att.sum(dim=1)  # before symmetrisation (base_model.py:141)
    sym = 0.5 * (att + _transpose_rows(att, mesh))
    inv_sqrt = 1.0 / (torch.sqrt(degree) + 1e-7)
    inv_all = all_gather(inv_sqrt, mesh.graph_group)  # [N]
    n = att.shape[1]
    diag = F.pad(torch.diag(degree), (blk.start, n - blk.stop))  # rows of diag(degree)
    lap = inv_sqrt[:, None] * (diag - sym) * inv_all[None, :]
    t2 = 2.0 * (lap @ all_gather(lap, mesh.graph_group))
    t3 = 2.0 * (lap @ all_gather(t2, mesh.graph_group)) - lap
    return torch.stack([torch.zeros_like(lap), lap, t2, t3], dim=0), sym


def cheb_conv_rows(mesh: Mesh, mul_L, x_blk, compute_dtype: str = "float32"):
    """The rank's rows of the Chebyshev graph conv: mul_L [4, Nl, N], x_blk
    [B, Nl, W] (this rank's node block) -> [B, 4, Nl, W], on the row-block
    arm of the graph-conv kernel against every node's x (an all-gather)."""
    x_all = all_gather(x_blk.contiguous(), mesh.graph_group, dim=1)  # [B, N, W]
    return ops.cheb_graph_conv_rows(mul_L.contiguous(), x_all, compute_dtype=compute_dtype)
