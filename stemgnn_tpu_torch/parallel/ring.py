"""The latent attention behind `--use_ring` (stemgnn_tpu/parallel/ring.py).

The JAX package's ring gives each of the P ranks of a 'graph' group its row
block [B, N / P, N] of the row-softmaxed attention while the query blocks
travel round the ring, so that no device holds the whole query. In this port
every rank runs the whole GRU (the JAX package does not shard the dense GRU
either) and so already holds every node's query [B, N], which is linear in
N: a ring would only bring each rank values it has. `--use_ring` therefore
takes the dense partition's route, the row-block arm of the attention
kernel (`ops.attention_rows`), whose rows are the ring's. What the flag
keeps of the ring is its refusal of an N that 'graph' does not divide
(stemgnn_tpu/parallel/ring.py:95-97).
"""

from __future__ import annotations

from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.parallel.mesh import Mesh


def check_divisible(n: int, mesh: Mesh) -> None:
    """The ring needs whole node blocks: raise where 'graph' does not divide N
    (stemgnn_tpu/parallel/ring.py:95-97)."""
    if n % mesh.graph:
        raise ValueError(f"N={n} not divisible by graph axis {mesh.graph}")


def ring_attention(mesh: Mesh, enc, weight_key, weight_query, alpha: float):
    """Sharded twin of `ops.torch_impl.attention_adjacency`: enc [B, N, N] (the
    GRU encoding, transposed as the reference's permute(0, 2, 1)) -> this
    rank's row block [B, N / graph, N], columns in global node order. N must
    be divisible by the 'graph' axis."""
    key = (enc @ weight_key)[..., 0]  # [B, N]
    query = (enc @ weight_query)[..., 0]
    check_divisible(key.shape[1], mesh)
    blk = mesh.node_block(key.shape[1])
    return ops.attention_rows(key[:, blk].contiguous(), query.contiguous(), alpha)
