"""Sharded training step: data parallelism over 'data' x the node-block
partition over 'graph' (stemgnn_tpu/parallel/train.py). No reference
counterpart (SURVEY.md section 2e).

The steps are the engine's (`train/engine.py` `make_train_step`,
`make_eval_step`) on a mesh: every rank runs the same program on the same
host data, takes its rows of the batch and, where 'graph' divides N, its
block of the nodes (the stretch path's sparse graph, `parallel/sparse_shard.py`;
the dense path's attention and Chebyshev rows, `parallel/dense_shard.py`, with
`use_ring` too, `parallel/ring.py`); the collectives are
stated in `parallel/mesh.py`.
"""

from __future__ import annotations

from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.train import engine


def make_sharded_train_step(mcfg: StemGNNConfig, opt, leaves, mesh,
                            compute_dtype: str = "float32", shard_batch: bool = True,
                            use_ring: bool = False):
    """train_step(params, data, hi, dropout_generator=None, dropout_mask=None)
    -> the batch's loss, on every rank. The batch `hi` [B] is sharded over
    'data' (with `shard_batch`; B must divide), the dropout mask ([B, N, N],
    or [N, k] on the stretch path) is the whole batch's and each rank takes
    its part, the parameters and the optimizer's state stay replicated, and
    the gradients are summed over the mesh in a fixed order before `opt`
    steps (`engine.make_train_step`)."""
    return engine.make_train_step(mcfg, opt, leaves, compute_dtype=compute_dtype,
                                  mesh=mesh, shard_batch=shard_batch, use_ring=use_ring)


def make_sharded_eval_step(mcfg: StemGNNConfig, mesh, device="cuda",
                           compute_dtype: str = "float32", use_ring: bool = False):
    """eval_step(params, x) -> the whole forecast [B, horizon, N] on every
    rank: the batch x replicated, the nodes sharded over 'graph' where it
    divides N and the forecast gathered (`engine.make_eval_step`)."""
    return engine.make_eval_step(mcfg, device, compute_dtype, mesh=mesh, use_ring=use_ring)
