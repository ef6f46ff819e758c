"""The StemGNN model in PyTorch: the dense path and the single-device stretch
path.

Architecture (reference base_model.py; stemgnn_tpu/models/stemgnn.py):

  x [B, W, N]
    └─ latent correlation layer (base_model.py:136-149)
         GRU over the NODE axis -> rank-1 additive attention [B,N,N] ->
         batch mean -> degree (pre-symmetrization) -> symmetrize ->
         normalized Laplacian -> Chebyshev basis with T0=0 -> mul_L [4,N,N]
    └─ 2 residual stacks (base_model.py:171-173)
         block: cheb graph conv -> FFT/GLU/iFFT spe-seq cell -> per-order
         contraction -> forecast head; stack 0 also emits
         sigmoid(backcast(igfted) - shortcut(x)) as stack 1's input
    └─ head: Linear(W,W) -> LeakyReLU(0.01) -> Linear(W,horizon)
  returns (forecast [B, horizon, N], attention [N, N] symmetrized)

The four hot ops go through `stemgnn_tpu_torch.ops`, whose wrappers launch
the CUDA kernels on CUDA tensors and run the plain twins on CPU tensors;
under autograd their backward kernels run the same way. `compute_dtype`
("float32" or "bfloat16", the JAX package's `precision`) goes to the graph
conv and the spectral cell, the two ops whose kernels have a bf16 arm;
everything else stays f32.
Parameters are a nested dict of tensors in the JAX package's layout, f32 or
(param_dtype "bfloat16") bf16: the forward promotes a bf16 leaf to f32 where
it starts (`promoted`), exactly, as JAX promotes a bf16 parameter where it
meets an f32 activation; autograd hands such a leaf a bf16 gradient.
The stretch path (cfg.sparse_k, and with it cfg.gru_hidden and
cfg.gru_segment; stemgnn_tpu/models/stemgnn.py:207-342) replaces the [B,N,N]
attention and the [4,N,N] Laplacian stack with a top-k sparse latent graph
(`ops/sparse.py`): key and query are meaned over the batch, the graph is an
[N, k] block C on k shared columns, its dropout an [N, k] mask on C, and each
block's graph conv the feature-space Chebyshev recursion. With gru_hidden the
GRU's hidden size is H, not N, and its node sequence runs as independent
segments (`ops.gru_over_nodes_segmented`), and node i's scores come from its
own encoding row (no hidden == N transpose). `forward` then returns the
graph (a `SparseLatentGraph`) where the dense path returns the attention.
The spectral cell, the contraction and the heads are the dense path's.

With a `mesh` (`parallel/mesh.py`) the forward runs one rank's share of a
sharded step (stemgnn_tpu/models/stemgnn.py `_sparse_graph_dispatch`, :250):
x holds this rank's batch rows over every node; with `batch_sharded` the
batch means (the dense attention's, the stretch path's key and query) are
summed over 'data'. Where 'graph' divides N and is > 1 (on the stretch path
also with `force_sparse_shard`: `node_sharded`) the rank builds its row
block of the graph and runs the graph conv, the spectral cell and the heads
on its node block: the forecast is [B, horizon, N / graph]. The stretch path
builds its rows of the sparse graph (`parallel/sparse_shard.py`); the dense
path its rows of the attention, on the row-block arm of the attention
kernel (with `use_ring` too: `parallel/ring.py`), and of the Laplacian and
the Chebyshev stack (`parallel/dense_shard.py`). Where 'graph' does not
divide N, every rank runs the whole model on its batch rows, the numbers of
one device, as the JAX package's single-array build gives them
(stemgnn_tpu/models/stemgnn.py:266-271); `use_ring` then raises, as the JAX
package's ring does. Without a mesh no collective and no extra op runs.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
from stemgnn_tpu_torch.models.initializers import init_params
from stemgnn_tpu_torch.ops.sparse import (
    SparseLatentGraph,
    sparse_cheb_conv,
    topk_latent_graph,
)
from stemgnn_tpu_torch.ops.torch_impl import gru_over_nodes  # noqa: F401 (plain GRU)
from stemgnn_tpu_torch.parallel import dense_shard
from stemgnn_tpu_torch.parallel.mesh import batch_mean as _batch_mean
from stemgnn_tpu_torch.parallel.ring import check_divisible
from stemgnn_tpu_torch.parallel.sparse_shard import (
    build_sharded_graph,
    sharded_sparse_cheb_conv,
)


# The leaves that go into a kernel's autograd.Function as they are: the
# spectral cell's 24 GLU tensors of each block and the GRU recurrence's w_hh and
# b_hh. The JAX package's custom_vjp of those kernels (pallas_spectral.py
# `_backward` and `_backward_reread`, pallas_gru.py `_vjp_bwd`) return their
# gradients as f32 whatever the parameter's dtype, where every other leaf's
# gradient comes back through a promotion, in the leaf's dtype. A train step
# over bf16 parameters differentiates f32 copies of these (train/engine.py).
KERNEL_GRAD_LEAVES = re.compile(r"blocks/\d+/glu/\d+/(left|right)/[wb]|gru/[wb]_hh")


def kernel_grad_leaf(name: str, cfg: StemGNNConfig | None = None) -> bool:
    """True for a "/"-joined leaf name in KERNEL_GRAD_LEAVES. With a `cfg`
    whose GRU is the stretch path's segmented one, not for the GRU's leaves:
    the JAX package runs that recurrence as a `lax.scan`, not its kernel, so
    their gradients come back in the leaf's dtype."""
    if cfg is not None and cfg.gru_hidden is not None and name.startswith("gru/"):
        return False
    return KERNEL_GRAD_LEAVES.fullmatch(name) is not None


def promoted(params):
    """The tree with every bf16 leaf promoted to f32 (a differentiable cast:
    its gradient comes back in bf16); other leaves as they are."""
    if isinstance(params, dict):
        return {k: promoted(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [promoted(v) for v in params]
    return params.to(torch.float32) if params.dtype == torch.bfloat16 else params


def draw_dropout_mask(shape, keep: float, generator: torch.Generator):
    """Bernoulli(keep) mask drawn from `generator` on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device) < keep


def dropout_shape(cfg: StemGNNConfig, batch: int) -> tuple:
    """The shape of a training step's dropout mask: [B, N, N] on the dense
    attention, [N, k] on the stretch path's C (stemgnn_tpu/ops/sparse.py:75-78)."""
    if cfg.sparse_k is not None:
        return (cfg.units, cfg.sparse_k)
    return (batch, cfg.units, cfg.units)


def mask_rows(cfg: StemGNNConfig, mask, mesh, batch_sharded: bool):
    """The rank's part of the whole dense dropout masks `mask` [..., B, N, N]
    (one step's, or a chunk's [n, B, N, N]): its batch rows with
    `batch_sharded`, and where the forward is `node_sharded` its node
    block's rows. Without a mesh, and on the stretch path (whose [N, k] mask
    `parallel/sparse_shard.py` cuts itself), the mask as it is."""
    if mesh is None or cfg.sparse_k is not None:
        return mask
    if batch_sharded:
        mask = mask[..., mesh.batch_rows(mask.shape[-3]), :, :]
    if node_sharded(cfg, mesh):
        mask = mask[..., mesh.node_block(cfg.units), :]
    return mask


def _step_mask(cfg: StemGNNConfig, shape, training: bool, dropout_generator,
               dropout_mask):
    """The step's dropout mask: `dropout_mask` if given, else drawn from
    `dropout_generator`; None outside training or without dropout."""
    if not training or cfg.dropout_rate <= 0.0:
        return None
    if dropout_mask is None:
        if dropout_generator is None:
            raise ValueError("training with dropout needs dropout_generator "
                             "or dropout_mask")
        dropout_mask = draw_dropout_mask(shape, 1.0 - cfg.dropout_rate, dropout_generator)
    return dropout_mask


def node_sharded(cfg: StemGNNConfig, mesh) -> bool:
    """True where the forward runs on this rank's node block: a mesh whose
    'graph' axis is > 1 and divides N, or on the stretch path any mesh with
    cfg.force_sparse_shard whose 'graph' axis divides N
    (stemgnn_tpu/models/stemgnn.py `_sparse_graph_dispatch`). Where 'graph'
    does not divide N, False: every rank runs the whole model."""
    if mesh is None or cfg.units % mesh.graph:
        return False
    if cfg.sparse_k is None:
        return mesh.graph > 1
    return mesh.graph > 1 or cfg.force_sparse_shard


def _sparse_graph_dispatch(key, query, cfg: StemGNNConfig, training: bool,
                           dropout_generator, dropout_mask, mesh,
                           batch_sharded: bool) -> SparseLatentGraph:
    """The top-k latent graph (stemgnn_tpu/models/stemgnn.py:250-283):
    node-sharded where `node_sharded` (parallel/sparse_shard.py: exact, any
    global top-k element is in its own block's local top-k; each rank takes
    its rows of the step's [N, k] mask), else on one device (ops/sparse.py).
    key, query: [N] (the rank's [Nl] block where sharded) on the segmented
    path, [B, N] otherwise (meaned here: the stretch path's batch-meaned
    scores, exact at B = 1)."""
    if key.dim() == 2:
        key = _batch_mean(key, mesh, batch_sharded)
        query = _batch_mean(query, mesh, batch_sharded)
    mask = _step_mask(cfg, dropout_shape(cfg, batch=1), training, dropout_generator,
                      dropout_mask)
    if node_sharded(cfg, mesh):
        return build_sharded_graph(mesh, key, query, cfg.leaky_rate, cfg.sparse_k,
                                   dropout_mask=mask, dropout_rate=cfg.dropout_rate)
    return topk_latent_graph(key, query, cfg.leaky_rate, cfg.sparse_k, dropout_mask=mask,
                             dropout_rate=cfg.dropout_rate)


def latent_correlation_layer(params, cfg: StemGNNConfig, x, *, training: bool = False,
                             dropout_generator=None, dropout_mask=None, mesh=None,
                             batch_sharded: bool = False, use_ring: bool = False):
    """base_model.py:136-149. Returns (mul_L [4,N,N], attention [N,N]), or on
    the stretch path (graph, graph) with graph a `SparseLatentGraph`; on the
    dense path node-sharded, the rank's rows of both (mul_L [4,Nl,N],
    attention [Nl,N]). `use_ring` (a dense model on 'graph' > 1) takes the
    same rows and raises where 'graph' does not divide N (`parallel/ring.py`).

    In training the attention [B,N,N] (the stretch path: C [N,k]) is dropped
    out (base_model.py:161): `dropout_mask` (bool, True keeps, of
    `dropout_shape`) if given, else a mask drawn from `dropout_generator`.
    Under a `mesh` (`forward`) the mask is the whole step's: [B,N,N] over the
    global batch, of which the rank takes its rows (`mask_rows`), or [N,k], of
    which a node-sharded rank takes its block. A dense mask that already has
    the shape of the rank's attention is taken as the rank's rows (the
    engine's chunk keeps only those)."""
    batch_sharded = batch_sharded and mesh is not None and mesh.data > 1
    sharded = node_sharded(cfg, mesh)
    blk = mesh.node_block(cfg.units) if sharded else None
    if cfg.gru_hidden is not None:
        # the stretch GRU: enc [B, N, H]; node i's rank-1 scores come from its
        # own encoding row, meaned over the batch
        if not sharded:
            enc = ops.gru_over_nodes_segmented(params["gru"], x, cfg.gru_segment)
        elif (blk.stop - blk.start) % (cfg.gru_segment or cfg.units) == 0:
            # the node block is whole segments: the recurrence is block-local
            enc = ops.gru_over_nodes_segmented(params["gru"], x[:, :, blk], cfg.gru_segment)
        else:
            # x holds every node (the series is replicated): the rank runs
            # every segment and keeps its block
            enc = ops.gru_over_nodes_segmented(params["gru"], x, cfg.gru_segment)[:, blk]
        key = _batch_mean(enc @ params["weight_key"], mesh, batch_sharded)[:, 0]  # [N]
        query = _batch_mean(enc @ params["weight_query"], mesh, batch_sharded)[:, 0]
    else:
        enc = ops.gru_over_nodes(params["gru"], x)  # [B, N_seq, N_hid]
        # the reference's input.permute(0,2,1), legal only because hidden == N
        enc = enc.transpose(1, 2)  # [B, N_hid, N_seq]
        if sharded:  # the rank's hidden units, which are its nodes' scores
            key = (enc[:, blk] @ params["weight_key"])[..., 0].contiguous()  # [B, Nl]
            # the stretch path's scores are its nodes' own; the dense
            # attention's rows need every node's query
            query = (enc[:, blk] if cfg.sparse_k is not None else enc) @ params["weight_query"]
            query = query[..., 0].contiguous()
        else:
            key = (enc @ params["weight_key"])[..., 0].contiguous()  # [B, N]
            query = (enc @ params["weight_query"])[..., 0].contiguous()
    if cfg.sparse_k is not None:
        g = _sparse_graph_dispatch(key, query, cfg, training, dropout_generator,
                                   dropout_mask, mesh, batch_sharded)
        return g, g
    if use_ring and mesh is not None and mesh.graph > 1:
        check_divisible(cfg.units, mesh)  # the ring takes whole node blocks
    if sharded:
        att = ops.attention_rows(key, query, cfg.leaky_rate)  # [B, Nl, N]
    else:
        att = ops.attention_kq(key, query, cfg.leaky_rate)  # [B, N, N]
    batch = att.shape[0] * (mesh.data if batch_sharded else 1)
    mask = _step_mask(cfg, (batch, cfg.units, cfg.units), training, dropout_generator,
                      dropout_mask)
    if mask is not None:
        if mask.shape != att.shape:  # the whole step's mask: the rank's rows of it
            mask = mask_rows(cfg, mask, mesh, batch_sharded)
        keep = 1.0 - cfg.dropout_rate
        att = torch.where(mask, att / keep, torch.zeros_like(att))
    if sharded:
        return dense_shard.laplacian_rows(mesh, att, batch_sharded)
    if batch_sharded:
        att = _batch_mean(att, mesh, batch_sharded)[None]  # [1, N, N]
    return ops.laplacian_from_attention(att)


def block_forward(block, cfg: StemGNNConfig, x, mul_L, stack_i: int,
                  compute_dtype: str = "float32", mesh=None):
    """One StockBlockLayer (base_model.py:61-75).

    x: [B, N, W]; mul_L [4, N, N], or on the stretch path the
    `SparseLatentGraph`, whose graph conv is the feature-space Chebyshev
    recursion (plain PyTorch, f32 at either compute_dtype); with a `mesh`,
    the rank's row block of the graph (the dense path's mul_L [4, Nl, N]), x
    [B, Nl, W] its node block and the graph conv the sharded one. Returns
    (forecast [B,N,W], backcast [B,N,W] or None).
    """
    if isinstance(mul_L, SparseLatentGraph):
        if mesh is not None:
            gfted = sharded_sparse_cheb_conv(mesh, mul_L, x)  # [B,4,Nl,W]
        else:
            gfted = sparse_cheb_conv(mul_L, x)  # [B,4,N,W], O(N*k)
    elif mesh is not None:
        gfted = dense_shard.cheb_conv_rows(mesh, mul_L, x, compute_dtype)  # [B,4,Nl,W]
    else:
        gfted = ops.cheb_graph_conv(mul_L.contiguous(), x.contiguous(),
                                    compute_dtype=compute_dtype)  # [B,4,N,W]
    gconv = ops.spe_seq_cell(gfted, block["glu"], cfg.multi_layer,
                             compute_dtype=compute_dtype)  # [B,4,N,Wm]
    igfted = ops.order_contract(gconv, block["weight"])  # [B, N, Wm]
    forecast_source = torch.sigmoid(ops.dense(igfted, block["forecast"]))
    forecast = ops.dense(forecast_source, block["forecast_result"])  # [B, N, W]
    if stack_i == 0:
        backcast_short = ops.dense(x, block["backcast_short_cut"])
        backcast = torch.sigmoid(ops.dense(igfted, block["backcast"]) - backcast_short)
        return forecast, backcast
    return forecast, None


def forward(params, cfg: StemGNNConfig, x, *, training: bool = False,
            dropout_generator=None, dropout_mask=None, compute_dtype: str = "float32",
            mesh=None, batch_sharded: bool = False, use_ring: bool = False):
    """Model.forward (base_model.py:167-179).

    x: [B, W, N] on the device of the params. Returns
    (forecast [B, horizon, N], attention [N, N]), or on the stretch path
    (forecast, the `SparseLatentGraph`). With `training`, dropout on the
    attention (the stretch path: on C): `dropout_mask` (bool, True keeps, of
    `dropout_shape`: [B,N,N] or [N,k]) or a mask drawn from
    `dropout_generator`, a torch.Generator on x's device. `compute_dtype`:
    the graph conv's and the spectral cell's operands. bf16 parameters are
    promoted to f32 first (`promoted`).

    With a `mesh`: one rank's share of a sharded step (module docstring). x
    is this rank's batch rows ([B / data, W, N] with `batch_sharded`, else
    the whole batch) over every node; the dropout mask is the whole step's;
    where `node_sharded`, the forecast is the rank's node block
    [B, horizon, N / graph] and the graph its row block. `use_ring`: the JAX
    package's flag; on a dense model over 'graph' > 1 it raises where 'graph'
    does not divide N and otherwise gives the partition's rows
    (`parallel/ring.py`).
    """
    params = promoted(params)
    mul_L, attention = latent_correlation_layer(
        params, cfg, x, training=training, dropout_generator=dropout_generator,
        dropout_mask=dropout_mask, mesh=mesh, batch_sharded=batch_sharded,
        use_ring=use_ring)
    if node_sharded(cfg, mesh):
        x = x[:, :, mesh.node_block(cfg.units)]
    else:
        mesh = None
    feat = x.permute(0, 2, 1)  # [B, N, W]
    forecasts = []
    for i in range(cfg.stack_cnt):
        f, feat_next = block_forward(params["blocks"][i], cfg, feat, mul_L, i,
                                     compute_dtype, mesh)
        forecasts.append(f)
        if feat_next is not None:
            feat = feat_next
    out = forecasts[0] + forecasts[1]  # [B, N, W] (base_model.py:174)
    h = F.leaky_relu(ops.dense(out, params["fc1"]), negative_slope=0.01)
    out = ops.dense(h, params["fc2"])  # [B, N, horizon]
    return out.permute(0, 2, 1), attention


class StemGNN(nn.Module):
    """nn.Module holding the parameter tree.

    Parameters are registered under their "/"-joined tree names, so the
    state dict carries the JAX layout unchanged.
    """

    def __init__(self, cfg: StemGNNConfig, params=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(seed, cfg, device)
        self.flat = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in flatten_params(params).items()})

    def params(self):
        return unflatten_params(dict(self.flat.items()))

    def forward(self, x, training: bool = False, dropout_generator=None,
                dropout_mask=None, compute_dtype: str = "float32"):
        return forward(self.params(), self.cfg, x, training=training,
                       dropout_generator=dropout_generator, dropout_mask=dropout_mask,
                       compute_dtype=compute_dtype)
