"""The StemGNN model, dense path, in PyTorch.

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
Only the dense single-device path is here, eval and training: the sparse,
segmented and ring branches are not.
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
from stemgnn_tpu_torch.ops.torch_impl import gru_over_nodes  # noqa: F401 (plain GRU)


# The leaves that go into a kernel's autograd.Function as they are: the
# spectral cell's 24 GLU tensors of each block and the GRU recurrence's w_hh and
# b_hh. The JAX package's custom_vjp of those kernels (pallas_spectral.py
# `_backward` and `_backward_reread`, pallas_gru.py `_vjp_bwd`) return their
# gradients as f32 whatever the parameter's dtype, where every other leaf's
# gradient comes back through a promotion, in the leaf's dtype. A train step
# over bf16 parameters differentiates f32 copies of these (train/engine.py).
KERNEL_GRAD_LEAVES = re.compile(r"blocks/\d+/glu/\d+/(left|right)/[wb]|gru/[wb]_hh")


def kernel_grad_leaf(name: str) -> bool:
    """True for a "/"-joined leaf name in KERNEL_GRAD_LEAVES."""
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


def latent_correlation_layer(params, cfg: StemGNNConfig, x, *, training: bool = False,
                             dropout_generator=None, dropout_mask=None):
    """base_model.py:136-149. Returns (mul_L [4,N,N], attention [N,N]).

    In training the attention [B,N,N] is dropped out before the Laplacian
    (base_model.py:161): `dropout_mask` [B,N,N] bool if given, else a
    mask drawn from `dropout_generator`."""
    enc = ops.gru_over_nodes(params["gru"], x)  # [B, N_seq, N_hid]
    # the reference's input.permute(0,2,1), legal only because hidden == N
    enc = enc.transpose(1, 2)  # [B, N_hid, N_seq]
    key = (enc @ params["weight_key"])[..., 0].contiguous()  # [B, N]
    query = (enc @ params["weight_query"])[..., 0].contiguous()
    att = ops.attention_kq(key, query, cfg.leaky_rate)  # [B, N, N]
    if training and cfg.dropout_rate > 0.0:
        keep = 1.0 - cfg.dropout_rate
        mask = dropout_mask
        if mask is None:
            if dropout_generator is None:
                raise ValueError("training with dropout needs dropout_generator "
                                 "or dropout_mask")
            mask = draw_dropout_mask(att.shape, keep, dropout_generator)
        att = torch.where(mask, att / keep, torch.zeros_like(att))
    return ops.laplacian_from_attention(att)


def block_forward(block, cfg: StemGNNConfig, x, mul_L, stack_i: int,
                  compute_dtype: str = "float32"):
    """One StockBlockLayer (base_model.py:61-75).

    x: [B, N, W]. Returns (forecast [B,N,W], backcast [B,N,W] or None).
    """
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
            dropout_generator=None, dropout_mask=None, compute_dtype: str = "float32"):
    """Model.forward (base_model.py:167-179).

    x: [B, W, N] on the device of the params. Returns
    (forecast [B, horizon, N], attention [N, N]). With `training`, dropout on
    the attention: `dropout_mask` ([B,N,N] bool, True keeps) or a mask drawn
    from `dropout_generator`, a torch.Generator on x's device. `compute_dtype`:
    the graph conv's and the spectral cell's operands. bf16 parameters are
    promoted to f32 first (`promoted`).
    """
    params = promoted(params)
    mul_L, attention = latent_correlation_layer(
        params, cfg, x, training=training, dropout_generator=dropout_generator,
        dropout_mask=dropout_mask)
    feat = x.permute(0, 2, 1)  # [B, N, W]
    forecasts = []
    for i in range(cfg.stack_cnt):
        f, feat_next = block_forward(params["blocks"][i], cfg, feat, mul_L, i,
                                     compute_dtype)
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
