"""GRU over the node axis, x [B, W, N] -> [B, N_seq, H].

Kernels: csrc/gru.cu, the port of stemgnn_tpu/ops/pallas_gru.py
`_fwd_kernel` (the N-step recurrence in one persistent block; `gru_fwd`
for serving, `gru_fwd_save` when a gradient is needed, which also writes
the five saved activations per step) and `_bwd_kernel` (`gru_bwd`, the
reverse recurrence over them). The input projection x @ W_ih^T + b_ih
stays one torch.matmul outside the kernel, differentiated by autograd, and
the recurrent weight and bias gradients are products over all steps after
the backward kernel, as the JAX package leaves all three to XLA. On CPU
tensors the wrappers run the plain versions, `gru_over_nodes_plain` and
`gru_scan_bwd_plain`; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

gru_over_nodes_plain = torch_impl.gru_over_nodes
gru_scan_bwd_plain = torch_impl.gru_scan_bwd

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gru_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "gru_fwd_save": [_P] * 5 + [_I] * 3 + [_P],
    "gru_bwd": [_P] * 4 + [_I] * 3 + [_P],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("gru"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(x_proj, w_hh_t, b_hh, save: bool):
    """x_proj [N, B, 3H], w_hh_t [H, 3H], b_hh [3H] -> (out [B, N, H],
    saved [N, 5, B, H] or None)."""
    _build.require_cuda("gru_over_nodes", x_proj, w_hh_t, b_hh)
    n, b, h3 = x_proj.shape
    h = w_hh_t.shape[0]
    if w_hh_t.shape != (h, h3) or h3 != 3 * h or b_hh.shape != (h3,):
        raise ValueError(
            f"gru_over_nodes: x_proj {tuple(x_proj.shape)}, w_hh_t "
            f"{tuple(w_hh_t.shape)}, b_hh {tuple(b_hh.shape)}")
    out = torch.empty((b, n, h), dtype=torch.float32, device=x_proj.device)
    ptrs = [x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), out.data_ptr()]
    saved = None
    if save:
        saved = torch.empty((n, 5, b, h), dtype=torch.float32, device=x_proj.device)
        ptrs.append(saved.data_ptr())
    rc = _fn("gru_fwd_save" if save else "gru_fwd")(
        *ptrs, n, b, h, _build.stream_ptr(x_proj))
    _build.check(rc, "gru_over_nodes")
    gru_over_nodes.launches += 1
    return out, saved


def gru_scan_bwd(saved, g, a_all):
    """saved [N, 5, B, H], g [B, N, H], a_all [H, 3H] -> dxp [N, B, 3H]."""
    if saved.device.type == "cpu":
        return gru_scan_bwd_plain(saved, g, a_all)
    a_t = a_all.t().contiguous()  # [3H, H], what the kernel reads along rows
    _build.require_cuda("gru_scan_bwd", saved, g, a_t)
    n, five, b, h = saved.shape
    if five != 5 or g.shape != (b, n, h) or a_t.shape != (3 * h, h):
        raise ValueError(
            f"gru_scan_bwd: saved {tuple(saved.shape)}, g {tuple(g.shape)}, "
            f"a_all {tuple(a_all.shape)}")
    dxp = torch.empty((n, b, 3 * h), dtype=torch.float32, device=saved.device)
    rc = _fn("gru_bwd")(saved.data_ptr(), g.data_ptr(), a_t.data_ptr(),
                        dxp.data_ptr(), n, b, h, _build.stream_ptr(saved))
    _build.check(rc, "gru_scan_bwd")
    gru_scan_bwd.launches += 1
    return dxp


gru_scan_bwd.launches = 0


class _GruScan(torch.autograd.Function):
    """The recurrence core under autograd: (x_proj, w_hh_t, b_hh) -> out."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, b_hh):
        if x_proj.device.type == "cpu":
            out, saved = torch_impl.gru_scan(x_proj, w_hh_t, b_hh, save=True)
        else:
            out, saved = _launch_fwd(x_proj, w_hh_t, b_hh, save=True)
        ctx.save_for_backward(w_hh_t, out, saved)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w_hh_t, out, saved = ctx.saved_tensors
        dxp = gru_scan_bwd(saved, g.contiguous(), w_hh_t)
        dw_hh_t, db_hh = torch_impl.gru_weight_grads(saved, out, dxp)
        return dxp, dw_hh_t, db_hh


def gru_over_nodes(gru, x):
    """gru: {'w_ih' [3H,W], 'w_hh' [3H,H], 'b_ih' [3H], 'b_hh' [3H]}."""
    x_proj = torch_impl.gru_input_projection(gru, x).contiguous()  # [N, B, 3H]
    w_hh_t = gru["w_hh"].T.contiguous()  # [H, 3H], gate-major columns
    b_hh = gru["b_hh"].contiguous()
    if _build.needs_grad(x_proj, w_hh_t, b_hh):
        return _GruScan.apply(x_proj, w_hh_t, b_hh)
    if x.device.type == "cpu":
        return torch_impl.gru_scan(x_proj, w_hh_t, b_hh)
    return _launch_fwd(x_proj, w_hh_t, b_hh, save=False)[0]


gru_over_nodes.launches = 0
