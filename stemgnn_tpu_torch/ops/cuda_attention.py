"""Latent attention from the [B, N] key/query projections.

Kernels: csrc/attention.cu, the port of stemgnn_tpu/ops/pallas_attention.py
`_kernel` (rank-1 score, LeakyReLU, stable row softmax) and `_bwd_kernel`
(softmax and LeakyReLU backward from the saved output, dkey as row sums and
dquery as column sums, reduced in a fixed order). On CPU tensors the
wrappers run the plain versions, `attention_kq_plain` and
`attention_kq_bwd_plain`; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

attention_kq_plain = torch_impl.attention_from_kq
attention_kq_bwd_plain = torch_impl.attention_kq_bwd

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "attention_kq_fwd": [_P] * 3 + [_I] * 2 + [ctypes.c_float, _P],
    "attention_kq_bwd": [_P] * 7 + [_I] * 2 + [ctypes.c_float, _P],
    "attention_kq_bwd_tiles": [_I],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("attention"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(key, query, alpha: float):
    _build.require_cuda("attention_kq", key, query)
    b, n = key.shape
    if query.shape != (b, n):
        raise ValueError(f"attention_kq: query {tuple(query.shape)} != key {(b, n)}")
    out = torch.empty((b, n, n), dtype=torch.float32, device=key.device)
    rc = _fn("attention_kq_fwd")(key.data_ptr(), query.data_ptr(), out.data_ptr(),
                                 b, n, float(alpha), _build.stream_ptr(key))
    _build.check(rc, "attention_kq")
    attention_kq.launches += 1
    return out


def attention_kq_bwd(key, query, p, g, alpha: float):
    """key, query [B, N]; p (the forward's output), g [B, N, N] ->
    (dkey, dquery) [B, N]."""
    if key.device.type == "cpu":
        return attention_kq_bwd_plain(key, query, p, g, alpha)
    _build.require_cuda("attention_kq_bwd", key, query, p, g)
    b, n = key.shape
    if query.shape != (b, n) or p.shape != (b, n, n) or g.shape != (b, n, n):
        raise ValueError(
            f"attention_kq_bwd: key {tuple(key.shape)}, query {tuple(query.shape)}, "
            f"p {tuple(p.shape)}, g {tuple(g.shape)}")
    tiles = _fn("attention_kq_bwd_tiles")(n)
    dkey = torch.empty((b, n), dtype=torch.float32, device=key.device)
    dquery = torch.empty((b, n), dtype=torch.float32, device=key.device)
    part = torch.empty((b, tiles, n), dtype=torch.float32, device=key.device)
    rc = _fn("attention_kq_bwd")(
        key.data_ptr(), query.data_ptr(), p.data_ptr(), g.data_ptr(),
        dkey.data_ptr(), dquery.data_ptr(), part.data_ptr(), b, n, float(alpha),
        _build.stream_ptr(key))
    _build.check(rc, "attention_kq_bwd")
    attention_kq_bwd.launches += 1
    return dkey, dquery


attention_kq_bwd.launches = 0


class _AttentionKQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, key, query, alpha):
        if key.device.type == "cpu":
            p = attention_kq_plain(key, query, alpha)
        else:
            p = _launch_fwd(key, query, alpha)
        ctx.save_for_backward(key, query, p)
        ctx.alpha = alpha
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        key, query, p = ctx.saved_tensors
        dkey, dquery = attention_kq_bwd(key, query, p, g.contiguous(), ctx.alpha)
        return dkey, dquery, None


def attention_kq(key, query, alpha: float):
    """[B, N], [B, N] -> [B, N, N] row-softmaxed LeakyReLU(key_i + query_j)."""
    if _build.needs_grad(key, query):
        return _AttentionKQ.apply(key, query, alpha)
    if key.device.type == "cpu":
        return attention_kq_plain(key, query, alpha)
    return _launch_fwd(key, query, alpha)


attention_kq.launches = 0
