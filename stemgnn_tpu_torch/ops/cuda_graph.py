"""Chebyshev graph convolution, [K,N,N],[B,N,W] -> [B,K,N,W].

Kernel: csrc/graph.cu, the port of stemgnn_tpu/ops/pallas_graph.py
`_kernel` (orders k >= 1 as tiled f32 products, the all-zero k = 0 order
skipped and its slab written as zeros). Its backward is plain PyTorch (two
einsums), because the JAX package's is the VJP of the jnp twin and not a
kernel either. On a CPU tensor the wrapper runs the plain version,
`cheb_graph_conv_plain`; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

cheb_graph_conv_plain = torch_impl.cheb_graph_conv


@functools.cache
def _fn():
    fn = _build.library("graph").cheb_graph_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(mul_L, x):
    _build.require_cuda("cheb_graph_conv", mul_L, x)
    k, n, _ = mul_L.shape
    b, nx, w = x.shape
    if mul_L.shape != (k, n, n) or nx != n:
        raise ValueError(
            f"cheb_graph_conv: mul_L {tuple(mul_L.shape)} vs x {tuple(x.shape)}")
    out = torch.empty((b, k, n, w), dtype=torch.float32, device=x.device)
    rc = _fn()(mul_L.data_ptr(), x.data_ptr(), out.data_ptr(), k, n, b, w,
               _build.stream_ptr(x))
    _build.check(rc, "cheb_graph_conv")
    cheb_graph_conv.launches += 1
    return out


class _ChebGraphConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mul_L, x):
        ctx.save_for_backward(mul_L, x)
        if x.device.type == "cpu":
            return cheb_graph_conv_plain(mul_L, x)
        return _launch_fwd(mul_L, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mul_L, x = ctx.saved_tensors
        return torch_impl.cheb_graph_conv_bwd(mul_L, x, g)


def cheb_graph_conv(mul_L, x):
    """mul_L [K,N,N] (mul_L[0] == 0, the reference's T0), x [B,N,W]."""
    if _build.needs_grad(mul_L, x):
        return _ChebGraphConv.apply(mul_L, x)
    if x.device.type == "cpu":
        return cheb_graph_conv_plain(mul_L, x)
    return _launch_fwd(mul_L, x)


cheb_graph_conv.launches = 0
