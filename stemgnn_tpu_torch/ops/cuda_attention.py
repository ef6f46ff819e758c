"""Latent attention from the [B, N] key/query projections.

Kernel: csrc/attention.cu, the port of stemgnn_tpu/ops/pallas_attention.py
`_kernel` (rank-1 score, LeakyReLU, stable row softmax). On a CPU tensor
the wrapper runs the plain version, `attention_kq_plain`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stemgnn_tpu_torch.ops import _build, torch_impl

attention_kq_plain = torch_impl.attention_from_kq


@functools.cache
def _fn():
    fn = _build.library("attention").attention_kq_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_kq(key, query, alpha: float):
    """[B, N], [B, N] -> [B, N, N] row-softmaxed LeakyReLU(key_i + query_j)."""
    if key.device.type == "cpu":
        return attention_kq_plain(key, query, alpha)
    _build.require_cuda("attention_kq", key, query)
    b, n = key.shape
    if query.shape != (b, n):
        raise ValueError(f"attention_kq: query {tuple(query.shape)} != key {(b, n)}")
    out = torch.empty((b, n, n), dtype=torch.float32, device=key.device)
    rc = _fn()(key.data_ptr(), query.data_ptr(), out.data_ptr(), b, n,
               float(alpha), _build.stream_ptr(key))
    _build.check(rc, "attention_kq")
    attention_kq.launches += 1
    return out


attention_kq.launches = 0
