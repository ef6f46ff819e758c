"""Spectral-sequential cell, [B,K,N,W] -> [B,K,N,W*multi].

Kernel: csrc/spectral.cu, the port of stemgnn_tpu/ops/pallas_spectral.py
`_kernel`: a row map over the B*N rows in which the window is so short
(W = 12) that the FFT is a product with a DFT matrix. The forward DFT is
folded into the layer-0 GLU weights here, outside the kernel, in f32
torch.matmul (four [K*W, K*W] x [K*W, K*Wm] products, as the JAX package's
`_forward` does); the kernel runs the six GLUs and the inverse DFT, one
[Wm, Wm] block of it per order. On a CPU tensor the wrapper runs the plain
version, `spe_seq_cell_plain` (a full FFT); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from stemgnn_tpu_torch.ops import _build, torch_impl

spe_seq_cell_plain = torch_impl.spe_seq_cell


@functools.lru_cache(maxsize=16)
def dft_matrices(w: int, k: int, wm: int):
    """Block-diagonal forward/inverse DFT matrices (numpy float32, cached).

    Forward (length w, k blocks):  R = x @ Cf,  I = x @ Sf
        Cf[n, j] = cos(2 pi n j / w),  Sf[n, j] = -sin(2 pi n j / w)
    Inverse (length wm, real part): y = R @ Ci + I @ Si
        Ci[j, n] = cos(2 pi j n / wm) / wm,  Si[j, n] = -sin(...) / wm
    (a copy of stemgnn_tpu/ops/pallas_spectral.py `_dft_matrices`)
    """
    n_idx = np.arange(w)
    ang_f = 2.0 * np.pi * np.outer(n_idx, n_idx) / w
    cf = np.cos(ang_f)
    sf = -np.sin(ang_f)
    m_idx = np.arange(wm)
    ang_i = 2.0 * np.pi * np.outer(m_idx, m_idx) / wm
    ci = np.cos(ang_i) / wm
    si = -np.sin(ang_i) / wm

    def blockdiag(m, reps):
        d = m.shape[0]
        out = np.zeros((d * reps, d * reps), dtype=np.float32)
        for r in range(reps):
            out[r * d : (r + 1) * d, r * d : (r + 1) * d] = m
        return out

    return blockdiag(cf, k), blockdiag(sf, k), blockdiag(ci, k), blockdiag(si, k)


@functools.lru_cache(maxsize=16)
def _dft_on(w: int, k: int, wm: int, device: torch.device):
    """Block-diagonal Cf, Sf for the fold, and one [wm, wm] block of Ci, Si
    for the kernel (every order's block is the same)."""
    cf, sf, ci, si = dft_matrices(w, k, wm)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (cf, sf, ci[:wm, :wm], si[:wm, :wm]))


def folded_weights(glu_params, cf, sf):
    """The 24 GLU tensors in kernel order (wl, bl, wr, br per GLU), with
    the forward DFT folded into GLU 0 (real chain, Cf) and GLU 1 (imag
    chain, Sf): (x @ C) @ W == x @ (C @ W), no bias on the DFT."""
    out = []
    for i, p in enumerate(glu_params):
        wl, wr = p["left"]["w"], p["right"]["w"]
        if i < 2:
            dft = cf if i == 0 else sf
            wl, wr = torch.matmul(dft, wl), torch.matmul(dft, wr)
        out.extend([wl.contiguous(), p["left"]["b"].contiguous(),
                    wr.contiguous(), p["right"]["b"].contiguous()])
    return out


@functools.cache
def _fn():
    fn = _build.library("spectral").spectral_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spe_seq_cell(x, glu_params, multi: int):
    """x [B,K,N,W]; glu_params: 6 GLU dicts (even: real chain, odd: imag)."""
    if x.device.type == "cpu":
        return spe_seq_cell_plain(x, glu_params, multi)
    b, k, n, w = x.shape
    wm = w * multi
    cf, sf, ci, si = _dft_on(w, k, wm, x.device)
    weights = folded_weights(glu_params, cf, sf)
    _build.require_cuda("spe_seq_cell", x, ci, si, *weights)
    for i, t in enumerate(weights):
        d_in = k * w if i < 8 else k * wm
        want = (d_in, k * wm) if i % 2 == 0 else (k * wm,)
        if tuple(t.shape) != want:
            raise ValueError(f"spe_seq_cell: GLU tensor {i} is {tuple(t.shape)}, "
                             f"expected {want}")
    out = torch.empty((b, k, n, wm), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    rc = _fn()(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
               b, k, n, w, wm, _build.stream_ptr(x))
    _build.check(rc, "spe_seq_cell")
    spe_seq_cell.launches += 1
    return out


spe_seq_cell.launches = 0
