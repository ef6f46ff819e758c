"""GRU over the node axis, x [B, W, N] -> [B, N_seq, H].

Kernel: csrc/gru.cu, the port of stemgnn_tpu/ops/pallas_gru.py
`_fwd_kernel` (the N-step recurrence in one persistent block). The input
projection x @ W_ih^T + b_ih stays one torch.matmul outside the kernel, as
the JAX package leaves it to XLA. On a CPU tensor the wrapper runs the
plain version, `gru_over_nodes_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stemgnn_tpu_torch.ops import _build, torch_impl

gru_over_nodes_plain = torch_impl.gru_over_nodes


@functools.cache
def _fn():
    fn = _build.library("gru").gru_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gru_over_nodes(gru, x):
    """gru: {'w_ih' [3H,W], 'w_hh' [3H,H], 'b_ih' [3H], 'b_hh' [3H]}."""
    if x.device.type == "cpu":
        return gru_over_nodes_plain(gru, x)
    b, _, n = x.shape
    x_proj = torch_impl.gru_input_projection(gru, x).contiguous()  # [N, B, 3H]
    w_hh_t = gru["w_hh"].T.contiguous()  # [H, 3H], gate-major columns
    b_hh = gru["b_hh"].contiguous()
    _build.require_cuda("gru_over_nodes", x_proj, w_hh_t, b_hh)
    h = w_hh_t.shape[0]
    out = torch.empty((b, n, h), dtype=torch.float32, device=x.device)
    rc = _fn()(x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
               out.data_ptr(), n, b, h, _build.stream_ptr(x))
    _build.check(rc, "gru_over_nodes")
    gru_over_nodes.launches += 1
    return out


gru_over_nodes.launches = 0
