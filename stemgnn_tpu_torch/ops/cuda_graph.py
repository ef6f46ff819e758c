"""Chebyshev graph convolution, [K,N,N],[B,N,W] -> [B,K,N,W].

Kernel: csrc/graph.cu, the port of stemgnn_tpu/ops/pallas_graph.py
`_kernel`. A block holds 32 rows of one order's L and 4 whole batches of x
in shared memory over the whole reduction dimension, loaded by cp.async
behind one barrier; a warp owns 8 rows by four w of the 4 batches, the 8
lanes of a batch split the sum over m and add their partial sums by shuffles
in a fixed order, and each lane stores one float4 of a row into the
[B,K,N,W] layout, the chunks of four w spread over the warps. The all-zero
order k = 0 has no blocks: those of order 1 write its slab as zeros.
`launch_plan` makes the tiling from the shape alone (an N too large for
shared memory is walked in panels). Its
backward is plain PyTorch (two einsums), because the JAX package's is the
VJP of the jnp twin and not a kernel either. On a CPU tensor the wrapper
runs the plain version, `cheb_graph_conv_plain`; on a CUDA tensor it
launches the kernel or raises.

With compute_dtype "bfloat16" the wrapper launches the kernel's bf16 arm on
the f32 mul_L and x, which it rounds to bf16 as it stages them (the JAX
package's `_forward` casts them so before its kernel): one launch, no cast
kernel; bf16 operands, f32 sums and output, counted as
`cheb_graph_conv_bf16`. The backward stays the f32 einsums of the f32 inputs,
as the JAX package's VJP of its twin is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

cheb_graph_conv_plain = torch_impl.cheb_graph_conv

SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can have on sm_90
ROW_TILE, BATCH_TILE = 32, 4  # csrc/graph.cu kTM, kTB
MAX_CHUNKS = 4                # chunks of four w in flight a block (kMaxChunks)


class GraphPlan(NamedTuple):
    """How one call's output [B, K, N, W] is laid over the blocks."""
    grid: tuple       # (batch tiles, row tiles, orders with a product: 1..K-1)
    panel: int        # rows of x in shared memory at a time, a multiple of 8
    row_stride: int   # floats a row of the panel of L
    batch_stride: int  # floats a batch of the panel of x: panel * w and a pad of 4
    threads: int      # threads a block: 128 for each chunk of four w in flight
    smem: int         # bytes of dynamic shared memory a block
    vec: bool         # W a multiple of 4: float4 reads of x and stores of out
    orders: int       # K

    def tiles(self, n: int, b: int):
        """(order, rows [n0, n1), batches [b0, b1)) of every tile a block
        writes: its own order's, and for the blocks of order 1 (the first in
        the grid) the zero slab of order 0 as well."""
        for bx in range(self.grid[0]):
            for ny in range(self.grid[1]):
                tile = ((ny * ROW_TILE, min((ny + 1) * ROW_TILE, n)),
                        (bx * BATCH_TILE, min((bx + 1) * BATCH_TILE, b)))
                yield (0, *tile)
                for k in range(1, self.orders):
                    yield (k, *tile)


def _pad(esize: int) -> int:
    """Elements past a batch's panel of x: room for a ragged last read, and a
    whole number of 16-byte pieces."""
    return 16 // esize


def _smem(panel: int, w: int, esize: int = 4) -> int:
    return esize * (ROW_TILE * panel + BATCH_TILE * (panel * w + _pad(esize)))


def launch_plan(k: int, n: int, b: int, w: int, esize: int = 4) -> GraphPlan:
    """The forward's tiling for mul_L [k,n,n], x [b,n,w] of `esize`-byte
    operands (4: the f32 arm, 2: the bf16 arm); needs no card."""
    panel = -(-n // 8) * 8
    if _smem(panel, w, esize) > SMEM_PER_BLOCK:
        # the most rows of x that fit beside their columns of L
        panel = (SMEM_PER_BLOCK - 16 * BATCH_TILE) // (
            esize * (ROW_TILE + BATCH_TILE * w)) // 8 * 8
        if panel < 8:
            raise ValueError(f"cheb_graph_conv: window {w} leaves no room in shared "
                             "memory for eight rows of x")
    return GraphPlan(
        grid=(-(-b // BATCH_TILE), -(-n // ROW_TILE), max(k - 1, 1)), panel=panel,
        row_stride=panel, batch_stride=panel * w + _pad(esize),
        threads=ROW_TILE * BATCH_TILE * min(-(-w // 4), MAX_CHUNKS),
        smem=_smem(panel, w, esize), vec=w % 4 == 0, orders=k)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@functools.cache
def _fn(name: str = "cheb_graph_conv_fwd"):
    fn = getattr(_build.library("graph"), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(mul_L, x, compute_dtype: str = "float32"):
    _build.require_cuda("cheb_graph_conv", mul_L, x)
    k, n, _ = mul_L.shape
    b, nx, w = x.shape
    if mul_L.shape != (k, n, n) or nx != n:
        raise ValueError(
            f"cheb_graph_conv: mul_L {tuple(mul_L.shape)} vs x {tuple(x.shape)}")
    bf16 = torch_impl.operand_dtype(compute_dtype) == torch.bfloat16
    out = torch.empty((b, k, n, w), dtype=torch.float32, device=x.device)
    # the f32 operands themselves: the bf16 arm rounds them in its loads
    plan = launch_plan(k, n, b, w, 2 if bf16 else 4)
    vec = plan.vec and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = _fn("cheb_graph_conv_fwd_bf16" if bf16 else "cheb_graph_conv_fwd")(
        mul_L.data_ptr(), x.data_ptr(), out.data_ptr(), k, n, b, w, plan.panel,
        plan.row_stride, plan.batch_stride, plan.threads, plan.smem, int(vec),
        _build.stream_ptr(x))
    _build.check(rc, "cheb_graph_conv")
    (cheb_graph_conv_bf16 if bf16 else cheb_graph_conv).launches += 1
    return out


class _ChebGraphConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mul_L, x, compute_dtype):
        ctx.save_for_backward(mul_L, x)
        if x.device.type == "cpu":
            return cheb_graph_conv_plain(mul_L, x, compute_dtype)
        return _launch_fwd(mul_L, x, compute_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mul_L, x = ctx.saved_tensors
        return (*torch_impl.cheb_graph_conv_bwd(mul_L, x, g), None)


def cheb_graph_conv(mul_L, x, compute_dtype: str = "float32"):
    """mul_L [K,N,N] (mul_L[0] == 0, the reference's T0), x [B,N,W], both f32;
    compute_dtype "float32" or "bfloat16" (the forward's operands)."""
    if _build.needs_grad(mul_L, x):
        return _ChebGraphConv.apply(mul_L, x, compute_dtype)
    if x.device.type == "cpu":
        return cheb_graph_conv_plain(mul_L, x, compute_dtype)
    return _launch_fwd(mul_L, x, compute_dtype)


cheb_graph_conv.launches = 0
cheb_graph_conv_bf16 = _build.bf16_arm(cheb_graph_conv, "cheb_graph_conv at bfloat16")
