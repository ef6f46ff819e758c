"""Chebyshev graph convolution, [K,N,N],[B,N,W] -> [B,K,N,W].

Kernels: csrc/graph.cu, the port of stemgnn_tpu/ops/pallas_graph.py
`_kernel`, one for each arm. The f32 arm (`cheb_graph_conv_kernel`): a
block holds 32 rows of one order's L and 4 whole batches of x
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

With compute_dtype "bfloat16" the wrapper launches the bf16 arm, a kernel of
its own on the tensor cores (`cheb_graph_conv_mma_kernel`, mma.sync bf16 x
bf16 -> f32), on the f32 mul_L and x, which it rounds to bf16 as it stages
them (the JAX package's `_forward` casts them so before its kernel): one
launch, no cast kernel; bf16 operands, f32 sums and output, counted as
`cheb_graph_conv_bf16`. Its tiles come from `mma_plan`: row tiles by whole
batches of x, the node sum split over the blocks of a cluster (added in rank
order) where the tiles alone fall short of the card's SMs. The backward
stays the f32 einsums of the f32 inputs, as the JAX package's VJP of its
twin is.

The row-block arm (`cheb_graph_conv_rows`, and `cheb_graph_conv_rows_bf16`)
launches the same kernels on a row block of mul_L, [K,M,N] against the whole
x [B,N,W], giving [B,K,M,W]: the node-sharded dense path's rows of the conv
(`parallel/dense_shard.py`). Its tiles walk the M rows, the sum stays over N;
at M = N each arm takes the square call's plan and gives its bits. It counts
its launches apart.
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


# floats past a batch's panel of x: room for a ragged last read, and a whole
# number of 16-byte pieces
_PAD = 4


def _smem(panel: int, w: int) -> int:
    return 4 * (ROW_TILE * panel + BATCH_TILE * (panel * w + _PAD))


def launch_plan(k: int, n: int, b: int, w: int, m: int | None = None) -> GraphPlan:
    """The f32 arm's tiling for mul_L [k,n,n], x [b,n,w] (the bf16 arm plans
    with `mma_plan`); needs no card. `m`: the rows of a row block, mul_L
    [k,m,n] (m = n where not given): row tiles of m, panels of n."""
    m = n if m is None else m
    panel = -(-n // 8) * 8
    if _smem(panel, w) > SMEM_PER_BLOCK:
        # the most rows of x that fit beside their columns of L
        panel = (SMEM_PER_BLOCK - 16 * BATCH_TILE) // (
            4 * (ROW_TILE + BATCH_TILE * w)) // 8 * 8
        if panel < 8:
            raise ValueError(f"cheb_graph_conv: window {w} leaves no room in shared "
                             "memory for eight rows of x")
    return GraphPlan(
        grid=(-(-b // BATCH_TILE), -(-m // ROW_TILE), max(k - 1, 1)), panel=panel,
        row_stride=panel, batch_stride=panel * w + _PAD,
        threads=ROW_TILE * BATCH_TILE * min(-(-w // 4), MAX_CHUNKS),
        smem=_smem(panel, w), vec=w % 4 == 0, orders=k)


# The bf16 arm's kernel on the tensor cores (csrc/graph.cu
# `cheb_graph_conv_mma_kernel`): its constants, and the shared memory of a
# plan as `mma_smem` there counts it.
MMA_KC = 32            # kKC: nodes of the sum a stage holds
MMA_LDA = MMA_KC + 8   # kLda
MMA_MAX_TN = 128       # kMaxTN: columns a tile
MMA_MAX_CLUSTER = 8    # kMaxCluster: the portable cluster size
MMA_ROW_TILES = (64, 32, 16)  # TM, the largest first
MMA_SHORT_SUM = 8      # chunks of a node sum that runs unsplit where half the SMs are busy
MAX_GRID_Y = 65_535


def _mma_smem(tm: int, tn: int) -> int:
    """The two bf16 stages (or the block's partial tile over them), the
    partials it receives and their mbarrier, as csrc/graph.cu `mma_smem`."""
    stages = 2 * (tm * MMA_LDA + MMA_KC * (tn + 8)) * 2
    tile = tm * (-(-tn // 32) * 32 + 8) * 4
    return max(stages, tile) + tile + 16


class MmaPlan(NamedTuple):
    """How the bf16 arm's output [B, K, M, W] is laid over clusters of blocks."""
    tm: int           # rows of a tile: 16, 32 or 64
    tb: int           # whole batches of x a column tile
    tw: int           # of W's columns a column tile (W, or W in pieces where W > 128)
    tn: int           # the tile's columns tb * tw padded to a multiple of 16
    cluster: int      # C: blocks a cluster, each one segment of the node sum
    grid: tuple       # (C * column tiles, row tiles, orders with a product: 1..K-1)
    smem: int         # bytes of dynamic shared memory a block
    orders: int       # K
    chunks: int       # MMA_KC-node chunks of the sum

    def c_args(self) -> tuple:
        """The plan as the C entry takes it, after the shape."""
        return (self.tm, self.tb, self.tw, self.tn, self.cluster, self.smem)

    def segments(self):
        """[chunk lo, chunk hi) of each rank's segment of the node sum, in rank
        order (the kernel's z * chunks / C)."""
        c = self.cluster
        return [(z * self.chunks // c, (z + 1) * self.chunks // c) for z in range(c)]

    def tiles(self, m: int, b: int, w: int):
        """(order, rows [n0, n1), batches [b0, b1), columns [w0, w1), rank) of
        every tile a block stores: rank z of a cluster its rows z * TM / C..
        of the cluster's tile, of its own order and, for the blocks of order 1
        (the first in the grid), of the zero slab of order 0."""
        wtiles = -(-w // self.tw)
        for bx in range(self.grid[0]):
            ct, z = divmod(bx, self.cluster)
            b0, w0 = ct // wtiles * self.tb, ct % wtiles * self.tw
            for ny in range(self.grid[1]):
                n0 = ny * self.tm
                rows = min(self.tm, m - n0)
                r0 = z * self.tm // self.cluster
                r1 = min((z + 1) * self.tm // self.cluster, rows)
                if r0 >= r1:
                    continue
                tile = ((n0 + r0, n0 + r1), (b0, min(b0 + self.tb, b)),
                        (w0, min(w0 + self.tw, w)), z)
                for oz in range(self.grid[2]):
                    k = oz + 1
                    if oz == 0:
                        yield (0, *tile)
                    if k < self.orders:
                        yield (k, *tile)


def mma_plan(k: int, n: int, b: int, w: int, sms: int, m: int | None = None) -> MmaPlan:
    """The bf16 arm's tiling for mul_L [k,m,n] (m = n where not given) and x
    [b,n,w] on a card of `sms` SMs; needs no card. Column tiles take as many
    whole batches as fit in MMA_MAX_TN columns (balanced over the tiles), or
    at w > MMA_MAX_TN one batch's w in pieces of a multiple of 4. A node sum
    of at most MMA_SHORT_SUM chunks is not split where its tiles give at
    least half the SMs: the largest row tile (64, 32, 16) that does. Else the
    largest row tile whose tiles, the node sum split over 1, 2, 4 or 8 blocks
    of a cluster, give at least `sms` blocks, with the fewest segments; where
    none does, 16 rows and as many segments as the chunks allow. Plans from
    the shape and `sms` alone: at m = n the square call's."""
    m = n if m is None else m
    if min(k, n, m, b, w) < 1:
        raise ValueError(f"cheb_graph_conv_bf16: no plan for K={k} M={m} N={n} B={b} W={w}")
    if w <= MMA_MAX_TN:
        tw = w
        ctiles = -(-b // min(b, MMA_MAX_TN // w))
        tb = -(-b // ctiles)
    else:
        tw = -(-w // -(-w // MMA_MAX_TN))  # w over the fewest pieces
        tw = -(-tw // 4) * 4
        tb, ctiles = 1, b * -(-w // tw)
    tn = -(-tb * tw // 16) * 16
    orders = max(k - 1, 1)
    chunks = -(-n // MMA_KC)
    splits = [c for c in (1, 2, 4, 8) if c <= min(chunks, MMA_MAX_CLUSTER)] if k > 1 else [1]
    blocks = lambda tm, c: -(-m // tm) * ctiles * orders * c  # noqa: E731
    if chunks <= MMA_SHORT_SUM and blocks(MMA_ROW_TILES[-1], 1) * 2 >= sms:
        # a short sum: no split (its exchange costs more than the chunks it
        # saves), the largest row tile that gives half the SMs
        choice = next((tm, 1) for tm in MMA_ROW_TILES if blocks(tm, 1) * 2 >= sms)
    else:
        choice = next(((tm, c) for tm in MMA_ROW_TILES for c in splits
                       if blocks(tm, c) >= sms), (MMA_ROW_TILES[-1], splits[-1]))
    tm, c = choice
    if -(-m // tm) > MAX_GRID_Y:
        raise ValueError(f"cheb_graph_conv_bf16: {m} rows need more than {MAX_GRID_Y} row "
                         "tiles")
    return MmaPlan(tm=tm, tb=tb, tw=tw, tn=tn, cluster=c,
                   grid=(c * ctiles, -(-m // tm), orders), smem=_mma_smem(tm, tn),
                   orders=k, chunks=chunks)


# both entries: L, x, out, the shape and the plan (11 ints), the stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.cache
def _fn(name: str = "cheb_graph_conv_fwd"):
    fn = getattr(_build.library("graph"), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(mul_L, x, compute_dtype: str = "float32", rows: bool = False):
    """out [B,K,M,W] of mul_L [K,M,N] and x [B,N,W] (M = N unless `rows`),
    counted on the wrapper of its arm."""
    counter = ((cheb_graph_conv_rows_bf16 if rows else cheb_graph_conv_bf16)
               if torch_impl.operand_dtype(compute_dtype) == torch.bfloat16
               else cheb_graph_conv_rows if rows else cheb_graph_conv)
    _build.require_cuda(counter.__name__, mul_L, x)
    k, m, n = mul_L.shape
    b, nx, w = x.shape
    if nx != n or (m != n and not rows):
        raise ValueError(
            f"{counter.__name__}: mul_L {tuple(mul_L.shape)} vs x {tuple(x.shape)}")
    out = torch.empty((b, k, m, w), dtype=torch.float32, device=x.device)
    if counter in (cheb_graph_conv_bf16, cheb_graph_conv_rows_bf16):
        # the f32 operands themselves: the kernel rounds them in its loads
        mp = mma_plan(k, n, b, w, _build.card_limits(x.device)[0], m=m)
        rc = _fn("cheb_graph_conv_fwd_bf16")(
            mul_L.data_ptr(), x.data_ptr(), out.data_ptr(), k, m, n, b, w, *mp.c_args(),
            _build.stream_ptr(x))
    else:
        plan = launch_plan(k, n, b, w, m=m)
        vec = plan.vec and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        rc = _fn("cheb_graph_conv_fwd")(
            mul_L.data_ptr(), x.data_ptr(), out.data_ptr(), k, m, n, b, w, plan.panel,
            plan.row_stride, plan.batch_stride, plan.threads, plan.smem, int(vec),
            _build.stream_ptr(x))
    _build.check(rc, counter.__name__)
    counter.launches += 1
    return out


class _ChebGraphConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mul_L, x, compute_dtype, rows):
        ctx.save_for_backward(mul_L, x)
        if x.device.type == "cpu":
            return cheb_graph_conv_plain(mul_L, x, compute_dtype)
        return _launch_fwd(mul_L, x, compute_dtype, rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mul_L, x = ctx.saved_tensors
        return (*torch_impl.cheb_graph_conv_bwd(mul_L, x, g), None, None)


def _conv(mul_L, x, compute_dtype: str, rows: bool):
    if _build.needs_grad(mul_L, x):
        return _ChebGraphConv.apply(mul_L, x, compute_dtype, rows)
    if x.device.type == "cpu":
        return cheb_graph_conv_plain(mul_L, x, compute_dtype)
    return _launch_fwd(mul_L, x, compute_dtype, rows)


def cheb_graph_conv(mul_L, x, compute_dtype: str = "float32"):
    """mul_L [K,N,N] (mul_L[0] == 0, the reference's T0), x [B,N,W], both f32;
    compute_dtype "float32" or "bfloat16" (the forward's operands)."""
    if mul_L.shape[1] != mul_L.shape[2]:
        raise ValueError(f"cheb_graph_conv: mul_L {tuple(mul_L.shape)} is no square "
                         "(a row block: cheb_graph_conv_rows)")
    return _conv(mul_L, x, compute_dtype, False)


cheb_graph_conv.launches = 0
cheb_graph_conv_bf16 = _build.bf16_arm(cheb_graph_conv, "cheb_graph_conv at bfloat16")


def cheb_graph_conv_rows(mul_L, x, compute_dtype: str = "float32"):
    """mul_L [K,M,N] (a row block of the nodes' Chebyshev stack), x [B,N,W]
    -> [B,K,M,W]: the block's rows of `cheb_graph_conv`."""
    return _conv(mul_L, x, compute_dtype, True)


cheb_graph_conv_rows.launches = 0
cheb_graph_conv_rows_bf16 = _build.bf16_arm(cheb_graph_conv_rows,
                                            "cheb_graph_conv_rows at bfloat16")
