"""Latent attention from the [B, N] key/query projections.

Kernels: csrc/attention.cu, the port of stemgnn_tpu/ops/pallas_attention.py
`_kernel` (rank-1 score, LeakyReLU, stable row softmax) and `_bwd_kernel`
(softmax and LeakyReLU backward from the saved output, dkey as row sums and
dquery as column sums, reduced in a fixed order). On CPU tensors the
wrappers run the plain versions, `attention_kq_plain` and
`attention_kq_bwd_plain`; on CUDA tensors they launch the kernels or raise.

Both kernels take their layout from pure-Python plans of the shape
(`fwd_plan`, `bwd_plan`), so what a warp and a block own is checked on the
CPU. A lane holds runs of `vec` columns (4 where N % 4 == 0 and the rows are
16-byte aligned: 16-byte loads and stores; else 1), `runs` of them, so a warp
holds a span of 32 * vec * runs columns of a row in registers. A row wider
than the widest span (1024 columns) takes the forward's wide instantiation
(three sweeps over spans) and the backward's chunked one (a dot pass, then
chunks of 256 columns): no N is refused. The backward is one launch of B
clusters of up to 8 blocks, its column sums added across the cluster through
distributed shared memory.

The row-block arms (`attention_rows`, `attention_rows_bwd`) launch the same
kernels on key [B, M] of M < N rows against the whole query [B, N]: the
node-sharded dense path's rows of the attention (`parallel/dense_shard.py`,
with `use_ring` too). The backward's dquery is then that block's share, the
sum over its M rows. They count their launches apart, and at M = N they take
the square call's plan and give its bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

attention_kq_plain = torch_impl.attention_from_kq
attention_kq_bwd_plain = torch_impl.attention_kq_bwd
attention_rows_plain = torch_impl.attention_rows
attention_rows_bwd_plain = torch_impl.attention_rows_bwd

MAX_CLUSTER = 8          # blocks a cluster, the portable limit
MAX_VALUES = 32          # values of a row a lane holds in registers: vec * runs
FWD_THREADS = 256        # csrc/attention.cu kFwdThreads
FWD_WARPS_PER_SM = 32    # warps a forward plan puts on an SM in its one wave
BWD_CHUNK_VALUES = 8     # vec * runs of the chunked backward: chunks of 256 columns
BWD_ROWS_PER_WARP = 2    # rows a backward warp aims to take in turn
# Where a backward plan has more blocks than the card has SMs, its blocks
# take at most this many warps by the values a lane holds (p, g * p, the
# query and the partials take about 4 * values registers; smaller blocks
# leave room for more of them an SM: kernel_variants attention on an H100 at
# B = 32, N = 512, 4 warps a block 0.0276 ms, 16 warps 0.0322)
BWD_CROWDED_WARPS = {16: 4}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _runs(n: int, vec: int) -> tuple[int, bool]:
    """(runs a lane holds, the row wider than the span they make): the
    fewest powers of two that cover n columns, at most MAX_VALUES values."""
    need = _ceil_div(n, 32 * vec)
    runs = 1
    while runs < need and vec * runs < MAX_VALUES:
        runs *= 2
    return runs, need > runs


class FwdPlan(NamedTuple):
    """How the forward's rows [B * N] are laid over warps."""
    vec: int            # columns a run: 4 (16-byte accesses) or 1
    runs: int           # runs a lane holds: a span of 32 * vec * runs columns
    wide: bool          # the row is wider than the span: sweeps over spans
    rows_per_warp: int  # rows of one batch element a warp takes in turn
    bands: int          # warps a batch element
    blocks: int         # blocks of FWD_THREADS threads

    def rows(self, n: int, b: int):
        """(batch element, rows [i0, i1)) of every warp that has rows."""
        for task in range(b * self.bands):
            bi, band = divmod(task, self.bands)
            i0 = band * self.rows_per_warp
            if i0 < n:
                yield bi, i0, min(n, i0 + self.rows_per_warp)


def fwd_plan(b: int, n: int, sms: int, vec_ok: bool = True,
             rows_per_warp: int | None = None, m: int | None = None) -> FwdPlan:
    """The forward's layout for key, query [b, n] on a card of `sms` SMs:
    enough rows a warp that the warps fit one wave of FWD_WARPS_PER_SM an
    SM (`rows_per_warp` sets them instead). `vec_ok` False (an operand not
    16-byte aligned) takes 4-byte runs. `m`: the rows of a row block, key
    [b, m] against query [b, n] (m = n where not given)."""
    m = n if m is None else m
    vec = 4 if vec_ok and n % 4 == 0 else 1
    runs, wide = _runs(n, vec)
    if rows_per_warp is None:
        rows_per_warp = _ceil_div(b * m, sms * FWD_WARPS_PER_SM)
    rows_per_warp = min(m, max(1, rows_per_warp))
    bands = _ceil_div(m, rows_per_warp)
    return FwdPlan(vec=vec, runs=runs, wide=wide, rows_per_warp=rows_per_warp,
                   bands=bands, blocks=_ceil_div(b * bands, FWD_THREADS // 32))


class BwdPlan(NamedTuple):
    """How the backward's rows and columns of one batch element are laid over
    the blocks of its cluster."""
    vec: int             # columns a run: 4 (16-byte loads) or 1
    runs: int            # runs a lane holds: a span of 32 * vec * runs columns
    chunked: bool        # the row is wider than the widest span: chunks of a span
    cluster: int         # blocks a cluster (a batch element)
    warps: int           # warps a block
    rows_per_block: int  # block c owns rows [c * rows_per_block, ...)
    slice: int           # block c owns the c-th slice of this many columns of
                         # dquery (of N, or of each chunk when chunked)
    smem: int            # bytes of dynamic shared memory a block

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def span(self) -> int:
        return 32 * self.vec * self.runs

    def warp_rows(self, m: int, c: int, w: int) -> list:
        """The rows (of m) warp w of block c takes, in its order."""
        r0 = c * self.rows_per_block
        return list(range(r0 + w, min(m, r0 + self.rows_per_block), self.warps))


def bwd_max_threads(values: int, chunked: bool) -> int:
    """csrc/attention.cu `bwd_max_threads`: the threads a backward block may
    have where a lane holds `values` (vec * runs) of a row."""
    if chunked:
        return 1024
    return 256 if values >= 32 else 512 if values >= 16 else 1024


def bwd_plan(b: int, n: int, sms: int, smem_per_block: int, vec_ok: bool = True,
             cluster: int | None = None, warps: int | None = None,
             m: int | None = None) -> BwdPlan:
    """The backward's layout for p, g [b, n, n] on a card of `sms` SMs
    whose blocks may have `smem_per_block` bytes of shared memory; `vec_ok`
    as in `fwd_plan`. A cluster of up to MAX_CLUSTER blocks and
    BWD_ROWS_PER_WARP rows a warp (`cluster` and `warps` set them instead).
    The shared memory does not grow with n past the widest span. `m`: the
    rows of a row block, p, g [b, m, n], whose rows the cluster's blocks
    split (m = n where not given); the columns' slices stay of n."""
    m = n if m is None else m
    vec = 4 if vec_ok and n % 4 == 0 else 1
    runs, chunked = _runs(n, vec)
    if chunked:
        runs = BWD_CHUNK_VALUES // vec
    span = 32 * vec * runs
    rows_per_block = _ceil_div(m, min(cluster or MAX_CLUSTER, MAX_CLUSTER, m))
    cluster = _ceil_div(m, rows_per_block)
    if warps is None:
        warps = _ceil_div(rows_per_block, BWD_ROWS_PER_WARP)
        if b * cluster > sms:
            warps = min(warps, BWD_CROWDED_WARPS.get(vec * runs, warps))
    warps = min(warps, bwd_max_threads(vec * runs, chunked) // 32)
    slice_ = _ceil_div(span if chunked else n, cluster)
    smem = 4 * (warps * span + (2 if chunked else 1) * cluster * slice_)
    if smem > smem_per_block:
        raise ValueError(f"attention_kq_bwd: {smem} bytes of shared memory a block, "
                         f"the card has {smem_per_block}")
    return BwdPlan(vec=vec, runs=runs, chunked=chunked, cluster=cluster, warps=warps,
                   rows_per_block=rows_per_block, slice=slice_, smem=smem)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "attention_kq_fwd": [_P] * 3 + [_I] * 3 + [ctypes.c_float] + [_I] * 6 + [_P],
    "attention_kq_bwd": [_P] * 6 + [_I] * 3 + [ctypes.c_float] + [_I] * 8 + [_P],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("attention"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(key, query, alpha: float, counter=None):
    """out [B, M, N] of key [B, M] and query [B, N], counted on `counter`
    (the square wrapper's count where not given)."""
    counter = counter or attention_kq
    _build.require_cuda(counter.__name__, key, query)
    b, m = key.shape
    n = query.shape[1]
    if query.shape[0] != b:
        raise ValueError(f"{counter.__name__}: query {tuple(query.shape)} vs key {(b, m)}")
    out = torch.empty((b, m, n), dtype=torch.float32, device=key.device)
    plan = fwd_plan(b, n, _build.card_limits(key.device)[0], _aligned(query, out), m=m)
    rc = _fn("attention_kq_fwd")(key.data_ptr(), query.data_ptr(), out.data_ptr(),
                                 b, m, n, float(alpha), plan.vec, plan.runs, int(plan.wide),
                                 plan.rows_per_warp, plan.bands, plan.blocks,
                                 _build.stream_ptr(key))
    _build.check(rc, counter.__name__)
    counter.launches += 1
    return out


def _launch_bwd(key, query, p, g, alpha: float, counter=None):
    """(dkey [B, M], dquery [B, N]) of p, g [B, M, N], counted on `counter`
    (the square wrapper's count where not given)."""
    counter = counter or attention_kq_bwd
    _build.require_cuda(counter.__name__, key, query, p, g)
    b, m = key.shape
    n = query.shape[1]
    if query.shape[0] != b or p.shape != (b, m, n) or g.shape != (b, m, n):
        raise ValueError(
            f"{counter.__name__}: key {tuple(key.shape)}, query {tuple(query.shape)}, "
            f"p {tuple(p.shape)}, g {tuple(g.shape)}")
    plan = bwd_plan(b, n, *_build.card_limits(key.device), _aligned(query, p, g), m=m)
    dkey = torch.empty((b, m), dtype=torch.float32, device=key.device)
    dquery = torch.empty((b, n), dtype=torch.float32, device=key.device)
    rc = _fn("attention_kq_bwd")(
        key.data_ptr(), query.data_ptr(), p.data_ptr(), g.data_ptr(), dkey.data_ptr(),
        dquery.data_ptr(), b, m, n, float(alpha), plan.vec, plan.runs, int(plan.chunked),
        plan.cluster, plan.threads, plan.rows_per_block, plan.slice, plan.smem,
        _build.stream_ptr(key))
    _build.check(rc, counter.__name__)
    counter.launches += 1
    return dkey, dquery


def _square(key, query, name: str) -> None:
    if query.shape != key.shape:
        raise ValueError(f"{name}: query {tuple(query.shape)} != key "
                         f"{tuple(key.shape)} (a row block: attention_rows)")


def attention_kq_bwd(key, query, p, g, alpha: float):
    """key, query [B, N]; p (the forward's output), g [B, N, N] ->
    (dkey, dquery) [B, N]."""
    _square(key, query, "attention_kq_bwd")
    if key.device.type == "cpu":
        return attention_kq_bwd_plain(key, query, p, g, alpha)
    return _launch_bwd(key, query, p, g, alpha, attention_kq_bwd)


attention_kq_bwd.launches = 0


def attention_rows_bwd(key, query, p, g, alpha: float):
    """key [B, M] (a row block), query [B, N]; p (the forward's output), g
    [B, M, N] -> (dkey [B, M], dquery [B, N]): dquery the block's share, the
    sum over its M rows."""
    if key.device.type == "cpu":
        return attention_rows_bwd_plain(key, query, p, g, alpha)
    return _launch_bwd(key, query, p, g, alpha, attention_rows_bwd)


attention_rows_bwd.launches = 0


class _AttentionKQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, key, query, alpha, fwd, bwd):
        if key.device.type == "cpu":
            p = attention_kq_plain(key, query, alpha)
        else:
            p = _launch_fwd(key, query, alpha, fwd)
        ctx.save_for_backward(key, query, p)
        ctx.alpha, ctx.bwd = alpha, bwd
        return p

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        key, query, p = ctx.saved_tensors
        dkey, dquery = ctx.bwd(key, query, p, g.contiguous(), ctx.alpha)
        return dkey, dquery, None, None, None


def _attention(key, query, alpha: float, fwd, bwd):
    if _build.needs_grad(key, query):
        return _AttentionKQ.apply(key, query, alpha, fwd, bwd)
    if key.device.type == "cpu":
        return attention_kq_plain(key, query, alpha)
    return _launch_fwd(key, query, alpha, fwd)


def attention_kq(key, query, alpha: float):
    """[B, N], [B, N] -> [B, N, N] row-softmaxed LeakyReLU(key_i + query_j)."""
    _square(key, query, "attention_kq")
    return _attention(key, query, alpha, attention_kq, attention_kq_bwd)


attention_kq.launches = 0


def attention_rows(key, query, alpha: float):
    """key [B, M] (a row block of the nodes), query [B, N] -> [B, M, N]: the
    block's rows of `attention_kq`."""
    return _attention(key, query, alpha, attention_rows, attention_rows_bwd)


attention_rows.launches = 0
