"""GRU over the node axis, x [B, W, N] -> [B, N_seq, H].

Kernels: csrc/gru.cu, the port of stemgnn_tpu/ops/pallas_gru.py
`_fwd_kernel` and `_bwd_kernel`.

Two routes, chosen by shape (`launch_plan`, `bwd_plan`), for both
recurrences:
- cluster (`gru_fwd_cluster`, `gru_bwd_cluster`; H <= 360): groups of 4
  batch rows are independent thread-block clusters, and inside a cluster
  each block owns a slice of the hidden units with its part of W_hh^T
  resident in shared memory for all N steps (the forward: the slice's three
  gate columns; the backward: the slice's rows). The blocks send each other
  what the next step needs (the forward h', the backward the gate gradients)
  through distributed shared memory and wait on an mbarrier of their own for
  a step's values, with no cluster-wide barrier in the loop.
- grid (`gru_fwd_grid`, `gru_bwd_grid`; every H whose slices fit no cluster
  of `MAX_CLUSTER` blocks): one cooperative launch of a block per SM (at
  most), each owning a slice of the hidden units for all batch rows, its part
  of W_hh^T resident in shared memory where it fits (`grid_plan`); a step's
  values go through a double-buffered exchange buffer in L2, ordered by a
  step counter (release adds, acquire spins). The launch is cooperative: it
  is refused unless every block can be resident at once, which the spinning
  needs, and the wrapper then raises.
The plans are pure Python of the shape (and, for the grid, the card's SM
count and shared memory, which the wrappers read from the current device)
and the C entries take them as arguments. The
forwards write the five saved activations per step when a gradient is
needed; the backwards are the reverse recurrence over them.

The input projection x @ W_ih^T + b_ih stays one torch.matmul outside the
kernel, differentiated by autograd, and the recurrent weight and bias
gradients are products over all steps after the backward kernel, as the JAX
package leaves all three to XLA. On CPU tensors the wrappers run the plain
versions, `gru_over_nodes_plain` and `gru_scan_bwd_plain`; on CUDA tensors
they launch the kernels or raise.

The stretch path's segmented GRU (`gru_over_nodes_segmented`, hidden size H
decoupled from N) folds its segments into batch rows and runs the same
recurrence: the cluster kernel with N steps of a segment's length, which is
no longer the hidden size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

gru_over_nodes_plain = torch_impl.gru_over_nodes
gru_scan_bwd_plain = torch_impl.gru_scan_bwd

SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can have on sm_90
MAX_CLUSTER = 8           # blocks a cluster, the portable limit
ROWS = 4                  # batch rows a cluster (csrc/gru.cu kRows)
_UNITS_PER_WARP = 32 // ROWS
GRID_ROWS = 8             # batch rows of a warp's task in the grid kernels (kGridRows)
_GRID_UNITS = 32 // GRID_ROWS
_GRID_WARPS = 16          # kGridThreads / 32


class GruPlan(NamedTuple):
    """How a recurrence (forward or backward) of a (B, H) is laid over the card."""
    route: str        # "cluster" or "grid"
    rows: int         # batch rows a group (a cluster, or the grid's padded batch)
    groups: int       # batch groups: clusters, or 1 (grid)
    cluster: int      # blocks that share one recurrence (a cluster's, or the grid's),
                      # each with one slice of the hidden units
    slice: int        # hidden units a block (the last block's slice may be short)
    row_stride: int   # floats a row of the resident part of W_hh^T
    threads: int      # threads a block
    smem: int         # bytes of dynamic shared memory a block
    workspace: int = 0  # bytes of device workspace: the grid's step counter and
                        # exchange buffers
    ksplit: int = 1   # grid: k-splits of a warp's task, summed in order
    resident: bool = False  # grid: the slice of W_hh^T in shared memory (else from L2)
    chunk: int = 0    # grid: rows of a step's exchanged values copied to shared memory
                      # at a time (all of them where they fit)

    def slices(self, h: int):
        """[(first unit, one past the last)] of each block of a cluster."""
        return [(c * self.slice, min((c + 1) * self.slice, h))
                for c in range(self.cluster)]

    def batch_groups(self, b: int):
        """[(first row, one past the last)] of each group."""
        return [(g * self.rows, min((g + 1) * self.rows, b))
                for g in range(self.groups)]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _cluster_plan(b: int, h: int, cluster: int) -> GruPlan:
    units = _ceil_div(h, cluster)
    cluster = _ceil_div(h, units)  # no empty slice
    # an odd multiple of the units a warp holds: the weights a warp reads in
    # one instruction then fall in 32 different banks
    stride = _ceil_div(3 * units, _UNITS_PER_WARP) | 1
    hp = _ceil_div(h, ROWS) * ROWS
    return GruPlan(
        route="cluster", rows=ROWS, groups=_ceil_div(b, ROWS), cluster=cluster,
        slice=units, row_stride=stride * _UNITS_PER_WARP,
        threads=32 * _ceil_div(units, _UNITS_PER_WARP),
        smem=4 * (hp * stride * _UNITS_PER_WARP + 2 * hp * ROWS))


def _bwd_cluster_plan(b: int, h: int, cluster: int) -> GruPlan:
    units = _ceil_div(h, cluster)
    cluster = _ceil_div(h, units)
    c3 = _ceil_div(3 * h, ROWS) * ROWS  # the k-sum's length, padded to the k-parts
    # a resident row of W_hh^T ([3H] of one unit) padded to 4 (mod 32) floats:
    # the 8 units by 4 k-parts a warp reads then fall in 32 different banks
    stride = c3 + (4 - c3) % 32
    return GruPlan(
        route="cluster", rows=ROWS, groups=_ceil_div(b, ROWS), cluster=cluster,
        slice=units, row_stride=stride,
        threads=32 * _ceil_div(units, _UNITS_PER_WARP),
        # two mbarriers, the resident rows, dcat [2][c3][ROWS]
        smem=16 + 4 * (units * stride + 2 * c3 * ROWS))


def grid_plan(b: int, h: int, sms: int, smem_per_block: int,
              backward: bool = False) -> GruPlan:
    """The grid route's decomposition on a card of `sms` SMs whose blocks can
    have `smem_per_block` bytes of shared memory: P <= `sms` blocks (one an SM, all
    resident at once) of S = ceil(H / sms) hidden units each, all B rows a
    block (padded to 8). A warp's task is 4 units by 8 rows, split `ksplit`
    ways along the sum so that a block has up to 16 warps. Shared memory
    holds the next step's inputs and the k-splits' sums, the slice of W_hh^T
    where it fits (`resident`; the forward's [H][3S] gate columns, the
    backward's [S][3H] rows), and a step's exchanged values (the forward's h
    [H][Bp + 4], the backward's dcat [3H][Bp + 4]) in the fewest chunks of
    equal rows, a multiple of 8, that fit beside them (each chunk costs a
    barrier and a pass over the sums). The workspace is the step counter and
    the double-buffered exchange buffer. Raises where not even 8 rows of a
    step's values fit."""
    if b < 1 or h < 1 or sms < 1:
        raise ValueError(f"gru grid plan: batch {b}, hidden {h}, SMs {sms}")
    units = _ceil_div(h, sms)
    blocks = _ceil_div(h, units)
    bp = _ceil_div(b, GRID_ROWS) * GRID_ROWS
    k_len = 3 * h if backward else h  # the length of a step's sums
    tasks = _ceil_div(units, _GRID_UNITS) * (bp // GRID_ROWS)
    ksplit = max(1, min(_GRID_WARPS // tasks, _ceil_div(k_len, GRID_ROWS)))
    threads = 32 * min(_GRID_WARPS, tasks * ksplit)
    if backward:
        # a resident row of W_hh^T padded to 8 (mod 32) floats: a warp's 4
        # rows by 8 k-parts then fall in 32 different banks
        stride = k_len + (GRID_ROWS - k_len) % 32
        w_bytes = 4 * units * stride
        # sv and g of two steps, the k-splits' sums, dh and dh_total * z
        fixed = 4 * units * bp * (2 * 6 + ksplit + 2)
    else:
        # an odd multiple of the units a task holds (as the cluster route's)
        stride = (_ceil_div(3 * units, _GRID_UNITS) | 1) * _GRID_UNITS
        w_bytes = 4 * h * stride
        fixed = 4 * 3 * units * bp * (2 + ksplit)  # x_proj of two steps, the sums
    row_bytes = 4 * (bp + 4)  # a staged row of the exchanged values
    for resident in (True, False):
        fit = (smem_per_block - fixed - w_bytes * resident) // row_bytes // 8 * 8
        if fit >= 8:
            break
    else:
        raise ValueError(f"gru grid plan: batch {b}, hidden {h}: no 8 rows of a step's "
                         f"values fit beside {fixed} bytes in {smem_per_block}")
    chunk = _ceil_div(_ceil_div(k_len, _ceil_div(k_len, fit)), 8) * 8
    return GruPlan(route="grid", rows=bp, groups=1, cluster=blocks, slice=units,
                   row_stride=stride, threads=threads,
                   smem=fixed + w_bytes * resident + row_bytes * chunk,
                   workspace=16 + 4 * 2 * k_len * bp, ksplit=ksplit,
                   resident=resident, chunk=chunk)


def _first_fit(b: int, h: int, max_cluster: int, cluster_plan, other_plan):
    if b < 1 or h < 1:
        raise ValueError(f"gru plan: batch {b}, hidden {h}")
    for cluster in range(min(_ceil_div(h, 32), max_cluster), max_cluster + 1):
        plan = cluster_plan(b, h, cluster)
        if plan.smem <= SMEM_PER_BLOCK:
            return plan
    return other_plan(b, h)


def launch_plan(b: int, h: int, sms: int, smem_per_block: int,
                max_cluster: int = MAX_CLUSTER) -> GruPlan:
    """The forward's decomposition for batch b and hidden size h on a card of
    `sms` SMs whose blocks can have `smem_per_block` bytes of shared memory;
    needs no card.

    Cluster route: the smallest cluster of at most `max_cluster` blocks that
    gives a block at most 32 hidden units (one warp a scheduler) or, past
    that, the first whose slice of W_hh^T and h buffers fit a block's shared
    memory. Grid route (`grid_plan`): when none fits (at the portable limit
    of 8 blocks: H above 360)."""
    return _first_fit(b, h, max_cluster, _cluster_plan,
                      functools.partial(grid_plan, sms=sms, smem_per_block=smem_per_block))


def bwd_plan(b: int, h: int, sms: int, smem_per_block: int) -> GruPlan:
    """The backward's decomposition, by the forward's rule: the smallest
    cluster that gives a block at most 32 hidden units or, past that, the
    first whose resident rows of W_hh^T and dcat buffers fit; the grid route
    where none does (H above 360, as the forward)."""
    return _first_fit(b, h, MAX_CLUSTER, _bwd_cluster_plan,
                      functools.partial(grid_plan, sms=sms, smem_per_block=smem_per_block,
                                        backward=True))


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gru_fwd_cluster": [_P] * 5 + [_I] * 10 + [_P],
    "gru_bwd_cluster": [_P] * 4 + [_I] * 10 + [_P],
    "gru_fwd_grid": [_P] * 6 + [_I] * 11 + [_P],
    "gru_bwd_grid": [_P] * 5 + [_I] * 11 + [_P],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("gru"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _workspace(plan: GruPlan, like):
    """The plan's device workspace (None where it needs none)."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace // 4, dtype=torch.float32, device=like.device)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_fwd(x_proj, w_hh_t, b_hh, save: bool, plan: GruPlan | None = None):
    """x_proj [N, B, 3H], w_hh_t [H, 3H], b_hh [3H] -> (out [B, N, H],
    saved [N, 5, B, H] or None), by the route of `plan` (`launch_plan` of the
    shape on this card unless given)."""
    _build.require_cuda("gru_over_nodes", x_proj, w_hh_t, b_hh)
    n, b, h3 = x_proj.shape
    h = w_hh_t.shape[0]
    if w_hh_t.shape != (h, h3) or h3 != 3 * h or b_hh.shape != (h3,):
        raise ValueError(
            f"gru_over_nodes: x_proj {tuple(x_proj.shape)}, w_hh_t "
            f"{tuple(w_hh_t.shape)}, b_hh {tuple(b_hh.shape)}")
    plan = plan or launch_plan(b, h, *_build.card_limits(x_proj.device))
    out = torch.empty((b, n, h), dtype=torch.float32, device=x_proj.device)
    saved = (torch.empty((n, 5, b, h), dtype=torch.float32, device=x_proj.device)
             if save else None)
    ptrs = (x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            _ptr(saved))
    stream = _build.stream_ptr(x_proj)
    if plan.route == "cluster":
        rc = _fn("gru_fwd_cluster")(
            *ptrs, n, b, h, plan.rows, plan.groups, plan.cluster, plan.slice,
            plan.row_stride, plan.threads, plan.smem, stream)
        counter = gru_over_nodes
    else:
        ws = _workspace(plan, x_proj)
        rc = _fn("gru_fwd_grid")(
            *ptrs, _ptr(ws), n, b, h, plan.cluster, plan.slice, plan.ksplit,
            plan.row_stride, plan.threads, plan.smem, plan.resident, plan.chunk, stream)
        counter = gru_fwd_grid
    _build.check(rc, f"gru_over_nodes ({plan.route})")
    counter.launches += 1
    return out, saved


def gru_fwd_grid(x_proj, w_hh_t, b_hh, save: bool = False):
    """The recurrence through the grid kernel whatever the shape: what
    `gru_over_nodes` launches for a hidden size that fits no cluster."""
    plan = grid_plan(x_proj.shape[1], w_hh_t.shape[0], *_build.card_limits(x_proj.device))
    return _launch_fwd(x_proj, w_hh_t, b_hh, save, plan)


gru_fwd_grid.launches = 0


def _launch_bwd(saved, g, a_all, plan: GruPlan | None = None):
    """saved [N, 5, B, H], g [B, N, H], a_all [H, 3H] -> dxp [N, B, 3H], by
    the route of `plan` (`bwd_plan` of the shape on this card unless given).
    Both routes read their rows of a_all as they are."""
    _build.require_cuda("gru_scan_bwd", saved, g, a_all)
    n, five, b, h = saved.shape
    if five != 5 or g.shape != (b, n, h) or a_all.shape != (h, 3 * h):
        raise ValueError(
            f"gru_scan_bwd: saved {tuple(saved.shape)}, g {tuple(g.shape)}, "
            f"a_all {tuple(a_all.shape)}")
    plan = plan or bwd_plan(b, h, *_build.card_limits(saved.device))
    dxp = torch.empty((n, b, 3 * h), dtype=torch.float32, device=saved.device)
    ptrs = (saved.data_ptr(), g.data_ptr(), a_all.data_ptr(), dxp.data_ptr())
    stream = _build.stream_ptr(saved)
    if plan.route == "cluster":
        rc = _fn("gru_bwd_cluster")(
            *ptrs, n, b, h, plan.rows, plan.groups, plan.cluster, plan.slice,
            plan.row_stride, plan.threads, plan.smem, stream)
        counter = gru_scan_bwd
    else:
        ws = _workspace(plan, saved)
        rc = _fn("gru_bwd_grid")(
            *ptrs, _ptr(ws), n, b, h, plan.cluster, plan.slice, plan.ksplit,
            plan.row_stride, plan.threads, plan.smem, plan.resident, plan.chunk, stream)
        counter = gru_bwd_grid
    _build.check(rc, f"gru_scan_bwd ({plan.route})")
    counter.launches += 1
    return dxp


def gru_scan_bwd(saved, g, a_all):
    """saved [N, 5, B, H], g [B, N, H], a_all [H, 3H] -> dxp [N, B, 3H]."""
    if saved.device.type == "cpu":
        return gru_scan_bwd_plain(saved, g, a_all)
    return _launch_bwd(saved, g, a_all)


gru_scan_bwd.launches = 0  # the cluster kernel's


def gru_bwd_grid(saved, g, a_all):
    """The backward through the grid kernel whatever the shape: what
    `gru_scan_bwd` launches for a hidden size that fits no cluster."""
    plan = grid_plan(saved.shape[2], saved.shape[3], *_build.card_limits(saved.device),
                     backward=True)
    return _launch_bwd(saved, g, a_all, plan)


gru_bwd_grid.launches = 0


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


gru_over_nodes.launches = 0  # the cluster kernel's


def fold_segments(x, seg: int):
    """x [B, W, N] -> [S * B, W, seg]: the node axis cut into S = ceil(N / seg)
    segments of seg nodes, the last padded with zeros, each segment a batch
    row of its own, row s * B + b (stemgnn_tpu/models/stemgnn.py:222-230)."""
    b, w, n = x.shape
    s = -(-n // seg)
    if s * seg != n:
        x = F.pad(x, (0, s * seg - n))
    return x.reshape(b, w, s, seg).permute(2, 0, 1, 3).reshape(s * b, w, seg)


def unfold_segments(out, b: int, n: int):
    """[S * B, seg, H] -> [B, N, H]: a recurrence's output over folded
    segments put back on the node axis, the padding dropped
    (stemgnn.py:245-246)."""
    sb, seg, h = out.shape
    s = sb // b
    return out.reshape(s, b, seg, h).permute(1, 0, 2, 3).reshape(b, s * seg, h)[:, :n]


def gru_over_nodes_segmented(gru, x, seg_len: int = 0):
    """The stretch path's GRU (stemgnn_tpu/models/stemgnn.py
    `gru_over_nodes_segmented`): x [B, W, N] -> enc [B, N, H], H the GRU's own
    hidden size, the node sequence run as independent segments of `seg_len`
    nodes (0: one segment of N), each from h0 = 0. The segments are folded
    into batch rows (`fold_segments`) and go through `gru_over_nodes`: one
    launch of the recurrence of seg_len steps over S * B rows on CUDA
    tensors, the plain recurrence on CPU tensors."""
    b, _, n = x.shape
    seg = seg_len if seg_len > 0 else n
    return unfold_segments(gru_over_nodes(gru, fold_segments(x, seg)), b, n)
