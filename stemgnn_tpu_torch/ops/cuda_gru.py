"""GRU over the node axis, x [B, W, N] -> [B, N_seq, H].

Kernels: csrc/gru.cu, the port of stemgnn_tpu/ops/pallas_gru.py
`_fwd_kernel` and `_bwd_kernel`.

Both recurrences run across SMs (`gru_fwd_cluster`, `gru_bwd_cluster`):
groups of 4 batch rows are independent thread-block clusters, and inside a
cluster each block owns a slice of the hidden units with its part of
W_hh^T resident in shared memory for all N steps (the forward: the slice's
three gate columns; the backward: the slice's rows). The blocks send each
other what the next step needs (the forward h', the backward the gate
gradients) through distributed shared memory and wait on an mbarrier of
their own for a step's values, with no cluster-wide barrier in the loop.
`launch_plan` and `bwd_plan` make the decompositions from (B, H) alone and
the C entries take them as arguments. Where a slice does not fit a block's
shared memory at the largest cluster size (H above 360), the wrappers launch
the one-block kernels instead (`gru_fwd_one_block`, `gru_bwd_one_block`: a
block per group of 8 batch rows, W_hh^T read from L2), by shape; their
group buffers go to a device workspace where they outgrow a block's shared
memory (H above 2421 in the forward, 1210 in the backward). The
forwards write the five saved activations per step when a gradient is
needed; the backwards are the reverse recurrence over them.

The input projection x @ W_ih^T + b_ih stays one torch.matmul outside the
kernel, differentiated by autograd, and the recurrent weight and bias
gradients are products over all steps after the backward kernel, as the JAX
package leaves all three to XLA. On CPU tensors the wrappers run the plain
versions, `gru_over_nodes_plain` and `gru_scan_bwd_plain`; on CUDA tensors
they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

gru_over_nodes_plain = torch_impl.gru_over_nodes
gru_scan_bwd_plain = torch_impl.gru_scan_bwd

SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can have on sm_90
MAX_CLUSTER = 8           # blocks a cluster, the portable limit
ROWS = 4                  # batch rows a cluster (csrc/gru.cu kRows)
_UNITS_PER_WARP = 32 // ROWS
_ONE_BLOCK_ROWS, _ONE_BLOCK_PAD = 8, 4  # csrc/gru.cu kBSub, kPad


class GruPlan(NamedTuple):
    """How a recurrence (forward or backward) of a (B, H) is laid over the card."""
    route: str        # "cluster" or "one_block"
    rows: int         # batch rows a group (a cluster, or a block of the one-block route)
    groups: int       # batch groups: clusters, or blocks of the one-block route
    cluster: int      # blocks a cluster, each with one slice of the hidden units
    slice: int        # hidden units a block (the last block's slice may be short)
    row_stride: int   # floats a row of the resident part of W_hh^T
    threads: int      # threads a block
    smem: int         # bytes of dynamic shared memory a block
    workspace: int = 0  # bytes of device workspace for the groups' buffers (one-block route)

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


def _first_fit(b: int, h: int, max_cluster: int, cluster_plan, one_block_plan):
    if b < 1 or h < 1:
        raise ValueError(f"gru plan: batch {b}, hidden {h}")
    for cluster in range(min(_ceil_div(h, 32), max_cluster), max_cluster + 1):
        plan = cluster_plan(b, h, cluster)
        if plan.smem <= SMEM_PER_BLOCK:
            return plan
    return one_block_plan(b, h)


def launch_plan(b: int, h: int, max_cluster: int = MAX_CLUSTER) -> GruPlan:
    """The forward's decomposition for batch b and hidden size h; needs no card.

    Cluster route: the smallest cluster of at most `max_cluster` blocks that
    gives a block at most 32 hidden units (one warp a scheduler) or, past
    that, the first whose slice of W_hh^T and h buffers fit a block's shared
    memory. One-block route: when none fits (at the portable limit of 8 blocks:
    H above 360), a block per group of 8 batch rows."""
    return _first_fit(b, h, max_cluster, _cluster_plan, one_block_plan)


def bwd_plan(b: int, h: int) -> GruPlan:
    """The backward's decomposition, by the forward's rule: the smallest
    cluster that gives a block at most 32 hidden units or, past that, the
    first whose resident rows of W_hh^T and dcat buffers fit; the one-block
    route where none does (H above 360, as the forward)."""
    return _first_fit(b, h, MAX_CLUSTER, _bwd_cluster_plan,
                      functools.partial(one_block_plan, backward=True))


def one_block_plan(b: int, h: int, backward: bool = False,
                   in_workspace: bool | None = None) -> GruPlan:
    """A block per group of 8 batch rows (one thread's rows): the smallest
    group, so the most SMs. Its h (forward) or dh and dcat (backward) buffers,
    [H][8 + 4] floats each, sit in shared memory where they fit (up to
    H = 2421 forward, 1210 backward) and else in the group's slice of a
    device workspace (`smem` 0, `workspace` bytes for all groups): the same
    arithmetic. `in_workspace` forces either place (the workspace at any H);
    None chooses by fit."""
    if b < 1 or h < 1:
        raise ValueError(f"gru plan: batch {b}, hidden {h}")
    rows = _ONE_BLOCK_ROWS
    groups = _ceil_div(b, rows)
    buffers = 4 * (4 if backward else 2) * h * (rows + _ONE_BLOCK_PAD)
    if in_workspace is None:
        in_workspace = buffers > SMEM_PER_BLOCK
    return GruPlan(route="one_block", rows=rows, groups=groups, cluster=1,
                   slice=h, row_stride=3 * h, threads=min(1024, _ceil_div(h, 32) * 32),
                   smem=0 if in_workspace else buffers,
                   workspace=groups * buffers if in_workspace else 0)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "gru_fwd_cluster": [_P] * 5 + [_I] * 10 + [_P],
    "gru_fwd_one_block": [_P] * 6 + [_I] * 7 + [_P],
    "gru_bwd_cluster": [_P] * 4 + [_I] * 10 + [_P],
    "gru_bwd_one_block": [_P] * 5 + [_I] * 7 + [_P],
}


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("gru"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _workspace(plan: GruPlan, like):
    """The one-block route's device workspace (None where its buffers sit in
    shared memory)."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace // 4, dtype=torch.float32, device=like.device)


def _launch_fwd(x_proj, w_hh_t, b_hh, save: bool, plan: GruPlan | None = None):
    """x_proj [N, B, 3H], w_hh_t [H, 3H], b_hh [3H] -> (out [B, N, H],
    saved [N, 5, B, H] or None), by the route of `plan` (`launch_plan` of the
    shape unless given)."""
    _build.require_cuda("gru_over_nodes", x_proj, w_hh_t, b_hh)
    n, b, h3 = x_proj.shape
    h = w_hh_t.shape[0]
    if w_hh_t.shape != (h, h3) or h3 != 3 * h or b_hh.shape != (h3,):
        raise ValueError(
            f"gru_over_nodes: x_proj {tuple(x_proj.shape)}, w_hh_t "
            f"{tuple(w_hh_t.shape)}, b_hh {tuple(b_hh.shape)}")
    plan = plan or launch_plan(b, h)
    out = torch.empty((b, n, h), dtype=torch.float32, device=x_proj.device)
    saved = (torch.empty((n, 5, b, h), dtype=torch.float32, device=x_proj.device)
             if save else None)
    ptrs = (x_proj.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            saved.data_ptr() if save else None)
    if plan.route == "cluster":
        rc = _fn("gru_fwd_cluster")(
            *ptrs, n, b, h, plan.rows, plan.groups, plan.cluster, plan.slice,
            plan.row_stride, plan.threads, plan.smem, _build.stream_ptr(x_proj))
        counter = gru_over_nodes
    else:
        ws = _workspace(plan, x_proj)
        rc = _fn("gru_fwd_one_block")(*ptrs, ws.data_ptr() if ws is not None else None,
                                      n, b, h, plan.rows, plan.groups, plan.threads,
                                      plan.smem, _build.stream_ptr(x_proj))
        counter = gru_fwd_one_block
    _build.check(rc, f"gru_over_nodes ({plan.route})")
    counter.launches += 1
    return out, saved


def gru_fwd_one_block(x_proj, w_hh_t, b_hh, save: bool = False,
                      in_workspace: bool | None = None):
    """The recurrence through the one-block kernel whatever the shape: what
    `gru_over_nodes` launches for a hidden size that fits no cluster
    (`in_workspace`: as `one_block_plan`)."""
    b, h = x_proj.shape[1], w_hh_t.shape[0]
    return _launch_fwd(x_proj, w_hh_t, b_hh, save,
                       one_block_plan(b, h, in_workspace=in_workspace))


gru_fwd_one_block.launches = 0


def _launch_bwd(saved, g, a_all, plan: GruPlan | None = None):
    """saved [N, 5, B, H], g [B, N, H], a_all [H, 3H] -> dxp [N, B, 3H], by
    the route of `plan` (`bwd_plan` of the shape unless given)."""
    _build.require_cuda("gru_scan_bwd", saved, g, a_all)
    n, five, b, h = saved.shape
    if five != 5 or g.shape != (b, n, h) or a_all.shape != (h, 3 * h):
        raise ValueError(
            f"gru_scan_bwd: saved {tuple(saved.shape)}, g {tuple(g.shape)}, "
            f"a_all {tuple(a_all.shape)}")
    plan = plan or bwd_plan(b, h)
    dxp = torch.empty((n, b, 3 * h), dtype=torch.float32, device=saved.device)
    if plan.route == "cluster":  # reads its rows of a_all as they are
        rc = _fn("gru_bwd_cluster")(
            saved.data_ptr(), g.data_ptr(), a_all.data_ptr(), dxp.data_ptr(), n, b, h,
            plan.rows, plan.groups, plan.cluster, plan.slice, plan.row_stride,
            plan.threads, plan.smem, _build.stream_ptr(saved))
        counter = gru_scan_bwd
    else:
        a_t = a_all.t().contiguous()  # [3H, H], what the one-block kernel reads along rows
        ws = _workspace(plan, saved)
        rc = _fn("gru_bwd_one_block")(
            saved.data_ptr(), g.data_ptr(), a_t.data_ptr(), dxp.data_ptr(),
            ws.data_ptr() if ws is not None else None, n, b, h, plan.rows, plan.groups,
            plan.threads, plan.smem, _build.stream_ptr(saved))
        counter = gru_bwd_one_block
    _build.check(rc, f"gru_scan_bwd ({plan.route})")
    counter.launches += 1
    return dxp


def gru_scan_bwd(saved, g, a_all):
    """saved [N, 5, B, H], g [B, N, H], a_all [H, 3H] -> dxp [N, B, 3H]."""
    if saved.device.type == "cpu":
        return gru_scan_bwd_plain(saved, g, a_all)
    return _launch_bwd(saved, g, a_all)


gru_scan_bwd.launches = 0  # the cluster kernel's


def gru_bwd_one_block(saved, g, a_all, in_workspace: bool | None = None):
    """The backward through the one-block kernel whatever the shape: what
    `gru_scan_bwd` launches for a hidden size that fits no cluster
    (`in_workspace`: as `one_block_plan`)."""
    b, h = saved.shape[2], saved.shape[3]
    return _launch_bwd(saved, g, a_all,
                       one_block_plan(b, h, backward=True, in_workspace=in_workspace))


gru_bwd_one_block.launches = 0


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
