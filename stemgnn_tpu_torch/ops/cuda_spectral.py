"""Spectral-sequential cell, [B,K,N,W] -> [B,K,N,W*multi].

Kernels: csrc/spectral.cu, the port of stemgnn_tpu/ops/pallas_spectral.py
`_kernel`, `_bwd_kernel`, `_kernel_save` and `_bwd_kernel_reread`. The
forward is a row map over the B*N rows in which the window is so short
(W = 12) that the FFT is a product with a DFT matrix. The forward DFT is
folded into the layer-0 GLU weights here, outside the kernel, in f32
torch.matmul (four [K*W, K*W] x [K*W, K*Wm] products, as the JAX package's
`_forward` does); the kernel runs the six GLUs and the inverse DFT, one
[Wm, Wm] block of it per order. The backward recomputes the activations
from x and the folded weights and returns dx and the 24 weight and bias
gradients, those of layer 0 in folded space; the unfold dW = Cf^T @ dAW is
again torch.matmul out here, as the JAX package's `_backward` has it.

With the module switch `SAVE_ACTS_BWD` on (read at each call), a forward that
autograd records launches the saving forward instead, which also writes (a, s)
of the six GLUs (12 arrays [padded rows, K*Wm], held until the backward), and
the backward launches the reread entry on them instead of recomputing the
chain. Both backwards give the same bits. A captured CUDA graph keeps the
pair its capture launched, whatever the switch says at a replay. The switch
is on by default: on the H100 the pair is the faster one in the train step
(PERF.md has the A/B); the JAX package, on its TPU, keeps it off.

The second switch, `SAVE_ACTS_F32` (also read when the forward runs, as the
JAX package's pallas_spectral.py reads its own), picks the storage of those
12 arrays at compute_dtype "bfloat16": on (the default, as in the JAX
package), f32, and the reread gradients are bitwise the recompute's; off,
bf16 (the JAX package's `act_dtype = compute_dtype`), half the bytes, and the
reread backward takes the rounded a and s, so its gradients move by bf16
ulps. That is the bf16-storage arm: `spe_seq_cell_save(..., act_dtype=
"bfloat16")` and the reread entry on bf16 acts, counted apart
(`spe_seq_cell_save_bf16acts`, `spe_seq_cell_bwd_reread_bf16acts`). At f32
the arrays are f32 either way.

Every entry takes `compute_dtype`, the JAX package's precision policy. At
"bfloat16" the wrappers fold the DFT in f32 and then cast x, the 2-D GLU
weights and the inverse DFT's block to bf16, as `_forward` and `_backward`
cast them before their kernels, and launch the kernels' bf16 arms; biases,
outputs and the 12 saved arrays stay f32 (the arrays bf16 with
`SAVE_ACTS_F32` off, above). A backward's cotangent goes to the
kernels as f32, which round it to bf16 as they stage it (the same bits as a
cast). Up to D1 = 2048 the bf16 forwards run on tensor cores (mma.sync) by
the tile plan `fwd_mma_plan`, and the bf16 backwards on Hopper's route
(TMA bulk copies feeding mma.sync and wgmma) by `bwd_tc_plan` (the
recompute backward's chain by the former); past it on the wide scalar
kernels. Each bf16 arm counts its launches on a function of its own
(`spe_seq_cell_bf16` and the like), so the counts tell the arms apart.

On CPU tensors the wrappers run the plain versions (`spe_seq_cell_plain`, a
full FFT at f32, `spe_seq_cell_bwd_plain`, `spe_seq_cell_save_plain`,
`spe_seq_cell_bwd_reread_plain`, each with the same compute_dtype); on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from stemgnn_tpu_torch.ops import _build, torch_impl

spe_seq_cell_plain = torch_impl.spe_seq_cell
spe_seq_cell_bwd_plain = torch_impl.spe_seq_cell_bwd
spe_seq_cell_save_plain = torch_impl.spe_seq_cell_save
spe_seq_cell_bwd_reread_plain = torch_impl.spe_seq_cell_bwd_reread

# True: under autograd the forward saves each GLU's (a, s) and the backward
# rereads them; False: the backward recomputes the chain. Read when the
# forward runs.
SAVE_ACTS_BWD = True
# True: the saved (a, s) are f32 (reread gradients bitwise the recompute's);
# False: at compute_dtype "bfloat16" they are stored as bf16 (half the
# bytes, bf16-ulp gradient drift), as pallas_spectral.py's switch of the same
# name. Read when the forward runs.
SAVE_ACTS_F32 = True


@functools.lru_cache(maxsize=16)
def _dft_on(w: int, k: int, wm: int, device: torch.device, dtype=torch.float32):
    """Block-diagonal Cf, Sf for the fold (float32), and one [wm, wm] block of
    Ci, Si for the kernel (every order's block is the same) in `dtype`, the
    kernel's operand type, on `device`."""
    cf, sf, ci, si = torch_impl._dft_tensors(w, k, wm, device, torch.float32)
    return (cf, sf, ci[:wm, :wm].contiguous().to(dtype),
            si[:wm, :wm].contiguous().to(dtype))


def _aligned(t):
    """t contiguous and 16-byte aligned (the kernels read weights as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def folded_weights(glu_params, cf, sf, dtype=torch.float32):
    """The 24 GLU tensors in kernel order (wl, bl, wr, br per GLU), with
    the forward DFT folded into GLU 0 (real chain, Cf) and GLU 1 (imag
    chain, Sf): (x @ C) @ W == x @ (C @ W), no bias on the DFT. The fold is
    f32; then the 2-D weights are cast to `dtype`, the kernel's operand type
    (the biases stay f32): for bf16 as one cast of the twelve laid end to end
    (each a 32-byte-aligned view), not a cast kernel each."""
    two_d = []
    for i, p in enumerate(glu_params):
        wl, wr = p["left"]["w"], p["right"]["w"]
        if i < 2:
            dft = cf if i == 0 else sf
            wl, wr = torch.matmul(dft, wl), torch.matmul(dft, wr)
        two_d += [wl, wr]
    if dtype != torch.float32:
        flat = torch.cat([t.reshape(-1) for t in two_d]).to(dtype)
        views, off = [], 0
        for t in two_d:  # sizes K*W*D1 or D1*D1: multiples of 16 elements
            views.append(flat[off: off + t.numel()].view(t.shape))
            off += t.numel()
        two_d = views
    out = []
    for p, wl, wr in zip(glu_params, two_d[0::2], two_d[1::2]):
        out.extend(_aligned(t) for t in (wl, p["left"]["b"], wr, p["right"]["b"]))
    return out


def _card_operands(x, glu_params, multi: int, compute_dtype: str):
    """(x, the 24 folded GLU tensors, ci, si) as the kernels of `compute_dtype`
    read them, on x's card."""
    b, k, n, w = x.shape
    dtype = torch_impl.operand_dtype(compute_dtype)
    cf, sf, ci, si = _dft_on(w, k, w * multi, x.device, dtype)
    return x.to(dtype), folded_weights(glu_params, cf, sf, dtype), ci, si


_P, _I = ctypes.c_void_p, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "spectral_fwd": ([_P, _PP, _P, _P, _P, _P] + [_I] * 5 + [_P], ctypes.c_int),
    "spectral_fwd_save": ([_P, _PP, _P, _P, _P, _P, _P] + [_I] * 5 + [_P], ctypes.c_int),
    "spectral_act_floats": ([_I] * 4, ctypes.c_longlong),
    "spectral_fwd_workspace_floats": ([_I] * 4, ctypes.c_longlong),
    "spectral_bwd": ([_P, _P, _PP] + [_P] * 5 + [_I] * 6 + [_P], ctypes.c_int),
    "spectral_bwd_reread": ([_P, _P, _PP] + [_P] * 6 + [_I] * 6 + [_P], ctypes.c_int),
    # the bf16 forwards: the same, and fwd_mma_plan's tile rows, n8 tiles a
    # warp, threads, panel rows and stages
    "spectral_fwd_bf16": ([_P, _PP, _P, _P, _P, _P] + [_I] * 10 + [_P], ctypes.c_int),
    "spectral_fwd_save_bf16": ([_P, _PP, _P, _P, _P, _P, _P] + [_I] * 10 + [_P],
                               ctypes.c_int),
    # the same writing bf16 acts (the bf16-storage arm), and whether its
    # plan stages them for bulk stores
    "spectral_fwd_save_bf16acts": ([_P, _PP, _P, _P, _P, _P, _P] + [_I] * 11 + [_P],
                                   ctypes.c_int),
    "spectral_fwd_bf16_smem": ([_I] * 7, ctypes.c_int),
    "spectral_fwd_save_bf16acts_smem": ([_I] * 8, ctypes.c_int),
    # the bf16 backwards: g f32, the wide route's row segments and
    # bwd_tc_plan's seven (the recompute also fwd_mma_plan's five)
    "spectral_bwd_bf16": ([_P, _P, _PP] + [_P] * 5 + [_I] * 18 + [_P], ctypes.c_int),
    "spectral_bwd_reread_bf16": ([_P, _P, _PP] + [_P] * 6 + [_I] * 13 + [_P],
                                 ctypes.c_int),
    "spectral_bwd_reread_bf16acts": ([_P, _P, _PP] + [_P] * 6 + [_I] * 13 + [_P],
                                     ctypes.c_int),
    "spectral_bwd_grad_floats": ([_I] * 3, ctypes.c_longlong),
    "spectral_bwd_workspace_floats": ([_I] * 6, ctypes.c_longlong),
    "spectral_bwd_reread_workspace_floats": ([_I] * 6, ctypes.c_longlong),
    "spectral_bwd_bf16_workspace_floats": ([_I] * 13, ctypes.c_longlong),
    "spectral_bwd_reread_bf16_workspace_floats": ([_I] * 13, ctypes.c_longlong),
    "spectral_bwd_bf16_smem": ([_I] * 13, ctypes.c_longlong),
}
# row segments whose partial weight gradients are summed in order: 12 puts
# the 22 weight-gradient tiles of the flagship shapes on 264 blocks, two an SM
N_SPLIT = 12

# The bf16 backward on Hopper (csrc/spectral.cu `bwd_tc_launch`): its
# constants, which the plan below mirrors.
MMA_MAX_D1 = 2048        # kMmaMaxD1: past it the wide scalar kernels
# n8 tiles a warp, the order tried -> the most 16-row m tiles a rows block, its
# most consumer warps (a producer warp beside them: 256 threads at most for 4
# and 5 tiles, so 255 registers a thread)
TC_MAX_MT = {4: 5, 5: 5, 8: 2, 16: 1, 32: 1}
TC_MAX_WARPS = {4: 7, 5: 7, 8: 15, 16: 15, 32: 11}
TC_BAR_BYTES = 1024                   # kTcBarBytes: the mbarriers of a block
TC_MAX_RING = (TC_BAR_BYTES // 8 - 4) // 2  # kTcMaxRing: weight items in a rows block's ring
TC_STAGE_ITEM = ((1, 4), (1, 2), (0, 4), (0, 2), (1, 1), (0, 1))  # (stage a, s; k16 steps an item)
TR = 64                               # kTR: rows of a chunk of the transposed planes
WG_M, WG_N = 128, 128                 # kWgM, kWgN: features and columns of a gradient block
WG_MAX_CLUSTER = 8                    # kWgMaxCluster: its row segments, a cluster


class BwdTcPlan(NamedTuple):
    """How the bf16 backward of one shape is laid over the card."""
    route: str          # "tc", or "wide" past D1 = MMA_MAX_D1 (the rest then 0)
    rows_pad: int       # B*N padded to 16, the saved arrays' rows
    rows64: int         # B*N padded to 64: the transposed planes' rows, the rows kernel's
    m_tiles: int        # the most 16-row m tiles a rows block has (its range's)
    n_tiles: int        # n8 column tiles a warp of it owns
    warps: int          # its consumer warps (a warp per n_tiles of D1)
    threads: int        # its block: the consumer warps and the producer warp
    stride: int         # bf16 elements between two rows of its da, ds buffers
    item_steps: int     # k16 steps of a weight item (n_tiles n8 tiles of one warp)
    items: int          # weight items of a chain's stream
    ring: int           # weight items in its shared ring: ring / warps slots a warp
    stage_acts: int     # 1: a, s of each m tile come into shared memory by bulk copies
    smem: int           # bytes of its dynamic shared memory
    clusters: int       # row ranges, a cluster of 2 blocks (the chains) each: 2 * clusters blocks
    nseg: int           # row segments of the weight gradients, the blocks of a cluster
    wgrad_units: int    # weight-gradient blocks a segment: (GLU, 128 features, 128 columns)
    chunks: int         # 64-row chunks of the transposed planes
    workspace_floats: int  # the reread entry's scratch (the recompute adds 12 planes)

    @property
    def args(self) -> tuple:
        """What the C entries take of it."""
        return (self.m_tiles, self.n_tiles, self.item_steps, self.ring, self.stage_acts,
                self.clusters, self.nseg)


# The bf16 chain forward on tensor cores (csrc/spectral.cu `chain_mma_launch`):
# its constants, which fwd_mma_plan mirrors. (16-row tiles, n8 tiles a warp)
# instantiated, in the order preferred on a tie, and each one's launch bound.
FWD_MMA_TILES = ((5, 3), (2, 4), (1, 4))
FWD_MMA_MAX_THREADS = {5: 320, 2: 512, 1: 512}  # chain_mma_bound
FWD_MMA_PANEL_K = (64, 48, 32, 16)  # k rows a weight panel, the deepest that fits first
FWD_MMA_STAGES = (4, 3, 2)          # panel stages, then the most that fit
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block can have on sm_90 (kSmemPerBlock)


class FwdMmaPlan(NamedTuple):
    """How the bf16 chain forward of one shape is laid over the card."""
    route: str          # "mma", or "wide" past D1 = MMA_MAX_D1 (the rest then 0)
    rows_pad: int       # B*N padded to 16, the saved arrays' rows
    tile_rows: int      # rows of a block: 16 m_tiles
    n_tiles: int        # n8 column tiles a warp owns in a pass (both sums of each)
    threads: int        # a block: a warp per n_tiles of a pass's columns
    passes: int         # column passes over D1 of threads / 32 * n_tiles * 8 columns
    stride: int         # bf16 elements between two rows of its activation buffers
    panel_stride: int   # the same for its weight panels
    panel_k: int        # k rows of a weight panel (the products between two barriers)
    stages: int         # weight panels in its shared ring
    smem: int           # bytes of its dynamic shared memory
    tiles: int          # row tiles: its grid is 2 * tiles blocks along x
    stage_acts: int = 0  # the bf16-storage saving forward: its planes staged for bulk stores

    @property
    def args(self) -> tuple:
        """What the C entries take of it (the bf16-storage saving forward also
        stage_acts)."""
        return self.tile_rows, self.n_tiles, self.threads, self.panel_k, self.stages


def _ldsm_stride(cols: int) -> int:
    """csrc/spectral.cu `ldsm_stride`: cols rounded to 16, in bytes 16 past a
    multiple of 128 (the 8 rows of an ldmatrix on distinct banks)."""
    return (-(-cols // 16) * 16 + 55) // 64 * 64 + 8


def fwd_mma_plan(b: int, k: int, n: int, w: int, wm: int, sms: int,
                 acts_bf16: bool = False) -> FwdMmaPlan:
    """The bf16 chain forward's tiling for x [b, k, n, w] at wm = w * multi on
    a card of `sms` SMs; pure arithmetic, no card. Of the instantiated (row
    tile, n8 tiles a warp) whose block fits a block's shared memory with two
    stages of 16-row panels at least, the one whose blocks (two a tile) put
    the fewest rows on the busiest SM, the larger tile on a tie (its weight
    panels serve more rows); its columns in as few passes as its launch
    bound allows, the warps spread evenly over them; then the deepest weight
    panels (up to 64 k rows: fewer barriers a GLU) and as many stages (up to
    4) as fit. With `acts_bf16` (the bf16-storage saving forward) a tile's
    bf16 a and s (4 tm D1 bytes) are staged for bulk stores where they fit
    beside the rest (stage_acts 1), else stored by the lanes."""
    d1 = k * wm
    rows_pad = -(-(b * n) // 16) * 16
    if d1 > MMA_MAX_D1:
        return FwdMmaPlan("wide", rows_pad, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    col_tiles = -(-d1 // 8)
    best = None
    for mt, nt in FWD_MMA_TILES:
        tm = 16 * mt
        passes = -(-col_tiles // (FWD_MMA_MAX_THREADS[mt] // 32 * nt))
        warps = -(-col_tiles // (passes * nt))
        pw = warps * nt * 8
        stride, panel_stride = _ldsm_stride(d1), _ldsm_stride(pw)
        fits = []
        for staging in ((4 * tm * d1, 0) if acts_bf16 else (0,)):
            fits = [(panel_k, stages, staging, staging + (
                2 * tm * stride + stages * 2 * panel_k * panel_stride) * 2)
                for panel_k in FWD_MMA_PANEL_K for stages in FWD_MMA_STAGES]
            fits = [f for f in fits if f[3] <= SMEM_PER_BLOCK]
            if fits:
                break
        if not fits:
            continue
        panel_k, stages, staging, smem = fits[0]
        tiles = -(-rows_pad // tm)
        key = (-(-2 * tiles // sms) * tm, -tm)
        if best is None or key < best[0]:
            best = (key, FwdMmaPlan("mma", rows_pad, tm, nt, 32 * warps, passes, stride,
                                    panel_stride, panel_k, stages, smem, tiles,
                                    int(staging > 0)))
    return best[1]


def _tc_stream(d0: int, d1: int, nt: int, p: int) -> tuple:
    """csrc/spectral.cu `tc_stream`: (the inverse DFT's k16 steps and item
    groups, a GLU product's k16 steps and item groups, warps, layer-0 warps,
    layer-0 n8 tiles a warp, items) of a chain's stream, items of p k16
    steps by nt n8 tiles: the inverse DFT, then layers 2, 1, 0."""
    isteps = -(-d1 // 16)
    steps = 2 * isteps
    ichunks, chunks = -(-isteps // p), -(-steps // p)
    ct, ct0 = -(-d1 // 8), -(-d0 // 8)
    warps = -(-ct // nt)
    nt0 = -(-ct0 // warps)
    w0 = -(-ct0 // nt0)
    items = ichunks * warps + chunks * (2 * warps + w0)
    return isteps, ichunks, steps, chunks, warps, w0, nt0, items


def bwd_tc_plan(b: int, k: int, n: int, w: int, wm: int, sms: int,
                act_bytes: int = 4) -> BwdTcPlan:
    """The bf16 backward's tiling for x [b, k, n, w] at wm = w * multi on a card
    of `sms` SMs, with saved planes of `act_bytes` an element (4: f32, and the
    recompute's; 2: the bf16-storage arm); pure arithmetic, no card. The rows
    kernel takes the fewest n8 tiles a warp (4, 5, 8, 16 or 32) whose warps
    hold D1; its row ranges (a cluster of the two chains' blocks each) are
    half the SMs where the 16-row m tiles allow (every SM busy), more where a
    block would need more m tiles than its accumulators hold; then the first
    of TC_STAGE_ITEM (a, s staged in
    shared memory, k16 steps a weight item) that leaves a ring of two items
    a warp or more (up to four) beside the rest, or else one. The weight gradients
    take the most row segments, a power of 2 up to 8 (a cluster: a GPC's 16
    or 18 SMs hold whole ones), that keep one block an SM."""
    d0, d1 = k * w, k * wm
    rows_pad = -(-(b * n) // 16) * 16
    rows64 = -(-(b * n) // TR) * TR
    if d1 > MMA_MAX_D1:
        return BwdTcPlan("wide", rows_pad, rows64, *[0] * 15)
    ct = -(-d1 // 8)
    nt = next(t for t in TC_MAX_MT if -(-ct // t) <= TC_MAX_WARPS[t])
    mtiles = rows64 // 16
    half = max(1, sms // 2)
    bm = min(TC_MAX_MT[nt], -(-mtiles // half))
    clusters = max(-(-mtiles // bm), min(mtiles, half))
    bm = -(-mtiles // clusters)
    stride = _ldsm_stride(d1)
    # slots a warp (its items take them in turn): up to 4, at least 2 where
    # any candidate leaves room for 2, else 1
    for least, (stage, p) in [(m, c) for m in (2, 1) for c in TC_STAGE_ITEM]:
        warps, items = _tc_stream(d0, d1, nt, p)[4::3]
        smem = (TC_BAR_BYTES + 2 * 16 * bm * stride * 2 + warps * 768
                + (4 * 16 * d1 * act_bytes if stage else 0))
        per_warp = min(4, TC_MAX_RING // warps,
                       (SMEM_PER_BLOCK - smem) // (p * nt * 256 * warps))
        ring = per_warp * warps
        if per_warp >= least:
            break
    else:
        raise ValueError(f"bwd_tc_plan: no ring fits a rows block at D1 = {d1}")
    smem += ring * p * nt * 256
    ntn = -(-d1 // WG_N)
    units = 2 * -(-d0 // WG_M) * ntn + 4 * -(-d1 // WG_M) * ntn
    chunks = rows64 // TR
    nseg = 1
    while 2 * nseg <= min(WG_MAX_CLUSTER, chunks) and 2 * nseg * units <= sms:
        nseg *= 2
    ws = (2 * items * p * nt * 256 + chunks * (16 * -(-d1 // 8) + -(-d0 // 8)) * 1024
          + 4 * clusters * 12 * d1) // 4
    return BwdTcPlan("tc", rows_pad, rows64, bm, nt, warps, 32 * (warps + 1), stride, p, items,
                     ring, stage, smem, clusters, nseg, units, chunks, ws)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    """The SMs of the card `device` names."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fn(name: str):
    fn = getattr(_build.library("spectral"), name)
    fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _check(rc: int, name: str, k: int, w: int, wm: int) -> None:
    """Raise on a C entry's error; 1 (cudaErrorInvalidValue) is also what
    every entry returns, before any launch, for a shape outside
    csrc/spectral.cu `shape_ok`."""
    if rc == 1:
        raise RuntimeError(
            f"{name}: the kernels refused K*W = {k * w}, K*W*multi = {k * wm} "
            "(csrc/spectral.cu shape_ok: multiples of 4)")
    _build.check(rc, name)


def _scratch(floats: int, name: str, like):
    """A float32 device buffer of `floats` floats on the card of `like` (None
    for 0), as a C entry sized it; a negative size (the runtime could not say
    how many SMs the card has) raises."""
    if floats < 0:
        raise RuntimeError(f"{name}: the CUDA runtime did not report the card's SMs, "
                           "which size the kernels' scratch")
    return torch.empty(floats, dtype=torch.float32, device=like.device) if floats else None


def _check_operands(name, x, weights, ci, si, k, w, wm, *f32):
    """x, the 2-D weights, ci and si of one operand type (f32 or bf16), the
    biases and `f32` float32, all contiguous on one card; the weights' shapes."""
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: operands of {dtype}, expected float32 or bfloat16")
    _build.require_cuda(name, *weights[1::2], *f32)
    for i, t in enumerate([x, ci, si, *weights[0::2]]):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is a {t.dtype} tensor on {t.device} "
                             f"(contiguous: {t.is_contiguous()}), expected a contiguous "
                             f"{dtype} tensor on {x.device}")
    for i, t in enumerate(weights):
        d_in = k * w if i < 8 else k * wm
        want = (d_in, k * wm) if i % 2 == 0 else (k * wm,)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: GLU tensor {i} is {tuple(t.shape)}, "
                             f"expected {want}")
    if weights[1].device != x.device:
        raise ValueError(f"{name}: tensors on {x.device} and {weights[1].device}")


def _launch_fwd(x, weights, ci, si, multi: int, save: bool = False,
                act_dtype: str = "float32"):
    """x [B,K,N,W] and the 24 folded GLU tensors -> [B,K,N,W*multi]; with
    `save`, (out, acts [12, padded rows, K*W*multi]) from the saving forward,
    acts of `act_dtype` (bf16 only with bf16 operands: the bf16-storage arm).
    Operands of bf16 (x, the 2-D weights, ci, si) launch the bf16 arm on the
    plan `fwd_mma_plan` of the shape and card."""
    b, k, n, w = x.shape
    wm = w * multi
    name = "spe_seq_cell_save" if save else "spe_seq_cell"
    _check_operands(name, x, weights, ci, si, k, w, wm)
    bf16 = x.dtype == torch.bfloat16
    bf16_acts = torch_impl.operand_dtype(act_dtype) == torch.bfloat16
    if bf16_acts and not bf16:
        raise ValueError(f"{name}: bf16 acts need the bf16 arm (compute_dtype bfloat16); "
                         "the f32 arm stores f32, as the JAX package's act_dtype")
    arm = "_bf16" if bf16 else ""
    plan = ()
    if bf16:
        mma = fwd_mma_plan(b, k, n, w, wm, _sms(x.device), acts_bf16=bf16_acts and save)
        plan = mma.args + ((mma.stage_acts,) if bf16_acts and save else ())
        smem = (_fn("spectral_fwd_save_bf16acts_smem" if bf16_acts and save
                    else "spectral_fwd_bf16_smem")(k, wm, *plan) if mma.route == "mma" else 0)
        if smem != mma.smem:
            raise RuntimeError(f"{name}: the kernel takes the plan {mma} with {smem} bytes "
                               f"of shared memory (-1: not at all), fwd_mma_plan with "
                               f"{mma.smem}")
    out = torch.empty((b, k, n, wm), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    # the wide chain kernel's buffers past D1 = 2421, else nothing
    ws = _scratch(_fn("spectral_fwd_workspace_floats")(b, k, n, wm), name, x)
    ws_ptr = ws.data_ptr() if ws is not None else None
    if not save:
        rc = _fn("spectral_fwd" + arm)(x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(),
                                       out.data_ptr(), ws_ptr, b, k, n, w, wm, *plan,
                                       _build.stream_ptr(x))
        _check(rc, name, k, w, wm)
        (spe_seq_cell_bf16 if bf16 else spe_seq_cell).launches += 1
        return out
    acts = torch.empty(_fn("spectral_act_floats")(b, k, n, wm),
                       dtype=torch.bfloat16 if bf16_acts else torch.float32,
                       device=x.device).view(12, -1, k * wm)
    rc = _fn("spectral_fwd_save" + arm + ("acts" if bf16_acts else ""))(
        x.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr(), out.data_ptr(),
        acts.data_ptr(), ws_ptr, b, k, n, w, wm, *plan, _build.stream_ptr(x))
    _check(rc, name, k, w, wm)
    (spe_seq_cell_save_bf16acts if bf16_acts else spe_seq_cell_save_bf16 if bf16
     else spe_seq_cell_save).launches += 1
    return out, acts


def _launch_bwd(x, g, weights, ci, si, multi: int, acts=None):
    """-> (dx [B,K,N,W] f32, the 24 gradients in kernel order as views of one
    flat buffer, those of GLU 0 and 1 in folded space). With `acts` (what the
    saving forward wrote) the reread entry runs, else the recompute entry; g
    f32 (the bf16 kernels round it as they stage it); bf16 operands launch the
    bf16 arm on the plan `bwd_tc_plan` of the shape, card and storage (the
    recompute's chain on `fwd_mma_plan`'s), and bf16 acts its bf16-storage arm."""
    b, k, n, w = x.shape
    wm = w * multi
    reread = acts is not None
    name = "spe_seq_cell_bwd_reread" if reread else "spe_seq_cell_bwd"
    bf16_acts = reread and acts.dtype == torch.bfloat16
    if bf16_acts and x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: bf16 acts need the bf16 arm (compute_dtype bfloat16)")
    _check_operands(name, x, weights, ci, si, k, w, wm,
                    *([acts] if reread and not bf16_acts else []))
    if bf16_acts and (acts.device != x.device or not acts.is_contiguous()):
        raise ValueError(f"{name}: acts on {acts.device} (contiguous: "
                         f"{acts.is_contiguous()}), expected a contiguous tensor on {x.device}")
    if g.shape != (b, k, n, wm) or g.dtype != torch.float32 or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype}, expected a contiguous "
                         f"float32 {(b, k, n, wm)} on {x.device}")
    if reread and acts.numel() != _fn("spectral_act_floats")(b, k, n, wm):
        raise ValueError(f"{name}: acts {tuple(acts.shape)} are not the saving "
                         f"forward's for x {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    arm = "_bf16" if bf16 else ""
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    grads = torch.empty(_fn("spectral_bwd_grad_floats")(k, w, wm),
                        dtype=torch.float32, device=x.device)
    entry = "spectral_bwd_reread" if reread else "spectral_bwd"
    if bf16:
        act_bytes = 2 if bf16_acts else 4
        plan = bwd_tc_plan(b, k, n, w, wm, _sms(x.device), act_bytes)
        nsplit, tiling = N_SPLIT, plan.args
        if not reread:
            tiling += fwd_mma_plan(b, k, n, w, wm, _sms(x.device)).args
        floats = _fn(entry + "_bf16_workspace_floats")(b, k, n, w, wm, nsplit, *plan.args)
        extra = 0 if reread else 12 * plan.rows_pad * k * wm
        if plan.route == "tc":
            smem = _fn("spectral_bwd_bf16_smem")(b, k, n, w, wm, *plan.args, act_bytes)
            if floats != plan.workspace_floats + extra or smem != plan.smem:
                raise RuntimeError(
                    f"{name}: the kernels size their scratch at {floats} floats and a rows "
                    f"block at {smem} bytes (-1: the plan refused), bwd_tc_plan at "
                    f"{plan.workspace_floats + extra} and {plan.smem}")
    else:
        nsplit, tiling = N_SPLIT, ()
        floats = _fn(entry + "_workspace_floats")(b, k, n, w, wm, nsplit)
    ws = _scratch(floats, name, x)
    ptrs = (ctypes.c_void_p * 24)(*[t.data_ptr() for t in weights])
    head = (x.data_ptr(), g.data_ptr(), ptrs, ci.data_ptr(), si.data_ptr())
    tail = (dx.data_ptr(), grads.data_ptr(), ws.data_ptr(), b, k, n, w, wm, nsplit, *tiling,
            _build.stream_ptr(x))
    if reread:
        rc = _fn("spectral_bwd_reread" + arm + ("acts" if bf16_acts else ""))(
            *head, acts.data_ptr(), *tail)
        _check(rc, name, k, w, wm)
        (spe_seq_cell_bwd_reread_bf16acts if bf16_acts else spe_seq_cell_bwd_reread_bf16
         if bf16 else spe_seq_cell_bwd_reread).launches += 1
    else:
        rc = _fn("spectral_bwd" + arm)(*head, *tail)
        _check(rc, name, k, w, wm)
        (spe_seq_cell_bwd_bf16 if bf16 else spe_seq_cell_bwd).launches += 1
    out, off = [], 0
    for t in weights:
        out.append(grads[off : off + t.numel()].view(t.shape))
        off += t.numel()
    return dx, out


def _flat(glu_params):
    """Six GLU dicts -> 24 tensors in kernel order (wl, bl, wr, br per GLU)."""
    return [p[side][leaf] for p in glu_params for side in ("left", "right")
            for leaf in ("w", "b")]


def _unflat(tensors):
    return [{"left": {"w": wl, "b": bl}, "right": {"w": wr, "b": br}}
            for wl, bl, wr, br in zip(*[iter(tensors)] * 4)]


def _bwd_cuda(x, g, weights, multi: int, acts=None):
    """The backward on the card from the kernels' operands (x and the folded
    weights, of one operand type) and the f32 cotangent g: the kernel (reread
    with `acts`, else recompute), then the layer-0 unfold dW = Cf^T @ dAW (Sf
    for the imaginary chain) in f32."""
    b, k, n, w = x.shape
    cf, sf, ci, si = _dft_on(w, k, w * multi, x.device, x.dtype)
    dx, grads = _launch_bwd(x, g.to(torch.float32).contiguous(), weights, ci, si, multi, acts)
    for i, dft in ((0, cf), (2, cf), (4, sf), (6, sf)):
        grads[i] = torch.matmul(dft.T, grads[i])
    return dx, grads


def spe_seq_cell_bwd(x, glu_params, g, multi: int, compute_dtype: str = "float32"):
    """x [B,K,N,W], g [B,K,N,W*multi] -> (dx, six dicts like glu_params)."""
    if x.device.type == "cpu":
        return spe_seq_cell_bwd_plain(x, glu_params, g, multi, compute_dtype)
    xk, weights, _, _ = _card_operands(x, glu_params, multi, compute_dtype)
    dx, grads = _bwd_cuda(xk, g, weights, multi)
    return dx, _unflat(grads)


spe_seq_cell_bwd.launches = 0


def spe_seq_cell_save(x, glu_params, multi: int, compute_dtype: str = "float32",
                      act_dtype: str = "float32"):
    """`spe_seq_cell` that also returns what `spe_seq_cell_bwd_reread` reads:
    (out [B,K,N,W*multi], acts [12, rows, K*W*multi]), rows = B*N on the CPU
    and B*N padded to a multiple of 16 on the card; acts of `act_dtype`
    ("bfloat16": the bf16-storage arm, which the card has at compute_dtype
    "bfloat16" only)."""
    if x.device.type == "cpu":
        return spe_seq_cell_save_plain(x, glu_params, multi, compute_dtype, act_dtype)
    return _launch_fwd(*_card_operands(x, glu_params, multi, compute_dtype), multi,
                       save=True, act_dtype=act_dtype)


spe_seq_cell_save.launches = 0


def spe_seq_cell_bwd_reread(x, glu_params, g, acts, multi: int,
                            compute_dtype: str = "float32"):
    """`spe_seq_cell_bwd` from the acts of `spe_seq_cell_save` on the same x,
    glu_params and compute_dtype, without recomputing the chain; bf16 acts
    (the bf16-storage arm) are read as the rounded values."""
    if x.device.type == "cpu":
        return spe_seq_cell_bwd_reread_plain(x, glu_params, g, acts, multi, compute_dtype)
    xk, weights, _, _ = _card_operands(x, glu_params, multi, compute_dtype)
    dx, grads = _bwd_cuda(xk, g, weights, multi, acts)
    return dx, _unflat(grads)


spe_seq_cell_bwd_reread.launches = 0


class _SpeSeqCell(torch.autograd.Function):
    """(x, multi, compute_dtype, 24 GLU tensors in kernel order) -> out. Saves
    x and the GLU tensors (on the card: the kernels' operands, folded and of
    their type) and, with `SAVE_ACTS_BWD`, the forward's acts (f32, or bf16
    with `SAVE_ACTS_F32` off at compute_dtype "bfloat16"); the backward
    rereads the acts if they were saved and recomputes them otherwise."""

    @staticmethod
    def forward(ctx, x, multi, compute_dtype, *tensors):
        ctx.multi, ctx.compute_dtype = multi, compute_dtype
        ctx.reread = SAVE_ACTS_BWD
        act_dtype = "float32" if SAVE_ACTS_F32 else compute_dtype
        if x.device.type == "cpu":
            if ctx.reread:
                out, acts = spe_seq_cell_save_plain(x, _unflat(tensors), multi,
                                                    compute_dtype, act_dtype)
                ctx.save_for_backward(x, *tensors, acts)
                return out
            ctx.save_for_backward(x, *tensors)
            return spe_seq_cell_plain(x, _unflat(tensors), multi, compute_dtype)
        xk, weights, ci, si = _card_operands(x, _unflat(tensors), multi, compute_dtype)
        if ctx.reread:
            out, acts = _launch_fwd(xk, weights, ci, si, multi, save=True,
                                    act_dtype=act_dtype)
            ctx.save_for_backward(xk, *weights, acts)
            return out
        ctx.save_for_backward(xk, *weights)
        return _launch_fwd(xk, weights, ci, si, multi)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        acts = tensors.pop() if ctx.reread else None
        g = g.contiguous()
        if x.device.type == "cpu":
            if acts is None:
                dx, dglu = spe_seq_cell_bwd_plain(x, _unflat(tensors), g, ctx.multi,
                                                  ctx.compute_dtype)
            else:
                dx, dglu = spe_seq_cell_bwd_reread_plain(x, _unflat(tensors), g, acts,
                                                         ctx.multi, ctx.compute_dtype)
            return (dx, None, None, *_flat(dglu))
        dx, grads = _bwd_cuda(x, g, tensors, ctx.multi, acts)
        return (dx, None, None, *grads)


def spe_seq_cell(x, glu_params, multi: int, compute_dtype: str = "float32"):
    """x [B,K,N,W] f32; glu_params: 6 GLU dicts (even: real chain, odd: imag);
    compute_dtype "float32" or "bfloat16" (the kernels' operands)."""
    tensors = _flat(glu_params)
    if _build.needs_grad(x, *tensors):
        return _SpeSeqCell.apply(x, multi, compute_dtype, *tensors)
    if x.device.type == "cpu":
        return spe_seq_cell_plain(x, glu_params, multi, compute_dtype)
    return _launch_fwd(*_card_operands(x, glu_params, multi, compute_dtype), multi)


spe_seq_cell.launches = 0
spe_seq_cell_bf16 = _build.bf16_arm(spe_seq_cell, "spe_seq_cell at bfloat16")
spe_seq_cell_save_bf16 = _build.bf16_arm(spe_seq_cell_save, "spe_seq_cell_save at bfloat16")
spe_seq_cell_bwd_bf16 = _build.bf16_arm(spe_seq_cell_bwd, "spe_seq_cell_bwd at bfloat16")
spe_seq_cell_bwd_reread_bf16 = _build.bf16_arm(spe_seq_cell_bwd_reread,
                                               "spe_seq_cell_bwd_reread at bfloat16")
# the bf16-storage arm (SAVE_ACTS_F32 off): the saving forward writing bf16
# acts, the reread backward on them (the acts' dtype picks it)
spe_seq_cell_save_bf16acts = _build.bf16_arm(
    spe_seq_cell_save, "spe_seq_cell_save at bfloat16 with bf16 acts", "_bf16acts",
    act_dtype="bfloat16")
spe_seq_cell_bwd_reread_bf16acts = _build.bf16_arm(
    spe_seq_cell_bwd_reread, "spe_seq_cell_bwd_reread at bfloat16 on bf16 acts", "_bf16acts")
