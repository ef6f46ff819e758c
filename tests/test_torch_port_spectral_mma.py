"""The bf16 spectral backward on tensor cores (csrc/spectral.cu
`bwd_mma_launch`) and the cast-free bf16 graph conv, on the CPU.

- The tile plan (`cuda_spectral.bwd_mma_plan`, handed to the C entries as
  it stands): every padded row of each chain in one row tile, every (k,
  column) of each GLU's weight gradient in one block a row segment, every
  row in one segment, shared memory within a block's and whole warps, and
  D1 past 2048 routed to the wide scalar kernels.
- A torch emulation of the kernels' blocking (bf16 operands, f32 sums of
  16-term panels in the kernels' order, the epilogue's rounding points, the
  weight gradients' 32-row stages and row segments) held to the bf16 plain
  reread backward by chip_smoke.py's rule for the bf16 arms: each array
  within 2^-8 of its largest entry and at least 4 times closer to the bf16
  plain version than to the f32 one.
- With the C functions replaced, the bf16 graph conv hands its kernel the
  f32 mul_L and x, and the spectral backwards the f32 cotangent.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch.ops import _build, cuda_graph, cuda_spectral, torch_impl

torch.set_num_threads(1)

K = 4
SMS = 132  # an H100 SXM's
WINDOWS = [(12, 5), (7, 5), (10, 5), (25, 5), (28, 5), (35, 5), (12, 6), (12, 15), (100, 5),
           (103, 5)]
ROWS = [(32, 140), (32, 25), (10, 60), (4, 60), (5, 37), (3, 37)]  # 4480, 800, 600, 240, 185, 111


def _chip_smoke():
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("b,n", ROWS, ids=[f"{b * n}rows" for b, n in ROWS])
@pytest.mark.parametrize("w,multi", WINDOWS, ids=[f"W{w}x{m}" for w, m in WINDOWS])
def test_bwd_mma_plan_covers_rows_and_gradients_once(w, multi, b, n):
    d0, d1 = K * w, K * w * multi
    plan = cuda_spectral.bwd_mma_plan(b, K, n, w, w * multi, SMS)
    assert plan.rows_pad == -(-(b * n) // 16) * 16
    if d1 > cuda_spectral.MMA_MAX_D1:
        assert plan.route == "wide" and plan.nsplit == cuda_spectral.N_SPLIT
        return
    assert plan.route == "mma"
    # the rows kernel: every padded row in exactly one tile, every column in
    # exactly one warp's n8 tiles, whole warps within its launch bounds
    assert plan.tile_rows % 16 == 0 and plan.tile_rows // 16 in cuda_spectral.MMA_TILES[
        plan.n_tiles]
    seen = np.zeros(plan.rows_pad, int)
    for t in range(plan.tiles):
        seen[t * plan.tile_rows: min((t + 1) * plan.tile_rows, plan.rows_pad)] += 1
    assert (seen == 1).all() and (plan.tiles - 1) * plan.tile_rows < plan.rows_pad
    warps = plan.threads // 32
    assert plan.threads % 32 == 0 and plan.threads <= cuda_spectral.MMA_MAX_THREADS[plan.n_tiles]
    cols = np.zeros(d1, int)
    for wp in range(warps):
        lo = wp * plan.n_tiles * 8
        cols[lo: lo + plan.n_tiles * 8] += 1
    assert (cols == 1).all() and (warps - 1) * plan.n_tiles * 8 < d1
    assert plan.bias_parts == plan.tiles
    # its shared memory: da and ds of the tile, rows on distinct banks
    assert plan.stride >= -(-d1 // 16) * 16 and (plan.stride * 2) % 128 == 32
    assert plan.smem == 2 * plan.tile_rows * plan.stride * 2 <= cuda_graph.SMEM_PER_BLOCK
    assert plan.ld % 8 == 0 and plan.ld >= d1
    # the weight gradients: every (k, column) of each GLU once a row segment
    kt, six, nsplit = plan.wgrad_grid
    assert six == 6 and nsplit == plan.nsplit >= 1
    ctiles = -(-d1 // cuda_spectral.WGRAD_C)
    assert kt == -(-d1 // cuda_spectral.WGRAD_K) * ctiles
    for din in (d0, d1):
        cover = np.zeros((din, d1), int)
        for bx in range(kt):
            k0 = bx // ctiles * cuda_spectral.WGRAD_K
            c0 = bx % ctiles * cuda_spectral.WGRAD_C
            if k0 >= din:
                continue
            cover[k0: k0 + cuda_spectral.WGRAD_K, c0: c0 + cuda_spectral.WGRAD_C] += 1
        assert (cover == 1).all()
    # every 32-row stage in exactly one segment
    assert plan.chunks * cuda_spectral.WGRAD_ROWS >= plan.rows_pad > (
        plan.chunks - 1) * cuda_spectral.WGRAD_ROWS
    stages = np.zeros(plan.chunks, int)
    for z in range(nsplit):
        stages[z * plan.chunks_per_seg: min(plan.chunks, (z + 1) * plan.chunks_per_seg)] += 1
    assert (stages == 1).all()
    assert 2 * plan.wgrad_smem <= cuda_graph.SMEM_PER_BLOCK  # two blocks an SM
    # the scratch: 16 bf16 planes, the chains' dx, bias partials, nsplit partials
    total = 2 * 2 * (d0 * d1 + d1) + 4 * 2 * (d1 * d1 + d1)
    assert plan.workspace_floats == (16 * plan.rows_pad * plan.ld // 2
                                     + 2 * plan.rows_pad * d0 + plan.bias_parts * 12 * d1
                                     + nsplit * total)


def test_bwd_mma_plan_fills_the_card_at_the_flagship():
    """The flagship takes 80-row tiles (112 blocks on 132 SMs: 80 rows on the
    busiest, as 16-row tiles would, against 96 for 32-row ones) and twelve row
    segments of the weight gradients (528 blocks, four an SM)."""
    plan = cuda_spectral.bwd_mma_plan(32, K, 140, 12, 60, SMS)
    assert (plan.tile_rows, plan.n_tiles, plan.threads, plan.tiles) == (80, 4, 256, 56)
    assert plan.nsplit == 12 and plan.wgrad_grid == (10, 6, 12)


def _rnd(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _panels(a, bnk, k):
    """sum over 16-column panels p, ascending, of a[:, p] @ bnk[:, p].T (a's
    columns padded to whole panels with zeros): the f32 order of a warp's
    mma.sync sums."""
    acc = torch.zeros(a.shape[0], bnk.shape[0])
    for p in range(0, k, 16):
        acc = acc + a[:, p: p + 16] @ bnk[:, p: p + 16].T
    return acc


def emulate_bwd_mma(x, glu, g, acts, multi, plan):
    """The bf16 reread backward as `spectral_bwd_rows_mma_kernel`,
    `spectral_wgrad_mma_kernel` and the reduce and bias kernels compute it:
    -> (dx, dglu) like `spe_seq_cell_bwd_reread_plain`."""
    b, k, n, w = x.shape
    wm = w * multi
    d0, d1, rows = k * w, k * wm, b * n
    rp = plan.rows_pad
    cf, sf, ci, si = torch_impl._dft_tensors(w, k, wm, x.device, torch.float32)
    weights = [(_rnd(wl), _rnd(wr)) for wl, wr in torch_impl._folded_glu_weights(glu, cf, sf)]
    pad = lambda t: torch.cat([t, t.new_zeros(rp - t.shape[0], *t.shape[1:])])  # noqa: E731
    gr = pad(_rnd(torch_impl._rows(g)))
    a_s = [pad(acts[i, :rows]) for i in range(12)]
    xr = pad(_rnd(torch_impl._rows(x)))
    dxc, dacts, us, bias = [], [None] * 12, [None] * 4, [None] * 12
    for chain, idft in ((0, ci), (1, si)):
        d = _panels(gr, _rnd(idft), d1)  # block diagonal and symmetric: its own [N][K]
        for layer in (2, 1, 0):
            gi = 2 * layer + chain
            a, s = a_s[2 * gi], a_s[2 * gi + 1]
            da, ds = d * s, d * a * (s * (1.0 - s))
            for side, v in ((0, da), (1, ds)):  # a tile's sums, then the tiles in order
                tiles = torch.nn.functional.pad(v, (0, 0, 0, plan.tiles * plan.tile_rows - rp))
                parts = tiles.reshape(plan.tiles, plan.tile_rows, d1).sum(dim=1)
                bias[2 * gi + side] = parts.sum(dim=0)
            dacts[2 * gi], dacts[2 * gi + 1] = _rnd(da), _rnd(ds)
            if gi < 4:
                us[gi] = _rnd(a * s)
            wl, wr = weights[gi]
            # one sum over both halves, each padded to whole panels: da's, then ds's
            kp = -(-d1 // 16) * 16
            wide = lambda t: torch.nn.functional.pad(t, (0, kp - d1))  # noqa: E731
            d = _panels(torch.cat([wide(dacts[2 * gi]), wide(dacts[2 * gi + 1])], dim=1),
                        torch.cat([wide(wl), wide(wr)], dim=1), 2 * kp)
        dxc.append(d)
    dx = (dxc[0] + dxc[1])[:rows].reshape(b, n, k, w).permute(0, 2, 1, 3)
    seg = plan.chunks_per_seg * cuda_spectral.WGRAD_ROWS
    dglu = []
    for gi in range(6):
        u = xr if gi < 2 else us[gi - 2]
        out = []
        for v in (dacts[2 * gi], dacts[2 * gi + 1]):
            total = torch.zeros(u.shape[1], d1)
            for z in range(plan.nsplit):  # segments summed in order
                acc = torch.zeros(u.shape[1], d1)
                for r in range(z * seg, min(rp, (z + 1) * seg), 16):
                    acc = acc + u[r: r + 16].T @ v[r: r + 16]
                total = total + acc
            out.append(total)
        dwl, dwr = out
        if gi < 2:
            fold = cf if gi == 0 else sf
            dwl, dwr = fold.T @ dwl, fold.T @ dwr
        dglu.append({"left": {"w": dwl, "b": bias[2 * gi]},
                     "right": {"w": dwr, "b": bias[2 * gi + 1]}})
    return dx, dglu


@pytest.mark.parametrize("b,n,w,multi", [(32, 140, 12, 5), (5, 37, 7, 5)],
                         ids=["flagship", "W7"])
def test_mma_blocking_meets_the_bf16_rule(b, n, w, multi):
    smoke = _chip_smoke()
    rng = np.random.default_rng(11)
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    x = torch.from_numpy(rng.standard_normal((b, K, n, w)).astype(np.float32))
    g = torch.from_numpy((1e-3 * rng.standard_normal((b, K, n, w * multi))).astype(np.float32))
    with torch.no_grad():
        _, acts = torch_impl.spe_seq_cell_save(x, glu, multi, "bfloat16")
        plan = cuda_spectral.bwd_mma_plan(b, K, n, w, w * multi, SMS)
        got = emulate_bwd_mma(x, glu, g, acts, multi, plan)
        want = torch_impl.spe_seq_cell_bwd_reread(x, glu, g, acts, multi, "bfloat16")
        want32 = torch_impl.spe_seq_cell_bwd_reread(x, glu, g, acts, multi)
    flat = [[dx] + cuda_spectral._flat(dg) for dx, dg in (got, want, want32)]
    bad, err, ratio, rel = smoke.bf16_agreement(*flat, smoke.BF16_ATOL_REL)
    assert not bad and ratio >= smoke.BF16_CLOSER, (bad, err, ratio, rel)
    # and the emulation is no copy of the plain version: another sum order
    assert any(not torch.equal(a, c) for a, c in zip(flat[0], flat[1]))


class _Fake:
    """A C function that records its arguments and returns 0."""

    def __init__(self, ret=0):
        self.calls, self.ret = [], ret

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


def test_bf16_graph_conv_hands_the_kernel_the_f32_operands(monkeypatch):
    fakes = {}
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(cuda_graph, "_fn", lambda name="cheb_graph_conv_fwd":
                        fakes.setdefault(name, _Fake()))
    mul_l, x = torch.zeros((4, 140, 140)), torch.ones((32, 140, 12))
    for cd, esize in (("bfloat16", 2), ("float32", 4)):
        cuda_graph._launch_fwd(mul_l, x, cd)
        name = "cheb_graph_conv_fwd_bf16" if cd == "bfloat16" else "cheb_graph_conv_fwd"
        (args,) = fakes[name].calls
        plan = cuda_graph.launch_plan(4, 140, 32, 12, esize)
        assert args[:2] == (mul_l.data_ptr(), x.data_ptr())
        assert args[3:12] == (4, 140, 32, 12, plan.panel, plan.row_stride, plan.batch_stride,
                              plan.threads, plan.smem)


@pytest.mark.parametrize("reread", [True, False], ids=["reread", "recompute"])
def test_spectral_backwards_hand_the_kernels_the_f32_cotangent(monkeypatch, reread):
    b, n, w, multi = 5, 37, 7, 5
    wm = w * multi
    fakes = {}
    plan = cuda_spectral.bwd_mma_plan(b, K, n, w, wm, SMS)
    sizes = {"spectral_act_floats": 12 * plan.rows_pad * K * wm,
             "spectral_bwd_grad_floats": 2 * 2 * (K * w * K * wm + K * wm)
             + 4 * 2 * (K * wm * K * wm + K * wm),
             "spectral_bwd_reread_bf16_workspace_floats": plan.workspace_floats,
             "spectral_bwd_bf16_workspace_floats": plan.workspace_floats
             + 12 * plan.rows_pad * K * wm}
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(cuda_spectral, "_sms", lambda device: SMS)
    monkeypatch.setattr(cuda_spectral, "_fn",
                        lambda name: fakes.setdefault(name, _Fake(sizes.get(name, 0))))
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    x = torch.zeros((b, K, n, w))
    g = torch.ones((b, K, n, wm))
    xk, weights, _, _ = cuda_spectral._card_operands(x, glu, multi, "bfloat16")
    acts = torch.zeros((12, plan.rows_pad, K * wm)) if reread else None
    cuda_spectral._bwd_cuda(xk, g, weights, multi, acts)
    name = "spectral_bwd_reread_bf16" if reread else "spectral_bwd_bf16"
    (args,) = fakes[name].calls
    assert args[0] == xk.data_ptr() and args[1] == g.data_ptr()  # g itself: no cast
    tail = 1 if reread else 6  # the recompute: its chain's plan too, before the stream
    assert args[-tail - 3:-tail] == (plan.nsplit, plan.tile_rows, plan.n_tiles)
    assert args[-tail - 8:-tail - 3] == (b, K, n, w, wm)
