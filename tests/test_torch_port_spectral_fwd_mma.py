"""The bf16 spectral chain forward on tensor cores (csrc/spectral.cu
`chain_mma_launch`), on the CPU.

- The tile plan (`cuda_spectral.fwd_mma_plan`, handed to the C entries as
  it stands): every padded row of each chain in exactly one row tile, every
  column in exactly one warp's n8 tiles of one pass, whole warps within the
  launch bound, shared memory within a block's, and D1 past 2048 routed to
  the wide scalar kernel.
- A torch emulation of the kernel's blocking (bf16 operands, f32 sums of
  16-term k panels in the kernel's order, a and s in f32 and each GLU's input
  round(a * s), the inverse DFT's R @ Ci then I @ Si in one sum) held to the
  bf16 plain saving forward by chip_smoke.py's rule for the bf16 arms: up to
  D1 = 720 each array within 2^-8 of its largest entry and at least 4 times
  closer to the bf16 plain version than to the f32 one, at D1 = 2000
  `bf16_noise_agreement` against the plain version with f64 sums.
- With the C functions replaced, both bf16 forwards and the bf16 recompute
  backward hand the C entries the plan's arguments.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch.ops import _build, cuda_spectral, torch_impl

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
def test_fwd_mma_plan_covers_rows_and_columns_once(w, multi, b, n):
    d1 = K * w * multi
    plan = cuda_spectral.fwd_mma_plan(b, K, n, w, w * multi, SMS)
    assert plan.rows_pad == -(-(b * n) // 16) * 16
    if d1 > cuda_spectral.MMA_MAX_D1:
        assert plan.route == "wide"
        return
    assert plan.route == "mma"
    mt = plan.tile_rows // 16
    assert plan.tile_rows % 16 == 0 and (mt, plan.n_tiles) in cuda_spectral.FWD_MMA_TILES
    # every padded row in exactly one tile (the same tiles for both chains)
    seen = np.zeros(plan.rows_pad, int)
    for t in range(plan.tiles):
        seen[t * plan.tile_rows: min((t + 1) * plan.tile_rows, plan.rows_pad)] += 1
    assert (seen == 1).all() and (plan.tiles - 1) * plan.tile_rows < plan.rows_pad
    # whole warps within the launch bound; every column in one warp's n8
    # tiles of one pass, no pass without a column, every warp with one in
    # the first pass
    warps = plan.threads // 32
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= cuda_spectral.FWD_MMA_MAX_THREADS[mt]
    pw = warps * plan.n_tiles * 8
    assert plan.passes == -(-d1 // pw)
    cols = np.zeros(plan.passes * pw, int)
    for p in range(plan.passes):
        for wp in range(warps):
            lo = p * pw + wp * plan.n_tiles * 8
            cols[lo: lo + plan.n_tiles * 8] += 1
    assert (cols == 1).all() and (plan.passes - 1) * pw < d1
    assert (warps - 1) * plan.n_tiles * 8 < d1
    # shared memory: two buffers of the tile's rows and the panel ring, rows
    # 16 bytes past a multiple of 128 (ldmatrix's 8 rows on distinct banks)
    for stride, cols_ in ((plan.stride, d1), (plan.panel_stride, pw)):
        assert stride >= -(-cols_ // 16) * 16 and (stride * 2) % 128 == 16
    assert plan.stages in cuda_spectral.FWD_MMA_STAGES
    assert plan.panel_k in cuda_spectral.FWD_MMA_PANEL_K
    smem = lambda k_, st: (2 * plan.tile_rows * plan.stride  # noqa: E731
                           + st * 2 * k_ * plan.panel_stride) * 2
    assert plan.smem == smem(plan.panel_k, plan.stages) <= cuda_spectral.SMEM_PER_BLOCK
    # the deepest panels that fit, then the most stages
    deeper = [k_ for k_ in cuda_spectral.FWD_MMA_PANEL_K if k_ > plan.panel_k]
    assert all(smem(k_, 2) > cuda_spectral.SMEM_PER_BLOCK for k_ in deeper)
    assert plan.stages == 4 or smem(plan.panel_k, plan.stages + 1) > cuda_spectral.SMEM_PER_BLOCK
    assert plan.args == (plan.tile_rows, plan.n_tiles, plan.threads, plan.panel_k, plan.stages)


def test_fwd_mma_plan_at_the_flagship():
    """The flagship takes 80-row tiles (112 blocks on 132 SMs, one an SM:
    80 rows on the busiest, as 16-row tiles would, against 96 for 32-row
    ones), 10 warps of three n8 tiles (D1 = 240 in one pass: 8 MT NT = 120
    sums a thread) and two stages of 64-row panels (nine barriers over the
    three GLUs)."""
    plan = cuda_spectral.fwd_mma_plan(32, K, 140, 12, 60, SMS)
    assert (plan.tile_rows, plan.n_tiles, plan.threads, plan.passes, plan.panel_k, plan.stages,
            plan.tiles) == (80, 3, 320, 1, 64, 2, 56)


def _rnd(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _panels(a, bnk, k):
    """sum over 16-column panels p, ascending, of a[:, p] @ bnk[:, p].T: the
    f32 order of a warp's mma.sync sums."""
    acc = torch.zeros(a.shape[0], bnk.shape[0], dtype=a.dtype)
    for p in range(0, k, 16):
        acc = acc + a[:, p: p + 16] @ bnk[:, p: p + 16].T
    return acc


def emulate_fwd_mma(x, glu, multi, plan):
    """The bf16 saving forward as `spectral_chain_mma_kernel` computes it:
    -> (out [B,K,N,WM], acts [12, rows_pad, D1]) like the plain version's."""
    b, k, n, w = x.shape
    wm = w * multi
    d1, rows = k * wm, b * n
    cf, sf, ci, si = torch_impl._dft_tensors(w, k, wm, x.device, torch.float32)
    weights = [(_rnd(wl), _rnd(wr)) for wl, wr in torch_impl._folded_glu_weights(glu, cf, sf)]
    xr = _rnd(torch_impl._rows(x))
    xr = torch.cat([xr, xr.new_zeros(plan.rows_pad - rows, xr.shape[1])])  # x = 0 past B*N
    cur, acts = [xr, xr], []
    for gi, (p, (wl, wr)) in enumerate(zip(glu, weights)):
        u = cur[gi % 2]
        a = _panels(u, wl.T, u.shape[1]) + p["left"]["b"]
        s = torch.sigmoid(_panels(u, wr.T, u.shape[1]) + p["right"]["b"])
        acts += [a, s]
        cur[gi % 2] = _rnd(a * s)
    # the inverse DFT: R @ Ci, then I @ Si into the same sums, each half over
    # whole 16-column panels (the block-diagonal B is zero off its windows)
    kp = -(-d1 // 16) * 16
    wide = lambda t: torch.nn.functional.pad(t, (0, kp - t.shape[1]))  # noqa: E731
    out = _panels(torch.cat([wide(cur[0]), wide(cur[1])], dim=1),
                  torch.cat([wide(_rnd(ci).T), wide(_rnd(si).T)], dim=1), 2 * kp)
    out = out[:rows].reshape(b, n, k, wm).permute(0, 2, 1, 3)
    return out, torch.stack(acts)


SHAPES = [(32, 140, 12, 5), (32, 25, 28, 5), (5, 37, 7, 5), (5, 37, 10, 5), (4, 60, 100, 5)]


@pytest.mark.parametrize("b,n,w,multi", SHAPES,
                         ids=["flagship", "COVID-19", "W7", "W10-WM50", "D1-2000"])
def test_fwd_mma_blocking_meets_the_bf16_rule(b, n, w, multi):
    smoke = _chip_smoke()
    d1 = K * w * multi
    rng = np.random.default_rng(12)
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    x = torch.from_numpy(rng.standard_normal((b, K, n, w)).astype(np.float32))
    plan = cuda_spectral.fwd_mma_plan(b, K, n, w, w * multi, SMS)
    rows = b * n
    with torch.no_grad():
        out, acts = emulate_fwd_mma(x, glu, multi, plan)
        arrays = [[o] + list(a[:, :rows]) for o, a in (
            (out, acts),
            torch_impl.spe_seq_cell_save(x, glu, multi, "bfloat16"),
            torch_impl.spe_seq_cell_save(x, glu, multi))]
        got, want, want32 = arrays
        # rows past B*N: the chain's values for an all-zero input row, finite
        assert torch.isfinite(acts).all()
        if d1 <= smoke.BF16_NOISE_D1:
            bad, err, ratio, rel = smoke.bf16_agreement(got, want, want32, smoke.BF16_ATOL_REL)
            assert not bad and ratio >= smoke.BF16_CLOSER, (bad, err, ratio, rel)
        else:
            x64 = x.double()
            glu64 = [{s: {k_: t.double() for k_, t in p[s].items()} for s in p} for p in glu]
            o64, a64 = torch_impl.spe_seq_cell_save(x64, glu64, multi, "bfloat16")
            bad, rel, noise, closer = smoke.bf16_noise_agreement(
                got, [o64] + list(a64), want, want32)
            assert not bad, (bad, rel, noise, closer)
    # and the emulation is no copy of the plain version: another sum order
    assert any(not torch.equal(a, c) for a, c in zip(got, want))


class _Fake:
    """A C function that records its arguments and returns `ret`."""

    def __init__(self, ret=0):
        self.calls, self.ret = [], ret

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.mark.parametrize("b,n,w,multi", [(32, 140, 12, 5), (5, 37, 7, 5)],
                         ids=["flagship", "W7"])
def test_bf16_forwards_and_recompute_hand_the_kernels_the_plan(monkeypatch, b, n, w, multi):
    wm = w * multi
    fwd = cuda_spectral.fwd_mma_plan(b, K, n, w, wm, SMS)
    bwd = cuda_spectral.bwd_mma_plan(b, K, n, w, wm, SMS)
    sizes = {"spectral_act_floats": 12 * fwd.rows_pad * K * wm,
             "spectral_bwd_grad_floats": 2 * 2 * (K * w * K * wm + K * wm)
             + 4 * 2 * (K * wm * K * wm + K * wm),
             "spectral_bwd_bf16_workspace_floats": bwd.workspace_floats
             + 12 * bwd.rows_pad * K * wm, "spectral_fwd_bf16_smem": fwd.smem}
    fakes = {}
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(cuda_spectral, "_sms", lambda device: SMS)
    monkeypatch.setattr(cuda_spectral, "_fn",
                        lambda name: fakes.setdefault(name, _Fake(sizes.get(name, 0))))
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    x = torch.zeros((b, K, n, w))
    xk, weights, ci, si = cuda_spectral._card_operands(x, glu, multi, "bfloat16")
    cuda_spectral._launch_fwd(xk, weights, ci, si, multi)
    cuda_spectral._launch_fwd(xk, weights, ci, si, multi, save=True)
    cuda_spectral._bwd_cuda(xk, torch.ones((b, K, n, wm)), weights, multi)
    (serve,) = fakes["spectral_fwd_bf16"].calls
    (save,) = fakes["spectral_fwd_save_bf16"].calls
    (recompute,) = fakes["spectral_bwd_bf16"].calls
    assert serve[0] == save[0] == recompute[0] == xk.data_ptr()
    assert serve[6:16] == (b, K, n, w, wm) + fwd.args
    assert save[7:17] == (b, K, n, w, wm) + fwd.args
    assert recompute[8:] == ((b, K, n, w, wm, bwd.nsplit, bwd.tile_rows, bwd.n_tiles)
                             + fwd.args + (None,))
    # each forward first asks the kernel's shared memory for the plan
    assert fakes["spectral_fwd_bf16_smem"].calls == [(K, wm) + fwd.args] * 2
