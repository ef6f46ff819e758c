"""The bf16 spectral backward on Hopper (csrc/spectral.cu `bwd_tc_launch`)
and the cast-free bf16 graph conv, on the CPU.

- The plan (`cuda_spectral.bwd_tc_plan`, handed to the C entries as it
  stands), for f32 and bf16 saved planes: every 16-row m tile of the rows
  kernel in exactly one cluster's range and no range past the block's
  accumulators, every column in exactly one warp's n8 tiles, every (product,
  k16 step, n8 tile) of each chain's weight stream in exactly one item of
  the warp that owns the tile, a ring of more items than warps and shared
  memory within a block's; every (input feature, column) of each GLU's
  weight gradient in exactly one block, every 64-row chunk in exactly one
  row segment, the segments a cluster of a power of 2 up to 8; D1 past
  2048 routed to the wide scalar kernels.
- At the flagship it fills the card: 66 clusters of 2 rows blocks (132
  blocks, 4 or 5 m tiles each); 80 weight-gradient blocks in clusters of 4.
- A torch emulation of the kernels' blocking (bf16 operands, f32 sums of
  16-term panels in the kernels' order, the epilogue's rounding points, the
  rows kernel's per-block column sums, the weight gradients' balanced row
  segments of 64-row chunks added in rank order) held to the bf16 plain
  reread backward by chip_smoke.py's rule for the bf16 arms: each array
  within 2^-8 of its largest entry and at least 4 times closer to the bf16
  plain version than to the f32 one.
- With the C functions replaced, the bf16 graph conv hands its kernel the
  f32 mul_L and x, and the spectral backwards the f32 cotangent and the plan.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch import ops
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


def _ranges(total, parts):
    """The kernels' balanced split of `total` units over `parts`: part c
    takes [c q + min(c, r), ...) of q or q + 1 units (q, r = divmod)."""
    q, r = divmod(total, parts)
    starts = [c * q + min(c, r) for c in range(parts)] + [total]
    return list(zip(starts[:-1], starts[1:]))


@pytest.mark.parametrize("act_bytes", [4, 2], ids=["f32_planes", "bf16_planes"])
@pytest.mark.parametrize("b,n", ROWS, ids=[f"{b * n}rows" for b, n in ROWS])
@pytest.mark.parametrize("w,multi", WINDOWS, ids=[f"W{w}x{m}" for w, m in WINDOWS])
def test_bwd_tc_plan_covers_rows_and_gradients_once(w, multi, b, n, act_bytes):
    d0, d1 = K * w, K * w * multi
    plan = cuda_spectral.bwd_tc_plan(b, K, n, w, w * multi, SMS, act_bytes)
    assert plan.rows_pad == -(-(b * n) // 16) * 16
    assert plan.rows64 == -(-(b * n) // 64) * 64
    if d1 > cuda_spectral.MMA_MAX_D1:
        assert plan.route == "wide" and plan.args == (0,) * 7
        return
    assert plan.chunks == plan.rows64 // 64
    assert plan.route == "tc"
    # the rows kernel: every m tile in exactly one cluster's range, none
    # longer than a block's accumulators hold
    nt, bm = plan.n_tiles, plan.m_tiles
    assert nt in cuda_spectral.TC_MAX_MT and 1 <= bm <= cuda_spectral.TC_MAX_MT[nt]
    seen = np.zeros(plan.rows64 // 16, int)
    for lo, hi in _ranges(plan.rows64 // 16, plan.clusters):
        assert 1 <= hi - lo <= bm
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # half the SMs' worth of ranges (a cluster of two blocks each) where the
    # accumulators allow: every SM busy
    assert plan.clusters == max(-(-plan.rows64 // 16 // cuda_spectral.TC_MAX_MT[nt]),
                                min(plan.rows64 // 16, SMS // 2))
    # every column in exactly one warp's n8 tiles, whole warps, a producer warp
    warps = plan.warps
    assert warps <= cuda_spectral.TC_MAX_WARPS[nt] and plan.threads == 32 * (warps + 1)
    cols = np.zeros(warps * nt * 8, int)
    for wp in range(warps):
        cols[wp * nt * 8: (wp + 1) * nt * 8] += 1
    assert (cols == 1).all() and (warps - 1) * nt * 8 < d1 <= warps * nt * 8
    # each chain's stream: every (product, k16 step, n8 tile) in one item slot
    # of the warp owning the tile, in the order that warp sums them; the
    # products in the order the kernel runs them, the inverse DFT first
    isteps, ichunks, steps, chunks, sw, w0, nt0, items = cuda_spectral._tc_stream(
        d0, d1, nt, plan.item_steps)
    assert sw == warps and items == plan.items and steps == 2 * isteps == 2 * -(-d1 // 16)
    assert items == ichunks * warps + chunks * (2 * warps + w0)
    p = plan.item_steps
    for ks, kc, nn, wl, ntl in ((isteps, ichunks, d1, warps, nt), (steps, chunks, d1, warps, nt),
                                (steps, chunks, d1, warps, nt), (steps, chunks, d0, w0, nt0)):
        cover = np.zeros((ks, -(-nn // 8)), int)
        order = []
        for c in range(kc):
            for wp in range(wl):
                for s in range(p):
                    for t in range(ntl):
                        tile = wp * ntl + t
                        if c * p + s < ks and tile < cover.shape[1]:
                            cover[c * p + s, tile] += 1
                            if wp == 0 and t == 0:
                                order.append(c * p + s)
        assert (cover == 1).all(), (ks, nn)
        assert order == list(range(ks))  # a warp's k16 steps ascending
        assert ntl <= nt and wl * ntl * 8 >= nn
    # its shared memory: the barriers, da and ds, the ring, the staged a, s, the scratch
    assert plan.stride >= -(-d1 // 16) * 16 and (plan.stride * 2) % 128 == 16
    # each warp's part of the ring (its items take its slots in turn): 2 to 4
    # (1 only where no candidate leaves room for 2: D1 = 2000 here)
    assert plan.ring % warps == 0 and (2 if d1 < 2000 else 1) <= plan.ring // warps <= 4
    assert plan.ring <= cuda_spectral.TC_MAX_RING
    assert plan.stage_acts in (0, 1) and plan.item_steps in (1, 2, 4)
    assert plan.smem == (cuda_spectral.TC_BAR_BYTES + 2 * 16 * bm * plan.stride * 2
                         + plan.ring * p * nt * 256 + warps * 768
                         + plan.stage_acts * 4 * 16 * d1 * act_bytes) <= cuda_graph.SMEM_PER_BLOCK
    # the weight gradients: every (k, column) of each GLU in one block a
    # segment, in the kernel's order of units
    ntn = -(-d1 // cuda_spectral.WG_N)
    units = []
    for gi in range(6):
        din = d0 if gi < 2 else d1
        units += [(gi, din, m, c) for m in range(-(-din // cuda_spectral.WG_M))
                  for c in range(ntn)]
    assert plan.wgrad_units == len(units)
    for gi in range(6):
        din = d0 if gi < 2 else d1
        cover = np.zeros((din, d1), int)
        for ugi, _, m, c in units:
            if ugi == gi:
                cover[m * 128:(m + 1) * 128, c * 128:(c + 1) * 128] += 1
        assert (cover == 1).all()
    # every 64-row chunk in exactly one segment; a cluster of a power of 2 up
    # to 8, the most that keep one block an SM
    assert 1 <= plan.nseg <= cuda_spectral.WG_MAX_CLUSTER and plan.nseg & (plan.nseg - 1) == 0
    assert plan.nseg == 1 or plan.nseg * plan.wgrad_units <= SMS
    assert (2 * plan.nseg > min(cuda_spectral.WG_MAX_CLUSTER, plan.chunks)
            or 2 * plan.nseg * plan.wgrad_units > SMS)
    chunk_seen = np.zeros(plan.chunks, int)
    for lo, hi in _ranges(plan.chunks, plan.nseg):
        chunk_seen[lo:hi] += 1
    assert (chunk_seen == 1).all()
    # the scratch: the packed weights, 17 transposed planes, the column sums
    assert plan.workspace_floats * 4 == (
        2 * plan.items * p * nt * 256
        + plan.chunks * (16 * -(-d1 // 8) + -(-d0 // 8)) * 1024 + 4 * plan.clusters * 12 * d1)


@pytest.mark.parametrize("act_bytes", [4, 2], ids=["f32_planes", "bf16_planes"])
def test_bwd_tc_plan_fills_the_card_at_the_flagship(act_bytes):
    """The flagship's 280 m tiles go to 66 clusters of 2 (132 blocks, one an
    SM: 80 rows on the busiest, as the parent's 112 blocks of 80 rows had,
    but no SM idle), six warps of 5 n8 tiles and a producer (224 threads: 255
    registers a thread), a and s staged in shared memory, items of 4 k16
    steps; the weight gradients on 20 blocks of 128 by 128 in 4 row segments
    (80 blocks in clusters of 4)."""
    plan = cuda_spectral.bwd_tc_plan(32, K, 140, 12, 60, SMS, act_bytes)
    assert (plan.m_tiles, plan.n_tiles, plan.warps, plan.threads) == (5, 5, 6, 224)
    assert 2 * plan.clusters == SMS and plan.stage_acts == 1 and plan.item_steps == 4
    assert max(hi - lo for lo, hi in _ranges(280, plan.clusters)) == 5 == plan.m_tiles
    assert (plan.wgrad_units, plan.nseg) == (20, 4)
    assert plan.ring == (12 if act_bytes == 4 else 18)  # 2 or 3 items a warp


def _rnd(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _panels(a, bnk, k):
    """sum over 16-column panels p, ascending, of a[:, p] @ bnk[:, p].T (a's
    columns padded to whole panels with zeros): the f32 order of a warp's
    tensor-core sums."""
    acc = torch.zeros(a.shape[0], bnk.shape[0])
    for p in range(0, k, 16):
        acc = acc + a[:, p: p + 16] @ bnk[:, p: p + 16].T
    return acc


def emulate_bwd_tc(x, glu, g, acts, multi, plan):
    """The bf16 reread backward as `spectral_bwd_rows_tc_kernel` and
    `spectral_wgrad_wg_kernel` compute it (acts f32, or bf16 for the
    bf16-storage arm: their rounded values) -> (dx, dglu) like
    `spe_seq_cell_bwd_reread_plain`."""
    b, k, n, w = x.shape
    wm = w * multi
    d0, d1, rows = k * w, k * wm, b * n
    rp = plan.rows64  # the rows kernel's rows: zeros past the saved ones
    cf, sf, ci, si = torch_impl._dft_tensors(w, k, wm, x.device, torch.float32)
    weights = [(_rnd(wl), _rnd(wr)) for wl, wr in torch_impl._folded_glu_weights(glu, cf, sf)]
    pad = lambda t: torch.cat([t, t.new_zeros(rp - t.shape[0], *t.shape[1:])])  # noqa: E731
    gr = pad(_rnd(torch_impl._rows(g)))
    a_s = [pad(acts[i, :rows].float()) for i in range(12)]
    xr = pad(_rnd(torch_impl._rows(x)))
    blocks = [(16 * lo, 16 * hi) for lo, hi in _ranges(rp // 16, plan.clusters)]
    dxc, dacts, us, bparts = [], [None] * 12, [None] * 4, [None] * 12
    for chain, idft in ((0, ci), (1, si)):
        d = _panels(gr, _rnd(idft), d1)  # block diagonal and symmetric: its own [N][K]
        for layer in (2, 1, 0):
            gi = 2 * layer + chain
            a, s = a_s[2 * gi], a_s[2 * gi + 1]
            da, ds = d * s, d * a * (s * (1.0 - s))
            for side, v in ((0, da), (1, ds)):  # a rows block's column sums
                bparts[2 * gi + side] = torch.stack([v[lo:hi].sum(dim=0) for lo, hi in blocks])
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
    segs = _ranges(plan.chunks, plan.nseg)
    dglu = []
    for gi in range(6):
        u = xr if gi < 2 else us[gi - 2]
        out = []
        for side, v in ((0, dacts[2 * gi]), (1, dacts[2 * gi + 1])):
            total = torch.zeros(u.shape[1], d1)
            for lo, hi in segs:  # a segment's 64-row chunks, 16 rows a step; the segments in order
                acc = torch.zeros(u.shape[1], d1)
                for r in range(64 * lo, 64 * hi, 16):
                    acc = acc + u[r: r + 16].T @ v[r: r + 16]
                total = total + acc
            parts, nseg = bparts[2 * gi + side], plan.nseg
            bias = torch.zeros(d1)
            for z in range(nseg):  # rank z's parts in order, then the ranks in order
                acc = torch.zeros(d1)
                for p_ in range(z * len(parts) // nseg, (z + 1) * len(parts) // nseg):
                    acc = acc + parts[p_]
                bias = bias + acc
            out.append((total, bias))
        (dwl, dbl), (dwr, dbr) = out
        if gi < 2:
            fold = cf if gi == 0 else sf
            dwl, dwr = fold.T @ dwl, fold.T @ dwr
        dglu.append({"left": {"w": dwl, "b": dbl}, "right": {"w": dwr, "b": dbr}})
    return dx, dglu


@pytest.mark.parametrize("b,n,w,multi", [(32, 140, 12, 5), (5, 37, 7, 5)],
                         ids=["flagship", "W7"])
def test_tc_blocking_meets_the_bf16_rule(b, n, w, multi):
    smoke = _chip_smoke()
    rng = np.random.default_rng(11)
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=multi)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    x = torch.from_numpy(rng.standard_normal((b, K, n, w)).astype(np.float32))
    g = torch.from_numpy((1e-3 * rng.standard_normal((b, K, n, w * multi))).astype(np.float32))
    with torch.no_grad():
        _, acts = torch_impl.spe_seq_cell_save(x, glu, multi, "bfloat16")
        plan = cuda_spectral.bwd_tc_plan(b, K, n, w, w * multi, SMS)
        got = emulate_bwd_tc(x, glu, g, acts, multi, plan)
        want = torch_impl.spe_seq_cell_bwd_reread(x, glu, g, acts, multi, "bfloat16")
        want32 = torch_impl.spe_seq_cell_bwd_reread(x, glu, g, acts, multi)
    flat = [[dx] + cuda_spectral._flat(dg) for dx, dg in (got, want, want32)]
    bad, err, ratio, rel = smoke.bf16_agreement(*flat, smoke.BF16_ATOL_REL)
    assert not bad and ratio >= smoke.BF16_CLOSER, (bad, err, ratio, rel)
    # and the emulation is no copy of the plain version: another sum order
    assert any(not torch.equal(a, c) for a, c in zip(flat[0], flat[1]))


@pytest.fixture(autouse=True)
def _launch_counts_restored():
    """The wrappers count the launches the fake C entries below stand for:
    each test leaves the counts as it found them, for the tests after it in
    this process."""
    before = ops.launches()
    yield
    for name, n in before.items():
        ops.KERNELS[name].launches = n


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
    monkeypatch.setattr(_build, "card_limits", lambda device: (SMS, 232_448))
    mul_l, x = torch.zeros((4, 140, 140)), torch.ones((32, 140, 12))
    for cd in ("bfloat16", "float32"):
        cuda_graph._launch_fwd(mul_l, x, cd)
        name = "cheb_graph_conv_fwd_bf16" if cd == "bfloat16" else "cheb_graph_conv_fwd"
        (args,) = fakes[name].calls
        assert args[:2] == (mul_l.data_ptr(), x.data_ptr())
        # (K, M, N, B, W): the square call's rows are its columns; then the
        # plan: the tensor-core kernel's (tm, tb, tw, tn, cluster, smem) on
        # the card's SMs for the bf16 arm, the f32 kernel's for the f32 arm
        if cd == "bfloat16":
            plan = cuda_graph.mma_plan(4, 140, 32, 12, SMS)
            assert args[3:14] == (4, 140, 140, 32, 12, *plan.c_args())
        else:
            plan = cuda_graph.launch_plan(4, 140, 32, 12)
            assert args[3:13] == (4, 140, 140, 32, 12, plan.panel, plan.row_stride,
                                  plan.batch_stride, plan.threads, plan.smem)


@pytest.mark.parametrize("reread", [True, False], ids=["reread", "recompute"])
def test_spectral_backwards_hand_the_kernels_the_f32_cotangent(monkeypatch, reread):
    b, n, w, multi = 5, 37, 7, 5
    wm = w * multi
    fakes = {}
    plan = cuda_spectral.bwd_tc_plan(b, K, n, w, wm, SMS)
    sizes = {"spectral_act_floats": 12 * plan.rows_pad * K * wm,
             "spectral_bwd_grad_floats": 2 * 2 * (K * w * K * wm + K * wm)
             + 4 * 2 * (K * wm * K * wm + K * wm),
             "spectral_bwd_reread_bf16_workspace_floats": plan.workspace_floats,
             "spectral_bwd_bf16_workspace_floats": plan.workspace_floats
             + 12 * plan.rows_pad * K * wm, "spectral_bwd_bf16_smem": plan.smem}
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
    assert args[-tail - 8:-tail] == (cuda_spectral.N_SPLIT,) + plan.args
    assert args[-tail - 13:-tail - 8] == (b, K, n, w, wm)
    # the plan is asked of the kernels first: its scratch and its rows block
    assert fakes["spectral_bwd_bf16_smem"].calls == [(b, K, n, w, wm) + plan.args + (4,)]
