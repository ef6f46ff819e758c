#!/usr/bin/env python3
"""Drive stemgnn_tpu_torch's serving, training and bench paths on one NVIDIA
GPU and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. device: CUDA present; the card's name and power limit from nvidia-smi;
     TF32 off for every f32 comparison.
  2. build: nvcc of every kernel source in stemgnn_tpu_torch/csrc.
  3. kernels: each of the eighteen kernels at the shapes its path gives it (the
     ECG flagship: N=140, W=12, multi_layer=5, batch 32; the grid GRU forward
     and backward: the 512-node model of phase 4), held against its plain
     PyTorch version on the card. The forward kernels run on inputs that the
     model's own plain path computes from the first test batch; the backward
     kernels on the activations and cotangents of one train step of the
     port's CPU plain path on the first training batch. Device times come
     from CUDA events around replays of a captured CUDA graph of many calls;
     beside them the least time the card could take (bytes or f32 operations
     at published H100 SXM peaks) and a one-call PyTorch yardstick where one
     exists (cuDNN's nn.GRU for the GRU kernels). The spectral reread
     backward's gradients must equal the recompute backward's bit for bit.
     The GRU forward across a cluster and across the grid (both variants)
     and the graph convolution are also held against their plain versions,
     untimed, at ragged batches, at hidden sizes no cluster size divides, at
     hidden sizes that take the grid route, and at an N the graph
     convolution walks in panels; the GRU backward at B = 1 to 64 and H = 20
     to 512 (both routes), twice, bitwise; the grid kernels through their
     own entry points at B = 32, H = 512; B = 8, H = 1024; B = 1, 8, 64 at
     H = 361 and 512; B = 8 at H = 1300 and 2500 (the slice of W_hh^T read
     from L2), N = H, within GRID_ATOL_REL of each array's largest entry,
     the backward twice, bitwise; the grid kernels at synthetic-1k's shape
     (B = 8, H = N = 1024) timed beside the plain versions, the bound and
     cuDNN. The spectral forwards (the output and the 12 saved arrays) and
     backwards of both arms at row counts no multiple of their row tiles and
     at other windows and multipliers (W = 7, 10, 25, 28, 35, 100; multi 6,
     15: D1 up to 2000), and past D1 = 2048 on inputs of seeds 0 and 1 (W =
     103 on 240 and 600 rows, D1 = 2060; multi 64 on 240 rows, D1 = 3072;
     timed beside their bounds), the backwards twice, bitwise; bf16 past
     D1 = 720 against the bf16 plain version with f64 sums
     (`bf16_noise_agreement`). The spectral kernels are timed at the
     COVID-19 shape too (N = 25, W = 28, multi 5, batch 32). The five bf16
     arms (compute_dtype "bfloat16": the graph conv and the four spectral
     entries) at the flagship's shapes against their bf16 plain versions,
     each array within BF16_ATOL_REL of its largest entry and closer to the
     bf16 plain result than to the f32 one; their bound at the bf16
     tensor-core rate; the bf16 spectral backward twice bitwise and its
     reread bitwise its recompute (up to D1 = 2048 the bf16 forwards and
     backwards run on tensor cores, mma.sync, so every bf16 shape above
     holds those kernels; the profiler shows each bf16 saving forward on the
     chain kernel of its route). The redesigned bf16 wrappers' times beside
     their parent design's (PARENT_DESIGN_MS), their bounds and the f32
     arms'; both bf16 forwards and the bf16 recompute backward on the chain
     kernel on tensor cores, and the bf16 graph conv one kernel a call
     (torch.profiler: no cast kernel before it). The bf16-storage arm of the
     saving pair (SAVE_ACTS_F32 off: `spectral_fwd_save_bf16acts`,
     `spectral_bwd_reread_bf16acts`) at the flagship beside the f32-storage
     arm's times, and at every spectral shape above: its 12 bf16 planes
     bitwise the f32-storage planes rounded to bf16, its output bitwise, two
     rereads bitwise, both held to the arm's plain versions by the bf16 rules;
     both storage arms timed at the COVID-19 shape and past D1 = 2048.
  4. serving path: ECG_data through the port's entry points on the card
     (split, train-split norm stats, init_params(0), checkpoint.save,
     engine.test), with the launch counters set to 0 just before and read
     just after; then the test-split forecasts against the port's CPU plain
     path, and eval windows/s; the same at compute_dtype bfloat16 (engine.test,
     counters, forecasts against the CPU bf16 plain path). Then a 512-node
     model (a hidden size whose slices fit no cluster, so `gru_over_nodes`
     launches the grid kernel) through engine.inference_batched on a seeded
     series, counters set to 0 just before and read just after, against the
     CPU plain path; and one train step of it (the grid GRU backward),
     counters again, its loss and gradients against the CPU plain path; the
     same train step at synthetic-1k's shape (N = 1024, batch 8). Then the
     same, a batch and a train step, for the COVID-19 shape (the README's
     COVID-19 command: N = 25, W = 28, horizon 28, multi 5) on a seeded series.
  5. train path: engine.train on the card, one epoch of ECG_data with its
     validate pass (batch 32, RMSProp, dropout 0.5), counters set to 0 just
     before and read just after and held against the expected launches per
     step (the spectral pair a train step launches follows
     ops.cuda_spectral.SAVE_ACTS_BWD); the epoch's loss, checkpoints and metrics.jsonl; one step's loss
     and gradients against the CPU plain path with the same dropout mask;
     the same step twice, bitwise; the same two at compute_dtype bfloat16
     against the CPU bf16 plain path; one epoch of engine.train at bfloat16
     with its counters; the bf16 step with the bf16-storage arm
     (SAVE_ACTS_F32 off) against the CPU bf16 plain path with the same switch,
     twice, bitwise, with its counters; one step at param_dtype bfloat16 at
     each compute_dtype against the CPU, every gradient's and moment's dtype
     the JAX package's (f32 for the leaves whose gradient a kernel returns);
     three RMSProp steps against the CPU; and train windows/s.
  6. chunk path: one 16-step chunk through engine.make_epoch_fn (a captured
     CUDA graph) against the same steps through the eager train step: losses,
     parameters and optimizer state bitwise equal; the same at param_dtype
     bfloat16 (bf16 parameters, f32 and bf16 moments).
  7. bench path: bench.measure and bench.measure_eval at full width, their
     results as JSON lines; the train step with the spectral saving forward
     and reread backward (SAVE_ACTS_BWD on) against the recompute backward,
     in the order recompute, reread, reread, recompute; a one-step graph
     replayed per step beside the 64-step graph; the train step at
     compute_dtype bfloat16 with each spectral backward; the bf16 reread step
     with each storage of the saved arrays, in the order f32, bf16, bf16,
     f32; the eager eval loop beside the eval program, and the eval program
     at bfloat16.
  8. asynchronous checkpoint: one submit, wait, load, compare with the live
     parameters and optimizer state; the same for phase 6's bf16 parameters
     and mixed-dtype moments, dtype for dtype.
  9. a `kernels` JSON line (launches summed over the paths: calls of the
     wrappers plus what replays of captured graphs launched; every kernel at
     least once), then the result line.

It imports nothing of JAX or of stemgnn_tpu.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # tensor cores: the rate for bf16 operands

# ECG flagship: python main.py defaults on dataset/ECG_data.csv
BATCH, WINDOW, MULTI, HORIZON = 32, 12, 5, 3
# the widest model the JAX package's Pallas GRU takes: its GRU's slices fit
# no cluster of 8 blocks, so its recurrences go across the whole grid
BIG_NODES = 512
# the JAX package's synthetic-1k suite cell (benchmarks/suite.py
# LARGE_CONFIGS): 1024 nodes, batch 8, the flagship's window and multi
S1K_NODES, S1K_BATCH = 1024, 8
# the README's COVID-19 command (--window_size 28 --horizon 28, multi_layer 5):
# 25 nodes, D1 = 560, the JAX package's COVID-19 suite cell (benchmarks/suite.py)
COVID_NODES, COVID_WINDOW, COVID_HORIZON = 25, 28, 28


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds of one call of fn: `calls` calls captured in one
    CUDA graph, the graph replayed `replays` times between two CUDA events,
    the interval over calls * replays. The replay leaves out each call's
    host work (Python checks, ctypes, allocation)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # caches, library plans and workspaces
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def stream_ms(fn, calls: int = 30) -> float:
    """Milliseconds per call of `calls` eager calls in a row between two CUDA
    events, after three warm calls: for work that is not captured in a graph
    (an autograd backward). Host work shows where it outlasts the device's."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def call_ms(fn, reps: int = 20) -> float:
    """Median milliseconds from before one eager call of fn to the end of
    its work on the card: host work, launch and device time together."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class OpRecorder:
    """For one forward and backward of the model: keeps, for each call of the
    four op wrappers of `stemgnn_tpu_torch.ops`, its arguments, its output and
    the cotangent that reaches the output."""

    NAMES = ("gru_over_nodes", "attention_kq", "cheb_graph_conv", "spe_seq_cell")

    def __init__(self, ops):
        self.ops = ops
        self.calls = {name: [] for name in self.NAMES}

    def __enter__(self):
        self._orig = {name: getattr(self.ops, name) for name in self.NAMES}
        for name, fn in self._orig.items():
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.ops, name, fn)
        return False

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            call = {"args": args, "out": out.detach(), "g": None}
            out.register_hook(lambda g: call.__setitem__("g", g.detach()))
            self.calls[name].append(call)
            return out

        return wrapped


def step_grads(params, mcfg, x, y, mask, compute_dtype="float32"):
    """Loss and the gradient of every parameter for one batch with the given
    dropout mask, through the port's own forward at `compute_dtype`; a
    parameter the loss does not reach gets zeros, as in the engine's train
    step."""
    import torch

    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.models.convert import flatten_params

    flat = flatten_params(params)
    for p in flat.values():
        p.grad = None
    forecast, _ = stemgnn.forward(params, mcfg, x, training=True, dropout_mask=mask,
                                  compute_dtype=compute_dtype)
    loss = torch.mean((forecast - y) ** 2)
    loss.backward()
    return loss.detach(), {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                           for k, p in flat.items()}


# One train step's gradients on the card against the CPU plain path's: f32
# sums in another order through 140 (512) GRU steps and 4480-row (16384-row)
# weight gradients, so each gradient is held to 1e-4 of its own largest entry
# (atol) plus rtol 1e-3.
GRAD_ATOL_REL, GRAD_RTOL = 1e-4, 1e-3


def compare_grads(grads, grads_cpu, atol_rel=GRAD_ATOL_REL, rtol=GRAD_RTOL):
    """(leaves out of tolerance as (name, err, largest entry), the worst
    max_abs_err, its leaf)."""
    import torch

    worst, worst_name, bad = 0.0, "", []
    for k, g_cpu in grads_cpu.items():
        g = grads[k].detach().cpu()
        err = (g - g_cpu).abs().max().item()
        if err > worst:
            worst, worst_name = err, k
        atol = atol_rel * g_cpu.abs().max().item() + 1e-12
        if not torch.allclose(g, g_cpu, atol=atol, rtol=rtol):
            bad.append((k, err, g_cpu.abs().max().item()))
    return bad, worst, worst_name


# The bf16 arms against their bf16 plain versions. Both round to bf16 at the
# same points and sum in f32, in another order; where a sum lands on the other
# side of a bf16 rounding boundary, the rounded value moves by one bf16 ulp,
# 2^-8 of it, and the move spreads through the later layers (on the CPU the
# plain bf16 spectral backward with f32 sums and with f64 sums differ by up to
# 1.4e-3 of a gradient's largest entry). So each array of a bf16 spectral arm
# (an output, a saved array, dx, a gradient) is held to 2^-8 of its own
# largest entry, and, so that no f32 computation can pass for a bf16 one, the
# arm's results must lie at least BF16_CLOSER times closer (in L2 over all of
# them) to the bf16 plain version than to the f32 plain version. The graph
# conv's bf16 arm has no rounding after its products: it keeps the f32 arm's
# tolerance, scaled to its largest entry.
BF16_ATOL_REL = 2.0 ** -8
BF16_CLOSER = 4.0
# Arrays stored as bf16 (the bf16-storage arm's 12 saved planes) are held to
# the same, plus one bf16 ulp of each value (2^-7 of it at most): the f32 a
# and s of two sum orders round to neighbouring bf16 where they straddle a
# rounding boundary.
BF16_ULP = 2.0 ** -7


def bf16_agreement(got, want, want_f32, atol_rel, rtol=0.0):
    """(arrays out of tolerance by index, the worst max_abs_err, the L2 distance
    to the f32 plain result over that to the bf16 one, the worst max_abs_err of
    an array over its largest entry). got, want, want_f32: lists of tensors;
    each array of got within atol_rel of the largest entry of its want (and
    rtol)."""
    import torch

    bad, worst, worst_rel, d_bf16, d_f32 = [], 0.0, 0.0, 0.0, 0.0
    for i, (g, w, w32) in enumerate(zip(got, want, want_f32)):
        g, w, w32 = g.detach().float().cpu(), w.detach().float().cpu(), w32.detach().float().cpu()
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale > 0 else (math.inf if err else 0.0))
        if not torch.allclose(g, w, atol=atol_rel * scale + 1e-30, rtol=rtol):
            bad.append(i)
        d_bf16 += ((g - w).double() ** 2).sum().item()
        d_f32 += ((g - w32).double() ** 2).sum().item()
    ratio = math.sqrt(d_f32 / d_bf16) if d_bf16 > 0 else math.inf
    return bad, worst, ratio, worst_rel


# Past D1 = 720 the fixed 2^-8 above cannot judge a bf16 spectral arm: the
# bf16 plain version's own f32 sum order moves it by more than that. Measured
# on the CPU (torch 2.13; the bf16 plain saving forward and reread backward,
# GLU weights of init_params(0), x and 1e-3 * g from numpy's generator at
# seeds 0 and 1): the worst array's max |difference| over its largest entry
# between f32 sums and f64 sums of the same bf16 roundings, and the f32 plain
# version's distance to the f64-sum one:
#   rows (B x N)   W, multi  D1    forward           backward          f32 plain
#   185 (5 x 37)   12, 5     240   9.4e-4, 7.5e-4    1.27e-3, 1.33e-3  7.7e-3, 7.9e-3
#   185 (5 x 37)   35, 5     700   1.28e-3, 1.23e-3  3.14e-3, 2.89e-3  7.7e-3, 7.2e-3
#   240 (4 x 60)   35, 5     700   2.15e-3, 1.75e-3  2.57e-3, 3.89e-3  7.0e-3, 7.8e-3
#   240 (4 x 60)   100, 5    2000  1.82e-3, 1.76e-3  4.58e-3, 5.04e-3  9.3e-3, 8.3e-3
#   240 (4 x 60)   103, 5    2060  3.07e-3, 3.26e-3  4.16e-3, 5.73e-3  8.0e-3, 8.3e-3
#   600 (10 x 60)  103, 5    2060  3.37e-3, 4.29e-3  3.62e-3, 3.38e-3  8.7e-3, 7.9e-3
#   240 (4 x 60)   12, 64    3072  1.11e-3, 9.4e-4   2.65e-3, 2.33e-3  6.7e-3, 7.0e-3
# So a kernel that is exactly right would fail a fixed 2^-8 there about half
# the time, and max errors alone cannot tell bf16 from f32. Past D1 = 720 a
# bf16 arm is held instead to the plain version with f64 sums (P64), with the
# f32-sum plain version's own distance to it (P32 - P64) as the scale:
#   1. each array: max|K - P64| <= max(2^-8 max|P64|, 2 max|P32 - P64|);
#   2. over all arrays: |K - P64|_2 <= 2 |P32 - P64|_2 (no noisier than the
#      plain version's own sum order, a factor 2 for another order);
#   3. as below D1 = 720: |K - F|_2 >= BF16_CLOSER |K - P32|_2 (F: the f32
#      plain version), which no f32 computation passes.
BF16_NOISE_D1 = 720      # the widest D1 whose bf16 arms keep the fixed 2^-8 rule
BF16_NOISE_FACTOR = 2.0


def bf16_noise_agreement(got, p64, p32, f32):
    """The bf16 rule past D1 = BF16_NOISE_D1 (above) for one set of arrays
    (lists of tensors: the kernel's, the f64-sum and f32-sum bf16 plain
    versions', the f32 plain version's): (failures as labels, the worst
    max_abs_err of an array over its largest P64 entry, |K - P64|_2 /
    |P32 - P64|_2, |K - F|_2 / |K - P32|_2)."""
    import torch

    bad, worst_rel, d_k64, d_3264, d_kf, d_k32 = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for i, arrays in enumerate(zip(got, p64, p32, f32)):
        k, a64, a32, f = (t.detach().double().cpu() for t in arrays)
        err, noise = torch.dist(k, a64, math.inf).item(), torch.dist(a32, a64, math.inf).item()
        scale = a64.abs().max().item()
        worst_rel = max(worst_rel, err / scale if scale > 0 else (math.inf if err else 0.0))
        if not err <= max(BF16_ATOL_REL * scale, BF16_NOISE_FACTOR * noise):
            bad.append(str(i))
        d_k64 += torch.dist(k, a64).item() ** 2
        d_3264 += torch.dist(a32, a64).item() ** 2
        d_kf += torch.dist(k, f).item() ** 2
        d_k32 += torch.dist(k, a32).item() ** 2
    noise_ratio = math.sqrt(d_k64 / d_3264) if d_3264 > 0 else (math.inf if d_k64 else 0.0)
    closer = math.sqrt(d_kf / d_k32) if d_k32 > 0 else math.inf
    if not noise_ratio <= BF16_NOISE_FACTOR:
        bad.append(f"L2 {noise_ratio:.2f} times the plain version's own noise")
    if not closer >= BF16_CLOSER:
        bad.append(f"{closer:.1f} times closer")
    return bad, worst_rel, noise_ratio, closer


def spectral_plain_arrays(x, glu, g, multi: int, compute_dtype: str, dtype=None,
                          act_dtype: str = "float32"):
    """(forward arrays, backward arrays) of the spectral plain versions on x
    [B, K, N, W], the six GLU dicts and g [B, K, N, W * multi], in `dtype`
    (default x's; float64 copies of the same values give the f64-sum plain
    version): the forward's output twice (serving and saving) and its 12
    saved arrays (stored in `act_dtype`); the reread backward's dx and 24
    gradients on them (with f32 storage, the recompute backward's)."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    dtype = dtype or x.dtype
    x, g = x.to(dtype), g.to(dtype)
    glu = [{s: {k: t.to(dtype) for k, t in p[s].items()} for s in p} for p in glu]
    with torch.no_grad():
        out, acts = cuda_spectral.spe_seq_cell_save_plain(x, glu, multi, compute_dtype,
                                                          act_dtype)
        dx, dglu = cuda_spectral.spe_seq_cell_bwd_reread_plain(x, glu, g, acts, multi,
                                                               compute_dtype)
    return [out, out] + list(acts), [dx] + cuda_spectral._flat(dglu)


def leaf_params(params, device):
    """A copy of the tree on `device` whose leaves require a gradient."""
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params

    return unflatten_params({
        k: v.detach().to(device).clone().requires_grad_(True)
        for k, v in flatten_params(params).items()})


def cudnn_gru_like(gru, dev, train: bool = False):
    """torch.nn.GRU (cuDNN on the card) with the weights of the port's `gru`
    tree: the library yardstick of the GRU kernels, used nowhere in the port."""
    import torch

    h3, w = gru["w_ih"].shape
    mod = torch.nn.GRU(w, h3 // 3).to(dev)
    mod.train(train)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(gru["w_ih"])
        mod.weight_hh_l0.copy_(gru["w_hh"])
        mod.bias_ih_l0.copy_(gru["b_ih"])
        mod.bias_hh_l0.copy_(gru["b_hh"])
    return mod


def backward_cases(rec, params, mcfg, dev):
    """The three backward kernels, as `forward_cases`, on what one train step
    of the CPU plain path saved and sent back (`rec`, an OpRecorder)."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_attention, cuda_gru, cuda_spectral
    from stemgnn_tpu_torch.ops import torch_impl

    def on_card(t):
        return t.detach().to(dev).contiguous()

    gru = {k: v.detach() for k, v in params["gru"].items()}
    call = rec.calls["gru_over_nodes"][0]
    x = on_card(call["args"][1])
    g_gru = on_card(call["g"])  # [B, N, H]
    b, w, n = x.shape
    with torch.no_grad():
        x_proj = torch_impl.gru_input_projection(gru, x).contiguous()
        a_all = gru["w_hh"].T.contiguous()
        _, saved = torch_impl.gru_scan(x_proj, a_all, gru["b_hh"], save=True)

    _, cudnn_fwd_bwd = cudnn_gru_calls(gru, x, g_gru)

    call = rec.calls["attention_kq"][0]
    key, query = on_card(call["args"][0]), on_card(call["args"][1])
    alpha = call["args"][2]
    p_att, g_att = on_card(call["out"]), on_card(call["g"])

    call = rec.calls["spe_seq_cell"][0]
    gfted, g_spe = on_card(call["args"][0]), on_card(call["g"])
    multi = call["args"][2]
    glu = [{s: {leaf: t.detach() for leaf, t in p[s].items()} for s in p}
           for p in params["blocks"][0]["glu"]]
    k = gfted.shape[1]
    wm = w * multi
    d0, d1 = k * w, k * wm
    rows = b * n
    glu_w = sum(t.numel() for t in cuda_spectral._flat(glu))
    glu_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1)

    def flat_spe(res):
        dx, dglu = res
        return torch.cat([dx.reshape(-1)] + [t.reshape(-1) for t in
                                             cuda_spectral._flat(dglu)])

    with torch.no_grad():
        _, acts = cuda_spectral.spe_seq_cell_save(gfted, glu, multi)
    # the products back to the inputs and the weight-gradient products (each
    # the six GLUs' size), the inverse DFT backwards per order block, the fold
    # and the unfold
    reread_flops = 2 * glu_flops + 2 * rows * 2 * k * wm * wm + 16 * k * w * w * d1
    spe_bytes = 4 * (2 * rows * d0 + rows * d1 + 2 * glu_w)

    return [
        ("gru_bwd", "stemgnn_tpu_torch/csrc/gru.cu",
         "stemgnn_tpu/ops/pallas_gru.py:132",
         lambda: cuda_gru.gru_scan_bwd(saved, g_gru, a_all),
         lambda: cuda_gru.gru_scan_bwd_plain(saved, g_gru, a_all),
         ("graph_or_stream", cudnn_fwd_bwd),  # cuDNN forward plus backward
         # 140 dependent steps of 420-term sums in another order than cuBLAS
         1e-5, 1e-4, *gru_bwd_work(saved, g_gru, a_all)),
        ("attention_kq_bwd", "stemgnn_tpu_torch/csrc/attention.cu",
         "stemgnn_tpu/ops/pallas_attention.py:65",
         lambda: torch.cat(cuda_attention.attention_kq_bwd(
             key, query, p_att, g_att, alpha)),
         lambda: torch.cat(cuda_attention.attention_kq_bwd_plain(
             key, query, p_att, g_att, alpha)),
         None,
         # 140-term sums of products of softmax outputs in another order
         1e-5, 1e-4,
         4 * (4 * b * n + 2 * b * n * n),
         8 * b * n * n),
        ("spectral_bwd", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:250",
         lambda: flat_spe(cuda_spectral.spe_seq_cell_bwd(gfted, glu, g_spe, multi)),
         lambda: flat_spe(cuda_spectral.spe_seq_cell_bwd_plain(gfted, glu, g_spe,
                                                               multi)),
         None,
         # 4480-term f32 sums (weight gradients) in another order than cuBLAS,
         # dx and all 24 gradients held as one vector
         1e-5, 1e-3,
         spe_bytes,
         glu_flops + reread_flops),  # the recompute and the reread's work
        ("spectral_bwd_reread", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:420",
         lambda: flat_spe(cuda_spectral.spe_seq_cell_bwd_reread(gfted, glu, g_spe,
                                                                acts, multi)),
         lambda: flat_spe(cuda_spectral.spe_seq_cell_bwd_reread_plain(
             gfted, glu, g_spe, acts, multi)),
         None,
         1e-5, 1e-3,  # as spectral_bwd
         spe_bytes + 4 * 12 * rows * d1,  # and the 12 saved arrays read once
         reread_flops),
    ]


def forward_inputs(params, mcfg, x):
    """(key, query, mul_L, feat, gfted): the forward kernels' inputs as the
    plain path computes them from the batch x [B, W, N]."""
    import torch

    from stemgnn_tpu_torch.ops import torch_impl

    with torch.inference_mode():
        enc = torch_impl.gru_over_nodes(params["gru"], x).transpose(1, 2)
        key = (enc @ params["weight_key"])[..., 0].contiguous()
        query = (enc @ params["weight_query"])[..., 0].contiguous()
        att = torch_impl.attention_from_kq(key, query, mcfg.leaky_rate)
        mul_L = torch_impl.laplacian_from_attention(att)[0].contiguous()
        feat = x.permute(0, 2, 1).contiguous()
        gfted = torch_impl.cheb_graph_conv(mul_L, feat).contiguous()
    return key, query, mul_L, feat, gfted


def forward_cases(params, mcfg, x):
    """(name, source, replaces, kernel call, plain call, library call or None,
    atol, rtol, bytes, flops) at the main path's shapes. The inputs are what
    the plain path computes from the batch x [B, W, N]."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_attention, cuda_graph, cuda_gru
    from stemgnn_tpu_torch.ops import cuda_spectral

    b, w, n = x.shape
    k = 4
    wm = w * mcfg.multi_layer
    d0, d1 = k * w, k * wm
    rows = b * n
    gru = params["gru"]
    key, query, mul_L, feat, gfted = forward_inputs(params, mcfg, x)
    glu = params["blocks"][0]["glu"]

    cudnn_gru = cudnn_gru_like(gru, x.device)
    xs = x.permute(2, 0, 1).contiguous()  # [N, B, W], cuDNN's sequence-major input
    xt = feat.permute(1, 0, 2).reshape(n, b * w).contiguous()  # [N, B*W]
    lk = mul_L[1:].contiguous()

    glu_w = sum(p[s]["w"].numel() + p[s]["b"].numel() for p in glu
                for s in ("left", "right"))
    # six GLUs, the inverse DFT and the fold, the two DFTs counted per order
    # block: their off-diagonal blocks are zeros
    spe_flops = (2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm)
                 + 8 * k * w * w * d1)

    def flat_save(res):  # the output and the 12 saved arrays' real rows
        out, acts = res
        return torch.cat([out.reshape(-1), acts[:, :rows].reshape(-1)])

    return [
        ("gru_fwd", "stemgnn_tpu_torch/csrc/gru.cu",
         "stemgnn_tpu/ops/pallas_gru.py:103",
         lambda: cuda_gru.gru_over_nodes(gru, x),
         lambda: cuda_gru.gru_over_nodes_plain(gru, x),
         lambda: cudnn_gru(xs)[0],
         # 140 dependent steps: sums reorder against cuBLAS in each step
         1e-4, 0.0, *gru_fwd_work(gru, x)),
        ("attention_kq_fwd", "stemgnn_tpu_torch/csrc/attention.cu",
         "stemgnn_tpu/ops/pallas_attention.py:29",
         lambda: cuda_attention.attention_kq(key, query, mcfg.leaky_rate),
         lambda: cuda_attention.attention_kq_plain(key, query, mcfg.leaky_rate),
         None,
         1e-6, 0.0,  # outputs <= 1; exp and division differ by an ulp or two
         4 * (2 * b * n + b * n * n),
         6 * b * n * n),
        ("cheb_graph_conv_fwd", "stemgnn_tpu_torch/csrc/graph.cu",
         "stemgnn_tpu/ops/pallas_graph.py:33",
         lambda: cuda_graph.cheb_graph_conv(mul_L, feat),
         lambda: cuda_graph.cheb_graph_conv_plain(mul_L, feat),
         lambda: torch.matmul(lk, xt),
         1e-4, 1e-5,  # 140-term f32 sums in another order than cuBLAS
         4 * (k * n * n + b * n * w + b * k * n * w),
         2 * (k - 1) * n * n * b * w),
        ("spectral_fwd", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:81",
         lambda: cuda_spectral.spe_seq_cell(gfted, glu, mcfg.multi_layer),
         lambda: cuda_spectral.spe_seq_cell_plain(gfted, glu, mcfg.multi_layer),
         None,
         # DFT as f32 products (kernel) against cuFFT (plain), as the CPU test
         # of the Pallas kernel holds them (tests/test_pallas_kernels.py:47)
         5e-4, 1e-4,
         4 * (rows * d0 + glu_w + rows * d1),
         spe_flops),
        ("spectral_fwd_save", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:104",
         lambda: flat_save(cuda_spectral.spe_seq_cell_save(gfted, glu,
                                                           mcfg.multi_layer)),
         lambda: flat_save(cuda_spectral.spe_seq_cell_save_plain(gfted, glu,
                                                                 mcfg.multi_layer)),
         None,
         # both sides take the DFT as f32 products; 240-term sums in another
         # order than cuBLAS through three layers
         5e-4, 1e-4,
         4 * (rows * d0 + glu_w + rows * d1 + 12 * rows * d1),
         spe_flops),
    ]


def bf16_cases(rec, params, mcfg, x):
    """The bf16 arms at the main path's shapes: (name, source, replaces,
    kernel call, bf16 plain call, f32 plain call, library call or None,
    atol as a fraction of each array's largest entry, rtol, bytes, flops).
    Each call returns a list of arrays. The forward arms take what the plain
    path computes from the batch x (as `forward_cases`), the backward arms
    what one train step of the CPU plain path saved and sent back (`rec`, as
    `backward_cases`). Bytes count the kernels' operands as bf16."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_graph, cuda_spectral

    b, w, n = x.shape
    k = 4
    wm = w * mcfg.multi_layer
    d0, d1 = k * w, k * wm
    rows = b * n
    multi = mcfg.multi_layer
    bf = "bfloat16"
    dev = x.device
    _, _, mul_L, feat, gfted = forward_inputs(params, mcfg, x)
    glu = params["blocks"][0]["glu"]
    glu_2d = sum(p[s]["w"].numel() for p in glu for s in ("left", "right"))
    glu_b = sum(p[s]["b"].numel() for p in glu for s in ("left", "right"))
    spe_flops = (2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm)
                 + 8 * k * w * w * d1)
    glu_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1)
    reread_flops = 2 * glu_flops + 2 * rows * 2 * k * wm * wm + 16 * k * w * w * d1

    # the library yardstick of the graph conv: one product of bf16 operands
    # with an f32 result, where this torch build has torch.mm's out_dtype
    lk = mul_L[1:].reshape((k - 1) * n, n).to(torch.bfloat16).contiguous()
    xt = feat.permute(1, 0, 2).reshape(n, b * w).to(torch.bfloat16).contiguous()
    try:
        torch.mm(lk, xt, out_dtype=torch.float32)
        lib = lambda: [torch.mm(lk, xt, out_dtype=torch.float32)]  # noqa: E731
    except (TypeError, RuntimeError) as exc:
        print(f"[3 kernel] cheb_graph_conv_fwd_bf16: this torch build has no "
              f"torch.mm(..., out_dtype=float32) on bf16 operands ({exc}): no library time")
        lib = None

    call = rec.calls["spe_seq_cell"][0]
    g_spe = call["g"].detach().to(dev).contiguous()
    gfted_bwd = call["args"][0].detach().to(dev).contiguous()
    glu_bwd = [{s: {leaf: t.detach() for leaf, t in p[s].items()} for s in p}
               for p in params["blocks"][0]["glu"]]
    with torch.no_grad():
        _, acts = cuda_spectral.spe_seq_cell_save(gfted_bwd, glu_bwd, multi, bf)
        # the bf16-storage arm's planes (SAVE_ACTS_F32 off)
        _, acts16 = cuda_spectral.spe_seq_cell_save(gfted_bwd, glu_bwd, multi, bf, act_dtype=bf)

    def grads(res):
        dx, dglu = res
        return [dx] + cuda_spectral._flat(dglu)

    def saved(res):  # the output and the 12 saved arrays' real rows
        out, a = res
        return [out] + [a[i, :rows] for i in range(12)]

    fwd_bytes = 2 * (rows * d0 + glu_2d) + 4 * (glu_b + rows * d1)
    bwd_bytes = 2 * (rows * d0 + rows * d1 + glu_2d) + 4 * (rows * d0 + glu_2d + glu_b)
    spe = "stemgnn_tpu_torch/csrc/spectral.cu"
    return [
        ("cheb_graph_conv_fwd_bf16", "stemgnn_tpu_torch/csrc/graph.cu",
         "stemgnn_tpu/ops/pallas_graph.py:33",
         lambda: [cuda_graph.cheb_graph_conv(mul_L, feat, bf)],
         lambda: [cuda_graph.cheb_graph_conv_plain(mul_L, feat, bf)],
         lambda: [cuda_graph.cheb_graph_conv_plain(mul_L, feat)],
         lib,
         1e-4, 1e-5,  # the f32 arm's, scaled: no rounding after the products
         2 * (k * n * n + b * n * w) + 4 * b * k * n * w,
         2 * (k - 1) * n * n * b * w),
        ("spectral_fwd_bf16", spe, "stemgnn_tpu/ops/pallas_spectral.py:81",
         lambda: [cuda_spectral.spe_seq_cell(gfted, glu, multi, bf)],
         lambda: [cuda_spectral.spe_seq_cell_plain(gfted, glu, multi, bf)],
         lambda: [cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi)[0]],
         None, BF16_ATOL_REL, 0.0, fwd_bytes, spe_flops),
        ("spectral_fwd_save_bf16", spe, "stemgnn_tpu/ops/pallas_spectral.py:104",
         lambda: saved(cuda_spectral.spe_seq_cell_save(gfted, glu, multi, bf)),
         lambda: saved(cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi, bf)),
         lambda: saved(cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi)),
         None, BF16_ATOL_REL, 0.0, fwd_bytes + 4 * 12 * rows * d1, spe_flops),
        ("spectral_bwd_bf16", spe, "stemgnn_tpu/ops/pallas_spectral.py:250",
         lambda: grads(cuda_spectral.spe_seq_cell_bwd(gfted_bwd, glu_bwd, g_spe, multi, bf)),
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_plain(gfted_bwd, glu_bwd, g_spe,
                                                            multi, bf)),
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_plain(gfted_bwd, glu_bwd, g_spe,
                                                            multi)),
         None, BF16_ATOL_REL, 0.0, bwd_bytes, glu_flops + reread_flops),
        ("spectral_bwd_reread_bf16", spe, "stemgnn_tpu/ops/pallas_spectral.py:420",
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread(gfted_bwd, glu_bwd, g_spe, acts,
                                                             multi, bf)),
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread_plain(
             gfted_bwd, glu_bwd, g_spe, acts, multi, bf)),
         # the f32 plain backward on the same saved arrays
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread_plain(
             gfted_bwd, glu_bwd, g_spe, acts, multi)),
         None, BF16_ATOL_REL, 0.0, bwd_bytes + 4 * 12 * rows * d1, reread_flops),
        # the bf16-storage arm (pallas_spectral.py act_dtype = compute_dtype with
        # SAVE_ACTS_F32 off, :213): the 12 arrays written and read as bf16
        ("spectral_fwd_save_bf16acts", spe, "stemgnn_tpu/ops/pallas_spectral.py:104",
         lambda: saved(cuda_spectral.spe_seq_cell_save(gfted, glu, multi, bf, act_dtype=bf)),
         lambda: saved(cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi, bf, bf)),
         lambda: saved(cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi)),
         # plus one bf16 ulp of each stored value: the kernel's f32 a and s
         # and the plain version's differ by sum order, and where they
         # straddle a rounding the stored bf16 differ by an ulp
         None, BF16_ATOL_REL, BF16_ULP, fwd_bytes + 2 * 12 * rows * d1, spe_flops),
        ("spectral_bwd_reread_bf16acts", spe, "stemgnn_tpu/ops/pallas_spectral.py:420",
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread(gfted_bwd, glu_bwd, g_spe, acts16,
                                                             multi, bf)),
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread_plain(
             gfted_bwd, glu_bwd, g_spe, acts16, multi, bf)),
         # the f32 plain backward on the same bf16 arrays
         lambda: grads(cuda_spectral.spe_seq_cell_bwd_reread_plain(
             gfted_bwd, glu_bwd, g_spe, acts16, multi)),
         None, BF16_ATOL_REL, 0.0, bwd_bytes + 2 * 12 * rows * d1, reread_flops),
    ]


# The grid GRU kernels against their plain recurrences: the output, each of
# the five saved planes and dxp within 1e-5 of their own largest entry (rtol
# 1e-4, as the cluster backward), f32 sums in another order through up to
# 2500 dependent steps, TF32 off.
GRID_ATOL_REL, GRID_RTOL = 1e-5, 1e-4


def grid_cases(params, x, g_gru):
    """The grid GRU forward and backward as `forward_cases` and
    `backward_cases` give the others, at the shapes of the 512-node model's
    serving path and train step (a hidden size no cluster holds): x [B, W, N],
    g_gru [B, N, H] the cotangent of its GRU output in one train step of the
    CPU plain path. Both held with the atol scaled to the plain result's
    largest entry."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_gru, torch_impl

    b, w, n = x.shape
    h = n
    gru = params["gru"]
    card = cuda_gru.card_limits(x.device)
    routes = (cuda_gru.launch_plan(b, h, *card).route, cuda_gru.bwd_plan(b, h, *card).route)
    if routes != ("grid", "grid"):
        raise RuntimeError(f"hidden size {h} was expected to take the grid route: {routes}")
    with torch.no_grad():
        x_proj = torch_impl.gru_input_projection(gru, x).contiguous()
        a_all = gru["w_hh"].T.contiguous()
        _, saved = torch_impl.gru_scan(x_proj, a_all, gru["b_hh"], save=True)
    g_gru = g_gru.to(x.device).contiguous()
    cudnn_fwd, cudnn_fwd_bwd = cudnn_gru_calls(gru, x, g_gru)
    return [
        ("gru_fwd_grid", "stemgnn_tpu_torch/csrc/gru.cu",
         "stemgnn_tpu/ops/pallas_gru.py:103",
         lambda: cuda_gru.gru_over_nodes(gru, x),
         lambda: cuda_gru.gru_over_nodes_plain(gru, x),
         cudnn_fwd, GRID_ATOL_REL, GRID_RTOL, *gru_fwd_work(gru, x)),
        ("gru_bwd_grid", "stemgnn_tpu_torch/csrc/gru.cu",
         "stemgnn_tpu/ops/pallas_gru.py:132",
         lambda: cuda_gru.gru_scan_bwd(saved, g_gru, a_all),
         lambda: cuda_gru.gru_scan_bwd_plain(saved, g_gru, a_all),
         ("graph_or_stream", cudnn_fwd_bwd),  # cuDNN forward plus backward
         GRID_ATOL_REL, GRID_RTOL, *gru_bwd_work(saved, g_gru, a_all)),
    ]


def gru_fwd_work(gru, x):
    """(bytes, operations) of the GRU forward on x [B, W, N]: the input
    projection and the recurrence, each input read once and the output
    written once."""
    b, w, n = x.shape
    h = gru["w_hh"].shape[1]
    return (4 * (x.numel() + sum(t.numel() for t in gru.values()) + b * n * h),
            2 * n * b * w * 3 * h + 2 * n * b * h * 3 * h)


def gru_bwd_work(saved, g, a_all):
    """(bytes, operations) of the GRU backward: saved, g and W_hh^T read once,
    dxp written once; the recurrence's products and its gate math."""
    n, _, b, h = saved.shape
    return (4 * (saved.numel() + g.numel() + a_all.numel() + 3 * n * b * h),
            2 * n * b * 3 * h * h + 14 * n * b * h)


def cudnn_gru_calls(gru, x, g):
    """(forward, forward and backward under autograd) of torch.nn.GRU on
    cuDNN with the weights of the port's `gru` tree, on x [B, W, N] and the
    output cotangent g [B, N, H]: the GRU kernels' library yardstick."""
    import torch

    cudnn = cudnn_gru_like(gru, x.device)
    cudnn_train = cudnn_gru_like(gru, x.device, train=True)
    xs = x.permute(2, 0, 1).contiguous()  # [N, B, W], cuDNN's sequence-major input
    xs_grad = xs.clone().requires_grad_(True)
    g_seq = g.transpose(0, 1).contiguous()

    def fwd_bwd():
        with torch.enable_grad():
            out = cudnn_train(xs_grad)[0]
            return torch.autograd.grad(out, [xs_grad, *cudnn_train.parameters()], g_seq)

    return (lambda: cudnn(xs)[0]), fwd_bwd


def grid_timings(dev):
    """The grid GRU kernels at `synthetic-1k`'s shape (B = 8, H = N = 1024;
    benchmarks/suite.py LARGE_CONFIGS) on seeded inputs, through the entry
    points the model calls: held against the plain recurrences as
    `grid_cases` holds them, and timed as graph replays beside the plain
    versions, the bound and cuDNN (forward; forward and backward under
    autograd). Printed only: the kernels line keeps the 512-node model's
    shape. Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import cuda_gru, torch_impl

    b, h = 8, 1024
    rng = np.random.default_rng(11)
    bound_w = 1.0 / np.sqrt(h)

    def card(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    gru = {"w_ih": card(rng.uniform(-bound_w, bound_w, (3 * h, WINDOW))),
           "w_hh": card(rng.uniform(-bound_w, bound_w, (3 * h, h))),
           "b_ih": card(rng.uniform(-bound_w, bound_w, 3 * h)),
           "b_hh": card(rng.uniform(-bound_w, bound_w, 3 * h))}
    x = card(rng.standard_normal((b, WINDOW, h)))
    g = card(1e-2 * rng.standard_normal((b, h, h)))
    with torch.no_grad():
        x_proj = torch_impl.gru_input_projection(gru, x).contiguous()
        a_all = gru["w_hh"].T.contiguous()
        _, saved = torch_impl.gru_scan(x_proj, a_all, gru["b_hh"], save=True)
    cudnn_fwd, cudnn_fwd_bwd = cudnn_gru_calls(gru, x, g)
    launches = (cuda_gru.gru_fwd_grid.launches, cuda_gru.gru_bwd_grid.launches)
    fail = check_cases([
        ("gru_fwd_grid", "", "", lambda: cuda_gru.gru_over_nodes(gru, x),
         lambda: cuda_gru.gru_over_nodes_plain(gru, x), cudnn_fwd, GRID_ATOL_REL, GRID_RTOL,
         *gru_fwd_work(gru, x)),
        ("gru_bwd_grid", "", "", lambda: cuda_gru.gru_scan_bwd(saved, g, a_all),
         lambda: cuda_gru.gru_scan_bwd_plain(saved, g, a_all),
         ("graph_or_stream", cudnn_fwd_bwd), GRID_ATOL_REL, GRID_RTOL,
         *gru_bwd_work(saved, g, a_all))],
        {}, f"3 kernel, synthetic-1k shape B={b} H=N={h}", scaled=True, calls=2, replays=3)
    if launches == (cuda_gru.gru_fwd_grid.launches, cuda_gru.gru_bwd_grid.launches):
        return f"the grid GRU at B={b} H={h} launched no grid kernel"
    return fail


def shape_checks(dev):
    """The GRU forward (cluster and grid routes, both variants), the GRU
    backward (both routes, and each twice: bitwise the same) and the graph
    convolution against their plain versions at other shapes than the
    flagship's, untimed, on seeded inputs. Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import cuda_graph, cuda_gru, torch_impl

    rng = np.random.default_rng(3)
    limits = cuda_gru.card_limits(dev)

    def card(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    # ragged batches; H = 170 and 358 divide by no chosen cluster size (6, 8);
    # H = 20 is a cluster of one block, H = 37 of two; H = 512 fits no cluster
    # of 8 and takes the grid route
    for b, h, route in ((26, 140, "cluster"), (6, 140, "cluster"), (1, 140, "cluster"),
                        (3, 20, "cluster"), (5, 37, "cluster"),
                        (32, 228, "cluster"), (32, 170, "cluster"),
                        (32, 358, "cluster"), (64, 140, "cluster"),
                        (6, 512, "grid"), (32, 512, "grid"), (64, 512, "grid")):
        plan = cuda_gru.launch_plan(b, h, *limits)
        if plan.route != route:
            return f"gru launch_plan({b}, {h}) takes the {plan.route} route"
        bound = 1.0 / np.sqrt(h)
        x_proj = card(rng.standard_normal((h, b, 3 * h)))
        a_all = card(rng.uniform(-bound, bound, (h, 3 * h)))
        b_hh = card(rng.uniform(-bound, bound, 3 * h))
        with torch.no_grad():
            want = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
            for save in (False, True):
                got = cuda_gru._launch_fwd(x_proj, a_all, b_hh, save)
                torch.cuda.synchronize()
                errs = [(g - w_).abs().max().item()
                        for g, w_ in zip(got, want) if g is not None]
                print(f"[3 kernel] gru forward B={b} H={h} {route} "
                      f"{'saving' if save else 'serving'} ({plan.cluster} blocks a "
                      f"recurrence, slice {plan.slice}, {plan.groups} groups, "
                      f"{plan.smem} B): max_abs_err {max(errs):.3e} (atol 1e-4)")
                if not max(errs) <= 1e-4:
                    return f"gru forward at B={b} H={h} ({route}) differs by {max(errs)}"
    # the backward, both routes: H = 512 takes the grid route, the others
    # clusters of 1 (H = 20), 2 (37), 5 (140) and 8 blocks (228, 358); the
    # forward's saved activations of seeded inputs, a seeded cotangent
    for h in (20, 37, 140, 228, 358, 512):
        n = h
        bound = 1.0 / np.sqrt(h)
        a_all = card(rng.uniform(-bound, bound, (h, 3 * h)))
        b_hh = card(rng.uniform(-bound, bound, 3 * h))
        for b in (1, 5, 26, 32, 64):
            plan = cuda_gru.bwd_plan(b, h, *limits)
            if plan.route != ("grid" if h > 360 else "cluster"):
                return f"gru bwd_plan({b}, {h}) takes the {plan.route} route"
            x_proj = card(rng.standard_normal((n, b, 3 * h)))
            g = card(rng.standard_normal((b, n, h)))
            with torch.no_grad():
                _, saved = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
                want = torch_impl.gru_scan_bwd(saved, g, a_all)
                got = cuda_gru.gru_scan_bwd(saved, g, a_all)
                again = cuda_gru.gru_scan_bwd(saved, g, a_all)
                torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = torch.allclose(got, want, atol=1e-5 * scale, rtol=1e-4)
            same = torch.equal(got, again)
            print(f"[3 kernel] gru backward B={b} H={h} {plan.route} ({plan.cluster} blocks "
                  f"a recurrence, slice {plan.slice}, {plan.groups} groups, {plan.smem} B): "
                  f"max_abs_err {err:.3e} (atol 1e-5 of the largest entry {scale:.3e}, "
                  f"rtol 1e-4); two runs {'bitwise equal' if same else 'DIFFER'}")
            if not ok or not same:
                return (f"gru backward at B={b} H={h} ({plan.route}) differs by {err} "
                        f"(bitwise rerun: {same})")
    # the grid kernels through their own entry points at hidden sizes past the
    # cluster's, the full node axis (N = H): H = 361 (3 units a block), 512
    # (4), 1024 (8) and 1300 (10: the backward's dcat staged in chunks), 2500
    # (19: the slice of W_hh^T read from L2 every step); both forward
    # variants (the serving output bitwise the saving one), and the backward
    # twice, bitwise
    for b, h in ((32, 512), (8, 1024), (1, 361), (8, 361), (64, 361), (1, 512), (8, 512),
                 (64, 512), (8, 1300), (8, 2500)):
        n = h
        plan, bplan = cuda_gru.launch_plan(b, h, *limits), cuda_gru.bwd_plan(b, h, *limits)
        if (plan.route, bplan.route) != ("grid", "grid"):
            return f"gru plans at B={b} H={h} take the {plan.route} route"
        bound = 1.0 / np.sqrt(h)
        a_all = card(rng.uniform(-bound, bound, (h, 3 * h)))
        b_hh = card(rng.uniform(-bound, bound, 3 * h))
        x_proj = card(rng.standard_normal((n, b, 3 * h)))
        g = card(rng.standard_normal((b, n, h)))
        with torch.no_grad():
            out_s, saved_s = cuda_gru.gru_fwd_grid(x_proj, a_all, b_hh, save=True)
            out_f, _ = cuda_gru.gru_fwd_grid(x_proj, a_all, b_hh)
            want, saved = torch_impl.gru_scan(x_proj, a_all, b_hh, save=True)
            got = cuda_gru.gru_bwd_grid(saved, g, a_all)
            again = cuda_gru.gru_bwd_grid(saved, g, a_all)
            torch.cuda.synchronize()
            dwant = torch_impl.gru_scan_bwd(saved, g, a_all)
        pairs = [("output", out_s, want), ("dxp", got, dwant)] + [
            (f"saved plane {q}", saved_s[:, q], saved[:, q]) for q in range(5)]
        bad, worst = [], 0.0
        for label, t, ref in pairs:
            err, scale = (t - ref).abs().max().item(), ref.abs().max().item()
            worst = max(worst, err / scale if scale > 0 else err)
            if not torch.allclose(t, ref, atol=GRID_ATOL_REL * scale, rtol=GRID_RTOL):
                bad.append(label)
        if not torch.equal(out_f, out_s):
            bad.append("serving output not bitwise the saving one")
        same = torch.equal(got, again)
        print(f"[3 kernel] gru grid B={b} H=N={h} ({plan.cluster} blocks of {plan.slice} "
              f"units, {plan.threads} threads, slice {'resident' if plan.resident else 'from L2'}"
              f", h in chunks of {plan.chunk}, dcat in chunks of {bplan.chunk}): output, the 5 "
              f"saved planes and dxp within {GRID_ATOL_REL:g} of their largest entry, rtol "
              f"{GRID_RTOL:g} (worst {worst:.3e} of it): {'yes' if not bad else bad}; serving "
              f"output bitwise the saving one: {torch.equal(out_f, out_s)}; two backwards "
              f"{'bitwise equal' if same else 'DIFFER'}")
        if bad or not same:
            return f"gru grid at B={b} H={h}: {bad} (bitwise rerun: {same})"
    # ragged batch; ragged N and a W that is no multiple of 4; an N in two
    # panels; the zero order alone
    for k, n, b, w in ((4, 140, 26, 12), (4, 228, 6, 12), (4, 37, 5, 7),
                       (3, 800, 3, 12), (1, 140, 6, 12)):
        mul_L = rng.standard_normal((k, n, n)) * 0.1
        mul_L[0] = 0.0
        mul_L, x = card(mul_L), card(rng.standard_normal((b, n, w)))
        plan = cuda_graph.launch_plan(k, n, b, w)
        with torch.no_grad():
            got = cuda_graph.cheb_graph_conv(mul_L, x)
            torch.cuda.synchronize()
            want = cuda_graph.cheb_graph_conv_plain(mul_L, x)
        err = (got - want).abs().max().item()
        print(f"[3 kernel] graph conv K={k} N={n} B={b} W={w} (grid {plan.grid}, panel "
              f"{plan.panel}, {plan.smem} B): max_abs_err {err:.3e} (atol 1e-4, rtol 1e-5)")
        if not torch.allclose(got, want, atol=1e-4, rtol=1e-5):
            return f"graph conv at K={k} N={n} B={b} W={w} differs by {err}"
    return None


# The spectral forwards against their plain versions at other shapes: the
# output and each of the 12 saved arrays within atol 1e-5 of its own largest
# entry, rtol 1e-4 (sums of up to 680 f32 terms through three layers in
# another order than cuBLAS; the serving output against cuFFT).
SPE_FWD_ATOL_REL, SPE_FWD_RTOL = 1e-5, 1e-4


def spectral_bounds(b: int, n: int, w: int, m: int, glu, bf16: bool, act_bytes: int = 4):
    """The least device ms of the four spectral entries (serving forward,
    saving forward, reread backward, recompute backward) on [B, 4, N, W] rows
    at multi m: bytes (each input read once, each output written once; the
    bf16 arm's operands as bf16; the 12 saved arrays of `act_bytes` an entry)
    against the f32 CUDA-core or bf16 tensor-core rate, the operations as
    `forward_cases` and `backward_cases` count them."""
    k, wm = 4, w * m
    d0, d1, rows = k * w, k * wm, b * n
    glu_2d = sum(p[s]["w"].numel() for p in glu for s in ("left", "right"))
    glu_b = sum(p[s]["b"].numel() for p in glu for s in ("left", "right"))
    spe_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm) + 8 * k * w * w * d1
    glu_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1)
    reread_flops = 2 * glu_flops + 2 * rows * 2 * k * wm * wm + 16 * k * w * w * d1
    if bf16:
        fwd_bytes = 2 * (rows * d0 + glu_2d) + 4 * (glu_b + rows * d1)
        bwd_bytes = 2 * (rows * d0 + rows * d1 + glu_2d) + 4 * (rows * d0 + glu_2d + glu_b)
    else:
        fwd_bytes = 4 * (rows * d0 + glu_2d + glu_b + rows * d1)
        bwd_bytes = 4 * (2 * rows * d0 + rows * d1 + 2 * (glu_2d + glu_b))
    acts = act_bytes * 12 * rows * d1
    rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
    return [bound(nbytes, flops, rate)[0] for nbytes, flops in (
        (fwd_bytes, spe_flops), (fwd_bytes + acts, spe_flops),
        (bwd_bytes + acts, reread_flops), (bwd_bytes, glu_flops + reread_flops))]


def storage_arm_check(x, glu, g, m: int, out32, acts32, f32_plain):
    """The bf16-storage arm (SAVE_ACTS_F32 off) of the bf16 saving forward and
    reread backward at one shape, beside the f32-storage arm's output out32
    and planes acts32 on the same inputs: its 12 bf16 planes bitwise acts32
    rounded to bf16 (the same kernel computes the same f32 values) and its
    output bitwise out32; two rereads on its planes bitwise; forward and
    backward against the plain versions of the arm (the bf16 rule up to D1 =
    BF16_NOISE_D1, past it `bf16_noise_agreement` with f64 sums), the f32
    plain arrays `f32_plain` as the f32 yardstick; the saving forward on the
    chain kernel of its route. Returns (an error message or None, its planes)."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    bf = "bfloat16"
    b, _, n, w = x.shape
    rows, d1 = b * n, 4 * w * m
    with torch.no_grad():
        out16, acts16 = cuda_spectral.spe_seq_cell_save(x, glu, m, bf, act_dtype=bf)
        runs = [cuda_spectral.spe_seq_cell_bwd_reread(x, glu, g, acts16, m, bf) for _ in range(2)]
        torch.cuda.synchronize()
        fail = bf16_chain_route(
            lambda: cuda_spectral.spe_seq_cell_save(x, glu, m, bf, act_dtype=bf), d1)
    if fail is not None:
        return fail, acts16
    planes = torch.equal(acts16, acts32.to(torch.bfloat16))
    same_out = torch.equal(out16, out32)
    got, again = ([dx] + cuda_spectral._flat(dglu) for dx, dglu in runs)
    rerun = all(torch.equal(a, c) for a, c in zip(got, again))
    fwd = [out16, out16] + [acts16[i, :rows] for i in range(12)]
    p32 = spectral_plain_arrays(x, glu, g, m, bf, act_dtype=bf)
    bad = []
    if d1 <= BF16_NOISE_D1:
        notes = []
        for part, kern in ((0, fwd), (1, got)):
            bad_i, _, ratio, rel = bf16_agreement(kern, p32[part], f32_plain[part], BF16_ATOL_REL,
                                                  BF16_ULP if part == 0 else 0.0)
            bad += [f"{'fwd' if part == 0 else 'bwd'} array {i}" for i in bad_i]
            if ratio < BF16_CLOSER:
                bad.append(f"{ratio:.1f} times closer")
            notes.append(f"{'forward' if part == 0 else 'backward'} within {rel:.2e} of each "
                         f"array's largest entry, {ratio:.1f} times closer")
        rule = (f"each within {BF16_ATOL_REL:.4g} of its largest entry (the planes plus a bf16 "
                f"ulp of each value): " + "; ".join(notes))
    else:
        p64 = spectral_plain_arrays(x, glu, g, m, bf, torch.float64, act_dtype=bf)
        notes = []
        for part, kern in ((0, fwd), (1, got)):
            bad_i, rel, noise, closer = bf16_noise_agreement(kern, p64[part], p32[part],
                                                             f32_plain[part])
            bad += [f"{'fwd' if part == 0 else 'bwd'} {i}" for i in bad_i]
            notes.append(f"{'forward' if part == 0 else 'backward'} worst {rel:.2e}, L2 "
                         f"{noise:.3f} times the f32-sum noise, {closer:.1f} times closer")
        rule = "bf16_noise_agreement: " + "; ".join(notes)
    print(f"[3 kernel] spectral bf16-storage arm B={b} N={n} W={w} multi={m} ({rows} rows, "
          f"D1 = {d1}): planes {'bitwise' if planes else 'NOT'} the f32-storage planes "
          f"rounded, output {'bitwise' if same_out else 'NOT'} the f32-storage output, two "
          f"rereads {'bitwise equal' if rerun else 'DIFFER'}; against the arm's plain "
          f"versions, {rule}: {'yes' if not bad else 'NO, ' + ', '.join(bad[:6])}")
    if not (planes and same_out and rerun) or bad:
        return (f"spectral bf16-storage arm at B={b} N={n} W={w} multi={m}: planes {planes}, "
                f"output {same_out}, reruns {rerun}, out of tolerance {bad[:6]}"), acts16
    return None, acts16


def spectral_checks(dev, glu, multi: int):
    """The spectral forwards and backwards of both arms against their plain
    versions, untimed, on seeded inputs: at the flagship rows (4480) and at row
    counts that are no multiple of the kernels' row tiles (185, 111); then at
    185 rows of other windows and multipliers the CLI takes (W = 7 and 10: runs
    of 4 columns that straddle two windows; multi 6: D1 = 288, past one block's
    column groups; W = 25: D1 = 500; W = 28: D1 = 560, the README's COVID-19
    command; past D1 = 680, where the rows kernel takes 8-row tiles: W = 35,
    D1 = 700, and multi 15, D1 = 720; W = 100, D1 = 2000), with GLU weights
    from init_params; then past D1 = 2048, where the wide kernels take the
    shapes, on inputs of their own seeds 0 and 1: W = 103 at multi 5 (D1 =
    2060, the wide chain's buffers in shared memory) on 240 and 600 rows, and
    multi 64 at W = 12 (D1 = 3072, in a device workspace) on 240 rows, each
    timed (seed 0) beside its bound. f32: the serving forward's output, and
    the saving forward's output and 12 arrays, each within SPE_FWD_ATOL_REL
    of its own largest entry; the saved rows past the end finite; the
    backwards' dx and each of the 24 gradients within atol 1e-5 of their own
    largest entry and rtol 1e-3. bf16 up to D1 = BF16_NOISE_D1: each of those
    arrays within BF16_ATOL_REL of its largest entry and the arm BF16_CLOSER
    times closer to the bf16 plain versions than to the f32 ones
    (`bf16_agreement`); past it, `bf16_noise_agreement` against the bf16
    plain version with f64 sums, its two ratios printed. Both arms: the
    reread gradients bitwise the recompute gradients, a second reread bitwise
    the first, the saving forward's output bitwise the serving forward's. The
    bf16 saving forward on the chain kernel of its route (`bf16_chain_route`:
    tensor cores up to D1 = 2048, the wide kernel past it). Returns an error
    message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.ops import cuda_spectral

    rng = np.random.default_rng(4)
    k = 4

    def init_glu(n, w, m):
        cfg = StemGNNConfig(units=n, window_size=w, horizon=HORIZON, multi_layer=m)
        return init_params(0, cfg, device=dev)["blocks"][0]["glu"]

    def card(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    # (B, N, W, multi, GLU weights, the generator of x and g, timed)
    cases = [(32, 140, WINDOW, multi, glu, rng, False), (5, 37, WINDOW, multi, glu, rng, False),
             (3, 37, WINDOW, multi, glu, rng, False)]
    for w, m in ((7, 5), (10, 5), (WINDOW, 6), (25, 5), (28, 5), (35, 5), (WINDOW, 15),
                 (100, 5)):
        cases.append((5, 37, w, m, init_glu(37, w, m), rng, False))
    for b, n, w, m in ((4, 60, 103, 5), (10, 60, 103, 5), (4, 60, WINDOW, 64)):
        for seed in (0, 1):
            cases.append((b, n, w, m, init_glu(n, w, m), np.random.default_rng(seed),
                          seed == 0))
    for b, n, w, m, glu_w, gen, timed in cases:
        x = card(gen.standard_normal((b, k, n, w)))
        g = card(1e-3 * gen.standard_normal((b, k, n, w * m)))
        rows, d1 = b * n, 4 * w * m
        f32_plain = None
        for cd in ("float32", "bfloat16"):
            bf16 = cd == "bfloat16"
            with torch.no_grad():
                out = cuda_spectral.spe_seq_cell(x, glu_w, m, cd)
                out_s, acts = cuda_spectral.spe_seq_cell_save(x, glu_w, m, cd)
                torch.cuda.synchronize()
                want_out = cuda_spectral.spe_seq_cell_plain(x, glu_w, m, cd)
                want_s, want_acts = cuda_spectral.spe_seq_cell_save_plain(x, glu_w, m, cd)
                runs = [cuda_spectral.spe_seq_cell_bwd_reread(x, glu_w, g, acts, m, cd)
                        for _ in range(2)]
                runs.append(cuda_spectral.spe_seq_cell_bwd(x, glu_w, g, m, cd))
                torch.cuda.synchronize()
                want = cuda_spectral.spe_seq_cell_bwd_plain(x, glu_w, g, m, cd)
            if bf16:  # the chain kernel of its route: tensor cores up to D1 = 2048
                with torch.no_grad():
                    fail = bf16_chain_route(
                        lambda: cuda_spectral.spe_seq_cell_save(x, glu_w, m, cd), d1)
                if fail is not None:
                    return fail
            fwd = [out, out_s] + [acts[i, :rows] for i in range(12)]
            fwd_want = [want_out, want_s] + list(want_acts)
            leaves = [[dx] + cuda_spectral._flat(dglu) for dx, dglu in (*runs, want)]
            got, again, recompute, want = leaves
            fwd_names = ["serving output", "saving output"] + [f"saved array {i}"
                                                               for i in range(12)]
            bwd_names = ["dx"] + [f"gradient {i}" for i in range(24)]
            if bf16 and d1 <= BF16_NOISE_D1:
                results = []
                for part, kern, plain, f32 in (("fwd", fwd, fwd_want, f32_plain[0]),
                                               ("bwd", got, want, f32_plain[1])):
                    bad, err, ratio, rel = bf16_agreement(kern, plain, f32, BF16_ATOL_REL)
                    names = fwd_names if part == "fwd" else bwd_names
                    bad = [names[i] for i in bad] + (
                        [] if ratio >= BF16_CLOSER else [f"{ratio:.1f} times closer"])
                    results.append((bad, err, f"within {BF16_ATOL_REL:.4g} of its largest "
                                    f"entry (worst {rel:.2e}), and {ratio:.1f} times closer "
                                    f"to the bf16 plain version than to the f32 one"))
            elif bf16:
                # past D1 = 720: against the bf16 plain version with f64 sums
                p64 = spectral_plain_arrays(x, glu_w, g, m, cd, torch.float64)
                results = []
                for part, kern, p64_, p32, f32 in (
                        ("fwd", fwd, p64[0], fwd_want, f32_plain[0]),
                        ("bwd", got, p64[1], want, f32_plain[1])):
                    bad, rel, noise, closer = bf16_noise_agreement(kern, p64_, p32, f32)
                    names = fwd_names if part == "fwd" else bwd_names
                    bad = [names[int(i)] if i.isdigit() else i for i in bad]
                    err = max((a - b_).abs().max().item() for a, b_ in zip(kern, p32))
                    results.append((bad, err, (
                        f"against the f64-sum bf16 plain version: each within "
                        f"max({BF16_ATOL_REL:.4g} of its largest entry, {BF16_NOISE_FACTOR:g} "
                        f"x the f32-sum one's distance) (worst {rel:.2e} of its largest "
                        f"entry); L2 {noise:.3f} times the f32-sum one's distance, at most "
                        f"{BF16_NOISE_FACTOR:g}; {closer:.1f} times closer to the bf16 "
                        f"plain version than to the f32 one, at least {BF16_CLOSER:g}")))
            else:
                results = []
                for kern, plain, names, atol_rel, rtol in (
                        (fwd, fwd_want, fwd_names, SPE_FWD_ATOL_REL, SPE_FWD_RTOL),
                        (got, want, bwd_names, 1e-5, 1e-3)):
                    err, bad = 0.0, []
                    for name, t, ref in zip(names, kern, plain):
                        err = max(err, (t - ref).abs().max().item())
                        if not torch.allclose(t, ref, rtol=rtol,
                                              atol=atol_rel * ref.abs().max().item()):
                            bad.append(name)
                    results.append((bad, err, f"within atol {atol_rel:g} of its largest "
                                    f"entry, rtol {rtol:g}"))
                f32_plain = (fwd_want, want)
            (fwd_bad, fwd_err, fwd_tol), (bad, err, tol) = results
            if not torch.isfinite(acts).all():
                fwd_bad.append("saved rows past the end not finite")
            if not torch.equal(out, out_s):
                fwd_bad.append("saving output not bitwise the serving output")
            print(f"[3 kernel] spectral forwards {cd} B={b} N={n} W={w} multi={m} ({rows} "
                  f"rows, D1 = {d1}): max_abs_err {fwd_err:.3e} (the serving output, the "
                  f"saving output and each of the 12 saved arrays {fwd_tol}: "
                  f"{'yes' if not fwd_bad else 'NO, ' + ', '.join(fwd_bad)})")
            same = all(torch.equal(a, b_) and torch.equal(a, c)
                       for a, b_, c in zip(got, again, recompute))
            print(f"[3 kernel] spectral backward {cd} B={b} N={n} W={w} multi={m} ({rows} "
                  f"rows): reread max_abs_err {err:.3e} (each of dx and the 24 gradients "
                  f"{tol}: {'yes' if not bad else 'NO, ' + ', '.join(bad)}); two rereads "
                  f"and the recompute backward {'bitwise equal' if same else 'DIFFER'}")
            if fwd_bad or bad or not same:
                return (f"spectral {cd} at B={b} N={n} W={w} multi={m}: forwards out of "
                        f"tolerance {fwd_bad}, max_abs_err {fwd_err}; backward {bad}, "
                        f"max_abs_err {err} (bitwise reruns and recompute: {same})")
            calls = [lambda: cuda_spectral.spe_seq_cell(x, glu_w, m, cd),
                     lambda: cuda_spectral.spe_seq_cell_save(x, glu_w, m, cd),
                     lambda: cuda_spectral.spe_seq_cell_bwd_reread(x, glu_w, g, acts, m, cd),
                     lambda: cuda_spectral.spe_seq_cell_bwd(x, glu_w, g, m, cd)]
            labels = ["forward", "saving forward", "reread backward", "recompute backward"]
            bounds = spectral_bounds(b, n, w, m, glu_w, bf16)
            if bf16:  # the bf16-storage arm of the same pair
                fail, acts16 = storage_arm_check(x, glu_w, g, m, out_s, acts, f32_plain)
                if fail is not None:
                    return fail
                calls += [
                    lambda: cuda_spectral.spe_seq_cell_save(x, glu_w, m, cd, act_dtype=cd),
                    lambda: cuda_spectral.spe_seq_cell_bwd_reread(x, glu_w, g, acts16, m, cd)]
                labels += ["saving forward, bf16 planes", "reread backward, bf16 planes"]
                bounds += spectral_bounds(b, n, w, m, glu_w, bf16, act_bytes=2)[1:3]
            if timed:  # the wide kernels' shapes: their times beside their bounds
                with torch.no_grad():
                    ms = [cuda_ms(fn, calls=2, replays=3) for fn in calls]
                print(f"[3 kernel] spectral {cd} B={b} N={n} W={w} multi={m} (D1 = {d1}), "
                      f"device ms a wrapper call (bound): " + ", ".join(
                          f"{label} {t:.5f} ({lo:.5f})" for label, t, lo in zip(
                              labels, ms, bounds)))
    return None


def profile_steps(step, batches, step_ms: float, tag: str = "5 train path") -> None:
    """Print where the card's time goes in a train step: torch.profiler over
    `batches`, device time per step by kernel name, their sum, and that sum
    over `step_ms` (the unprofiled host-clock step) as the card's busy share.
    Informative only: prints "not measured" if the profiler cannot run or saw
    no kernel. `tag` heads the lines."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # only the profiler's own start and stop may fail softly: the steps
    # between them are the port's and fail the run as anywhere else
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        print(f"[{tag}] device time by kernel: not measured (the profiler "
              f"did not start: {exc})")
        return
    for hi_b in batches:
        step(hi_b)
    torch.cuda.synchronize()
    try:
        prof.stop()
        events = prof.events()
    except RuntimeError as exc:
        print(f"[{tag}] device time by kernel: not measured (the profiler "
              f"did not stop: {exc})")
        return
    kernels = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total / 1e3
    n = len(batches)
    total = sum(kernels.values()) / n
    if total <= 0:
        print(f"[{tag}] device time by kernel: not measured (the profiler "
              "recorded no kernel)")
        return
    print(f"[{tag}] device time by kernel, torch.profiler over {n} steps: "
          f"{total:.3f} ms per step in {len(kernels)} kernels, {total / step_ms:.1%} "
          f"of the {step_ms:.3f} ms step (the card's busy share; the rest is idle)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{tag}]   {ms / n:8.4f} ms/step  {name[:100]}")


def take_launches(ops, results):
    """Read the counts of a path that has just run: (calls of the wrappers,
    launches made by graph replays), both added to the kernels' `launches`."""
    launches, replayed = ops.launches(), ops.replayed()
    for name in launches:
        results[name]["launches"] += launches[name] + replayed[name]
    return launches, replayed


def time_case(phase, name, kern, plain, lib, calls, replays):
    """(kernel ms, plain ms, library ms or None, one eager call's ms) of a case,
    each call timed as `cuda_ms` times it."""
    import functools

    import torch

    cuda_ms_ = functools.partial(cuda_ms, calls=calls, replays=replays)
    with torch.no_grad():
        ms = cuda_ms_(kern)
        plain_ms = cuda_ms_(plain)
        if lib is None:
            lib_ms = None
        elif isinstance(lib, tuple):
            # ("graph_or_stream", fn): a library call that may refuse to be
            # captured (cuDNN's RNN backward under autograd); it is no part
            # of the port, so its timing alone may fall back to eager calls
            try:
                lib_ms = cuda_ms_(lib[1])
            except RuntimeError as exc:
                print(f"[{phase}] {name}: the library call was not captured "
                      f"({str(exc).splitlines()[0][:120]}); timed as eager calls, "
                      "host-bound")
                torch.cuda.synchronize()
                lib_ms = stream_ms(lib[1])
        else:
            lib_ms = cuda_ms_(lib)
        one_call_ms = call_ms(kern, reps=calls)
    return ms, plain_ms, lib_ms, one_call_ms


def check_cases(cases, results, phase: str, scaled: bool = False, calls: int = 20,
                replays: int = 10):
    """Hold each case's kernel against its plain version and time both; fills
    `results`. Returns an error message, or None. With `scaled` a case's atol
    is a fraction of the plain result's largest entry: the cotangents of a
    real train step, and so the backward kernels' outputs, are far below 1.
    `calls` and `replays` size the timed graphs (fewer for a slow kernel)."""
    import torch

    for (name, source, replaces, kern, plain, lib, atol, rtol, nbytes,
         flops) in cases:
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item() if scaled else 1.0
            ok = bool(torch.allclose(got, want, atol=atol * scale, rtol=rtol))
        ms, plain_ms, lib_ms, one_call_ms = time_case(phase, name, kern, plain, lib, calls,
                                                      replays)
        bound_ms, bound_by = bound(nbytes, flops)
        tol = (f"atol {atol:g} of the largest entry {scale:.3e}" if scaled
               else f"atol {atol:g}")
        print(f"[{phase}] {name}: max_abs_err {err:.3e} ({tol}, "
              f"rtol {rtol:g}) {'ok' if ok else 'FAIL'}; kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}, "
              f"bound {bound_ms:.5f} ms ({bound_by}, {flops:.4e} op, "
              f"{nbytes:.4e} B); one eager call with its host work "
              f"{one_call_ms:.5f} ms")
        if not ok or not math.isfinite(err):
            return f"{name} disagrees with its plain version: {err}"
        results[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, launches=0)
    return None


def check_bf16_cases(cases, results, phase: str, calls: int = 20, replays: int = 10):
    """`check_cases` for the bf16 arms (`bf16_cases`): each array of the
    kernel's result within the case's atol of its largest entry (and rtol) of
    the bf16 plain version's, and the kernel's results BF16_CLOSER times
    closer to the bf16 plain version than to the f32 one (`bf16_agreement`);
    the bound at the bf16 tensor-core rate, the f32 CUDA-core bound printed
    beside it. Fills `results`; returns an error message, or None."""
    import torch

    for (name, source, replaces, kern, plain, plain_f32, lib, atol, rtol, nbytes,
         flops) in cases:
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            bad, err, ratio, rel = bf16_agreement(got, plain(), plain_f32(), atol, rtol)
        ms, plain_ms, lib_ms, one_call_ms = time_case(phase, name, kern, plain, lib, calls,
                                                      replays)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        f32_ms, f32_by = bound(nbytes, flops)
        ok = not bad and ratio >= BF16_CLOSER and math.isfinite(err)
        print(f"[{phase}] {name}: max_abs_err {err:.3e}, {rel:.3e} of its array's largest "
              f"entry (each of {len(got)} arrays within "
              f"{atol:.4g} of its largest entry, rtol {rtol:g}: "
              f"{'yes' if not bad else f'NO, arrays {bad[:8]}'}; {ratio:.1f} times closer "
              f"to the bf16 plain version than to the f32 one, at least {BF16_CLOSER:g}) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library {'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound "
              f"{bound_ms:.5f} ms ({bound_by}, bf16 tensor cores; f32 CUDA cores "
              f"{f32_ms:.5f} ms, {f32_by}; {flops:.4e} op, {nbytes:.4e} B); one eager "
              f"call with its host work {one_call_ms:.5f} ms")
        if not ok:
            return f"{name} disagrees with its bf16 plain version: {err}, arrays {bad[:8]}"
        results[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, launches=0)
    return None


# The earlier design's device ms a wrapper call of the kernels that went to
# tensor cores or lost their cast launches (PERF.md section 6, this script's
# phase 3 on an NVIDIA H100 80GB HBM3 at 700.00 W): the scalar bf16 spectral
# backwards, the bf16 graph conv with its two casts and the scalar bf16
# spectral forwards. Printed beside this run's times and bounds.
PARENT_DESIGN_MS = {"spectral_bwd_reread_bf16": 0.68988, "spectral_bwd_bf16": 0.88127,
                    "cheb_graph_conv_fwd_bf16": 0.00871, "spectral_fwd_bf16": 0.21594,
                    "spectral_fwd_save_bf16": 0.24158}


def kernels_of_call(fn):
    """The names of the CUDA kernels one call of fn launches, by
    torch.profiler, or None where the profiler cannot say. A profile that
    records no kernel at all (the tracer now and then hands back an empty
    list) is taken again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and not ev.is_user_annotation]
        except RuntimeError as exc:
            print(f"[3 kernel] kernels of a call: not measured (the profiler failed: {exc})")
            return None
        if names:
            return names
    print("[3 kernel] kernels of a call: not measured (no kernel in 3 profiles)")
    return None


def bf16_chain_route(fn, d1: int):
    """An error message unless one call of fn (a bf16 spectral entry that runs
    the chain forward) launches the chain kernel of its route, by
    torch.profiler: `spectral_chain_mma_kernel` up to D1 = 2048, the wide
    scalar `spectral_chain_wide_kernel` past it, and never the scalar
    `spectral_chain_kernel`; also an error where the profiler cannot name
    the kernels. None, and a line printed, where it does."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    names = kernels_of_call(fn)
    if names is None:
        return f"the profiler could not name the kernels of a bf16 chain call at D1 = {d1}"
    want = ("spectral_chain_mma_kernel" if d1 <= cuda_spectral.MMA_MAX_D1
            else "spectral_chain_wide_kernel")
    chain = [nm.split(">(")[0] + ">" for nm in names if "spectral_chain" in nm]
    if not any(want in nm for nm in chain) or any("spectral_chain_kernel" in nm for nm in chain):
        return f"a bf16 chain call at D1 = {d1} launches {chain}, expected {want} alone"
    print(f"[3 kernel] bf16 chain at D1 = {d1}: launches {chain}")
    return None


def bf16_redesigns(results, params, mcfg, x):
    """The redesigned bf16 kernels beside the earlier design's times
    (PARENT_DESIGN_MS), their bounds and the f32 arms' times of this run; both
    bf16 spectral forwards and the bf16 recompute backward on the chain
    kernel on tensor cores (`bf16_chain_route`), and the bf16 graph conv as
    one launch a call (no cast kernel before it), by the profiler. Returns an
    error message, or None."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_graph, cuda_spectral

    for name, parent_ms in PARENT_DESIGN_MS.items():
        f32 = results.get(name[: -len("_bf16")], {}).get("ms")
        print(f"[3 kernel] {name}: {results[name]['ms']:.5f} ms a wrapper call (bound "
              f"{results[name]['bound_ms']:.5f}, {results[name]['bound_by']}), the parent "
              f"design's {parent_ms:.5f} (PERF.md), the f32 arm's "
              f"{'n/a' if f32 is None else f'{f32:.5f}'} in this run")
    for name in ("spectral_fwd_save_bf16acts", "spectral_bwd_reread_bf16acts"):
        new, old = results[name], results[name[: -len("acts")]]
        print(f"[3 kernel] {name}: {new['ms']:.5f} ms a wrapper call (bound "
              f"{new['bound_ms']:.5f}, {new['bound_by']}), its f32-storage arm "
              f"{old['name']} {old['ms']:.5f} (bound {old['bound_ms']:.5f}) in this run")
    _, _, mul_L, feat, gfted = forward_inputs(params, mcfg, x)
    glu, multi, bf = params["blocks"][0]["glu"], mcfg.multi_layer, "bfloat16"
    d1 = gfted.shape[1] * gfted.shape[3] * multi
    g = torch.full((*gfted.shape[:3], gfted.shape[3] * multi), 1e-3, device=gfted.device)
    with torch.no_grad():
        for fn in (lambda: cuda_spectral.spe_seq_cell(gfted, glu, multi, bf),
                   lambda: cuda_spectral.spe_seq_cell_save(gfted, glu, multi, bf),
                   lambda: cuda_spectral.spe_seq_cell_bwd(gfted, glu, g, multi, bf)):
            fail = bf16_chain_route(fn, d1)
            if fail is not None:
                return fail
        names = kernels_of_call(lambda: cuda_graph.cheb_graph_conv(mul_L, feat, "bfloat16"))
    if names is None:
        print("[3 kernel] cheb_graph_conv_fwd_bf16: kernels a call not measured")
        return None
    print(f"[3 kernel] cheb_graph_conv_fwd_bf16: {len(names)} kernel(s) a call: {names}")
    if len(names) != 1 or "cheb_graph_conv" not in names[0]:
        return f"cheb_graph_conv_fwd_bf16 launches {names}, expected its one kernel"
    return None


def run() -> int:
    import dataclasses

    import numpy as np
    import torch

    # --- 1. device ---
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[1 device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off")

    sys.path.insert(0, HERE)
    from stemgnn_tpu_torch import bench, ops
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.data import (
        WindowDataset, compute_norm_stats, ensure_dataset, load_csv, split_by_ratio)
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.models.stemgnn import kernel_grad_leaf
    from stemgnn_tpu_torch.ops import _build, cuda_gru, cuda_spectral, torch_impl
    from stemgnn_tpu_torch.train import checkpoint as ckpt
    from stemgnn_tpu_torch.train import engine
    from stemgnn_tpu_torch.train.optim import make_optimizer

    # --- 2. build ---
    out_dir, secs = _build.build_all()
    print(f"[2 build] {len(list(_build.CSRC.glob('*.cu')))} sources -> {out_dir} "
          f"in {secs:.1f} s")

    # --- data and params of both paths ---
    out_root = os.path.join(HERE, "output", "chip_smoke")
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = TrainConfig(dataset="ECG_data", train=False, batch_size=BATCH,
                      window_size=WINDOW, horizon=HORIZON, multi_layer=MULTI,
                      device="cuda", data_dir=os.path.join(HERE, "dataset"),
                      output_dir=out_root)
    data = load_csv(ensure_dataset(cfg.dataset, cfg.data_dir))
    train_data, valid_data, test_data = split_by_ratio(
        data, cfg.train_length, cfg.valid_length, cfg.test_length)
    mcfg = cfg.model_config(data.shape[1])
    stats = compute_norm_stats(train_data, cfg.norm_method)
    sets = {name: WindowDataset(split, cfg.window_size, cfg.horizon,
                                cfg.norm_method, stats)
            for name, split in (("train", train_data), ("valid", valid_data),
                                ("test", test_data))}
    test_set = sets["test"]
    params = init_params(cfg.seed, mcfg, device=dev)

    # one train step of the CPU plain path on the first training batches: the
    # reference of phase 5 and the inputs of the backward kernels in phase 3
    train_batches = sets["train"].epoch_batches(
        BATCH, shuffle=True, rng=np.random.default_rng([cfg.seed, 0]))
    n_nodes = mcfg.units
    masks = torch.from_numpy(
        np.random.default_rng(7).random((3, BATCH, n_nodes, n_nodes))
        < 1.0 - mcfg.dropout_rate)
    train_cpu = torch.from_numpy(sets["train"].data)
    his = [torch.from_numpy(b.astype(np.int64)) for b in train_batches[:3]]
    params_cpu = leaf_params(params, "cpu")
    x_cpu, y_cpu = engine.gather_windows(train_cpu, his[0], WINDOW, HORIZON)
    with OpRecorder(ops) as rec:
        loss_cpu, grads_cpu = step_grads(params_cpu, mcfg, x_cpu, y_cpu, masks[0])

    # --- 3. kernels against their plain versions ---
    hi = torch.from_numpy(test_set.epoch_batches(BATCH, shuffle=False)[0]).long()
    x, _ = engine.gather_windows(torch.from_numpy(test_set.data).to(dev),
                                 hi.to(dev), cfg.window_size, cfg.horizon)
    # the 512-node model of phase 4: a seeded series of two batches of windows
    mcfg_big = cfg.model_config(BIG_NODES)
    params_big = init_params(cfg.seed, mcfg_big, device=dev)
    series_big = np.random.default_rng(5).standard_normal(
        (WINDOW + HORIZON + 2 * BATCH - 1, BIG_NODES))
    big_set = WindowDataset(series_big, cfg.window_size, cfg.horizon, cfg.norm_method,
                            compute_norm_stats(series_big, cfg.norm_method))
    hi_big = torch.from_numpy(big_set.epoch_batches(BATCH, shuffle=False)[0]).long()
    x_big, y_big = engine.gather_windows(torch.from_numpy(big_set.data).to(dev),
                                         hi_big.to(dev), cfg.window_size, cfg.horizon)
    # one train step of the 512-node model on the CPU plain path: the
    # reference of phase 4's train step and the large-H backwards' cotangent
    mask_big = torch.from_numpy(
        np.random.default_rng(8).random((BATCH, BIG_NODES, BIG_NODES))
        < 1.0 - mcfg_big.dropout_rate)
    params_big_cpu = leaf_params(params_big, "cpu")
    with OpRecorder(ops) as rec_big:
        loss_big_cpu, grads_big_cpu = step_grads(params_big_cpu, mcfg_big, x_big.cpu(),
                                                 y_big.cpu(), mask_big)
    # the COVID-19 shape: a seeded 25-node series of one batch of windows, and
    # one train step of its model on the CPU plain path (the reference of
    # phase 4 and the inputs of its spectral backward timings)
    cfg_cov = TrainConfig(dataset="COVID-19", train=False, batch_size=BATCH,
                          window_size=COVID_WINDOW, horizon=COVID_HORIZON,
                          multi_layer=MULTI, device="cuda", data_dir=cfg.data_dir,
                          output_dir=out_root)
    mcfg_cov = cfg_cov.model_config(COVID_NODES)
    params_cov = init_params(cfg.seed, mcfg_cov, device=dev)
    series_cov = np.random.default_rng(6).standard_normal(
        (COVID_WINDOW + COVID_HORIZON + BATCH - 1, COVID_NODES))
    cov_set = WindowDataset(series_cov, COVID_WINDOW, COVID_HORIZON, cfg.norm_method,
                            compute_norm_stats(series_cov, cfg.norm_method))
    hi_cov = torch.from_numpy(cov_set.epoch_batches(BATCH, shuffle=False)[0]).long()
    x_cov, y_cov = engine.gather_windows(torch.from_numpy(cov_set.data).to(dev),
                                         hi_cov.to(dev), COVID_WINDOW, COVID_HORIZON)
    mask_cov = torch.from_numpy(
        np.random.default_rng(9).random((BATCH, COVID_NODES, COVID_NODES))
        < 1.0 - mcfg_cov.dropout_rate)
    with OpRecorder(ops) as rec_cov:
        loss_cov_cpu, grads_cov_cpu = step_grads(leaf_params(params_cov, "cpu"), mcfg_cov,
                                                 x_cov.cpu(), y_cov.cpu(), mask_cov)
    results = {}
    fail = check_cases(forward_cases(params, mcfg, x), results, "3 kernel")
    if fail is None:
        # the grid route (a hidden size no cluster holds): a call takes
        # milliseconds; then the same at synthetic-1k's shape, printed only
        fail = (check_cases(grid_cases(params_big, x_big,
                                       rec_big.calls["gru_over_nodes"][0]["g"]),
                            results, "3 kernel", scaled=True, calls=2, replays=3)
                or grid_timings(dev))
    if fail is None:
        fail = check_cases(backward_cases(rec, params, mcfg, dev), results,
                           "3 kernel", scaled=True)
    if fail is None:
        fail = shape_checks(dev)
    if fail is None:
        fail = spectral_checks(dev, params["blocks"][0]["glu"], MULTI)
    if fail is None:
        # the spectral kernels at the COVID-19 shape, timed as above (printed
        # only: the kernels line keeps the flagship's shapes)
        tag = "3 kernel, COVID-19 shape"
        fail = (check_cases([c for c in forward_cases(params_cov, mcfg_cov, x_cov)
                             if c[0].startswith("spectral")], {}, tag)
                or check_cases([c for c in backward_cases(rec_cov, params_cov, mcfg_cov, dev)
                                if c[0].startswith("spectral")], {}, tag, scaled=True))
    if fail is None:
        # the bf16 arms at the flagship's shapes
        fail = check_bf16_cases(bf16_cases(rec, params, mcfg, x), results, "3 kernel")
    if fail is None:
        # both storage arms of the bf16 saving pair at the COVID-19 shape, timed
        # as above (printed only)
        fail = check_bf16_cases(
            [c for c in bf16_cases(rec_cov, params_cov, mcfg_cov, x_cov)
             if c[0].startswith(("spectral_fwd_save", "spectral_bwd_reread"))],
            {}, "3 kernel, COVID-19 shape")
    if fail is None:
        fail = bf16_redesigns(results, params, mcfg, x)
    if fail is not None:
        return _fail(fail)
    with torch.no_grad():
        call = rec.calls["spe_seq_cell"][0]
        gfted, g_spe = (t.detach().to(dev).contiguous()
                        for t in (call["args"][0], call["g"]))
        glu = params["blocks"][0]["glu"]
        out_plain_fwd = cuda_spectral.spe_seq_cell(gfted, glu, MULTI)
        out_save, acts = cuda_spectral.spe_seq_cell_save(gfted, glu, MULTI)
        dx_a, dglu_a = cuda_spectral.spe_seq_cell_bwd(gfted, glu, g_spe, MULTI)
        dx_b, dglu_b = cuda_spectral.spe_seq_cell_bwd_reread(gfted, glu, g_spe, acts,
                                                             MULTI)
        same = torch.equal(dx_a, dx_b) and all(
            torch.equal(a, b) for a, b in zip(cuda_spectral._flat(dglu_a),
                                              cuda_spectral._flat(dglu_b)))
    if not same or not torch.equal(out_plain_fwd, out_save):
        return _fail("the reread backward's gradients (or the saving forward's "
                     "output) are not bitwise the recompute backward's (the forward's)")
    print(f"[3 kernel] spectral: reread gradients (dx and 24) bitwise equal to the "
          f"recompute gradients; saving forward's output bitwise the forward's; "
          f"saved arrays {tuple(acts.shape)}, {acts.numel() * 4 / 1e6:.1f} MB a call")
    del acts, out_save, dx_a, dx_b, dglu_a, dglu_b
    # the bf16 arm: two recompute backwards, two rereads, both forwards
    bf = "bfloat16"
    with torch.no_grad():
        out_b = cuda_spectral.spe_seq_cell(gfted, glu, MULTI, bf)
        out_bs, acts_b = cuda_spectral.spe_seq_cell_save(gfted, glu, MULTI, bf)
        runs = [cuda_spectral.spe_seq_cell_bwd(gfted, glu, g_spe, MULTI, bf) for _ in range(2)]
        runs += [cuda_spectral.spe_seq_cell_bwd_reread(gfted, glu, g_spe, acts_b, MULTI, bf)
                 for _ in range(2)]
        flat = [[dx] + cuda_spectral._flat(dglu) for dx, dglu in runs]
    same = {label: all(torch.equal(a, c) for a, c in zip(flat[i], flat[j]))
            for label, i, j in (("two recompute backwards", 0, 1), ("two rereads", 2, 3),
                                ("reread and recompute", 0, 2))}
    print(f"[3 kernel] spectral bf16: "
          + "; ".join(f"{label} {'bitwise equal' if ok else 'DIFFER'}"
                      for label, ok in same.items())
          + f"; saving forward's output {'bitwise' if torch.equal(out_b, out_bs) else 'NOT'}"
          f" the forward's")
    if not all(same.values()) or not torch.equal(out_b, out_bs):
        return _fail(f"the bf16 spectral arm is not bitwise repeatable: {same}")
    del acts_b, out_b, out_bs, runs, flat
    limits = cuda_gru.card_limits(dev)
    for label, gru, xb in (("gru_fwd", params["gru"], x), ("gru_fwd_grid", params_big["gru"],
                                                           x_big)):
        with torch.no_grad():
            x_proj = torch_impl.gru_input_projection(gru, xb).contiguous()
            a_all, b_hh = gru["w_hh"].T.contiguous(), gru["b_hh"]
            calls, replays = (20, 10) if label == "gru_fwd" else (2, 3)
            serve_ms, save_ms = (cuda_ms(lambda s=s: cuda_gru._launch_fwd(x_proj, a_all, b_hh, s),
                                         calls=calls, replays=replays) for s in (False, True))
            proj_ms = cuda_ms(lambda: (torch_impl.gru_input_projection(gru, xb).contiguous(),
                                       gru["w_hh"].T.contiguous()))
        plan = cuda_gru.launch_plan(x_proj.shape[1], a_all.shape[0], *limits)
        print(f"[3 kernel] {label} recurrence alone (without the input projection) at "
              f"B={x_proj.shape[1]} H={a_all.shape[0]}, {plan.route} route ({plan.groups} "
              f"groups of {plan.cluster} blocks, {plan.threads} threads, {plan.smem} B "
              f"each): serving variant {serve_ms:.5f} ms, saving variant {save_ms:.5f} ms; "
              f"the wrapper's input projection and copy of W_hh^T {proj_ms:.5f} ms")

    # --- 4. serving path ---
    train_dir = os.path.join(cfg.output_dir, cfg.dataset, "train")
    test_dir = os.path.join(cfg.output_dir, cfg.dataset, "test")
    ckpt.save_norm_stat(train_dir, stats)
    ckpt.save(train_dir, params)
    n_batches = len(test_set.epoch_batches(BATCH, shuffle=False))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = engine.test(test_data, cfg, train_dir, test_dir)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    print(f"[4 serving path] engine.test: {len(test_set)} windows in {n_batches} "
          f"batches, {test_s:.3f} s with the capture of its eval program; wrapper "
          f"launches {launches}; launched by graph replays {replayed}")
    # the full batches are one replay of a captured graph, after one warm
    # batch; the short last batch is an eager call
    n_full = n_batches - (1 if len(test_set) % BATCH else 0)
    fwd_per_batch = {"gru_fwd": 1, "attention_kq_fwd": 1, "cheb_graph_conv_fwd": 2,
                     "spectral_fwd": 2}
    want = dict.fromkeys(ops.KERNELS, 0)
    want_replayed = dict(want)
    for name, n in fwd_per_batch.items():
        want[name] = n * (1 + n_batches - n_full)
        want_replayed[name] = n * n_full
    if launches != want or replayed != want_replayed:
        return _fail(f"launch counts {launches} and {replayed}, expected {want} "
                     f"and {want_replayed}")
    for k in ("mae", "mape", "rmse"):
        if not math.isfinite(float(metrics[k])):
            return _fail(f"test {k} is {metrics[k]}")
    for f in ("target.csv", "predict.csv", "predict_abs_error.csv", "predict_ape.csv"):
        if not os.path.exists(os.path.join(test_dir, f)):
            return _fail(f"{f} not written")

    step = engine.make_eval_step(mcfg, dev)
    fc_gpu, tg_gpu = engine.inference_batched(step, params, test_set, BATCH, dev)
    fc_cpu, tg_cpu = engine.inference_batched(
        engine.make_eval_step(mcfg, "cpu"), ckpt.load(train_dir, device="cpu")[0],
        test_set, BATCH, "cpu")
    shape = (len(test_set), cfg.horizon, mcfg.units)
    if fc_gpu.shape != shape or not np.isfinite(fc_gpu).all():
        return _fail(f"forecasts {fc_gpu.shape}, expected {shape} and finite")
    fc_err = float(abs(fc_gpu - fc_cpu).max())
    print(f"[4 serving path] test forecasts, card vs CPU plain path: max_abs_err "
          f"{fc_err:.3e} (atol 1e-3, normalized values)")
    if fc_err > 1e-3 or (tg_gpu != tg_cpu).any():
        return _fail(f"card forecasts differ from the CPU plain path by {fc_err}")

    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.inference_batched(step, params, test_set, BATCH, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wps = len(test_set) / statistics.median(walls[1:])
    print(f"[4 serving path] eval {wps:.1f} windows/s (median of 3 passes over the "
          f"test split, batch {BATCH}, after one warm pass)")

    # the same at compute_dtype bfloat16: engine.test with the counters set to
    # 0 just before and read just after, then the test-split forecasts against
    # the CPU bf16 plain path (tolerance as at f32), the f32 card forecasts beside
    cfg_bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    test_dir_bf = os.path.join(cfg.output_dir, cfg.dataset, "test_bf16")
    ops.reset_launches()
    metrics_bf = engine.test(test_data, cfg_bf, train_dir, test_dir_bf)
    torch.cuda.synchronize()
    launches, replayed = take_launches(ops, results)
    fwd_per_batch_bf16 = {"gru_fwd": 1, "attention_kq_fwd": 1,
                          "cheb_graph_conv_fwd_bf16": 2, "spectral_fwd_bf16": 2}
    want = dict.fromkeys(ops.KERNELS, 0)
    want_replayed = dict(want)
    for name, n in fwd_per_batch_bf16.items():
        want[name] = n * (1 + n_batches - n_full)
        want_replayed[name] = n * n_full
    if launches != want or replayed != want_replayed:
        return _fail(f"bf16 serving launch counts {launches} and {replayed}, expected "
                     f"{want} and {want_replayed}")
    if not all(math.isfinite(float(metrics_bf[k])) for k in ("mae", "mape", "rmse")):
        return _fail(f"bf16 test metrics {metrics_bf}")
    fc_bf, _ = engine.inference_batched(engine.make_eval_step(mcfg, dev, "bfloat16"), params,
                                        test_set, BATCH, dev)
    fc_bf_cpu, _ = engine.inference_batched(
        engine.make_eval_step(mcfg, "cpu", "bfloat16"), ckpt.load(train_dir, device="cpu")[0],
        test_set, BATCH, "cpu")
    if fc_bf.shape != fc_gpu.shape or not np.isfinite(fc_bf).all():
        return _fail(f"bf16 forecasts {fc_bf.shape}, expected {fc_gpu.shape} and finite")
    bf_err = float(abs(fc_bf - fc_bf_cpu).max())
    print(f"[4 serving path] bf16: engine.test at compute_dtype bfloat16, wrapper launches "
          f"{launches}; launched by graph replays {replayed}; test MAE "
          f"{float(metrics_bf['mae']):.6f} (f32: {float(metrics['mae']):.6f}); forecasts, "
          f"card vs CPU bf16 plain path: max_abs_err {bf_err:.3e} (atol 1e-3, normalized "
          f"values); bf16 vs f32 card forecasts differ by up to "
          f"{float(abs(fc_bf - fc_gpu).max()):.3e}")
    if bf_err > 1e-3:
        return _fail(f"bf16 card forecasts differ from the CPU bf16 plain path by {bf_err}")

    # the 512-node model: two eager batches, each one launch of the grid GRU
    # forward and of the other forward kernels
    step_big = engine.make_eval_step(mcfg_big, dev)
    ops.reset_launches()
    fc_big, _ = engine.inference_batched(step_big, params_big, big_set, BATCH, dev)
    launches, replayed = take_launches(ops, results)
    want = dict.fromkeys(ops.KERNELS, 0)
    for name, n in fwd_per_batch.items():
        want["gru_fwd_grid" if name == "gru_fwd" else name] = 2 * n
    if launches != want or any(replayed.values()):
        return _fail(f"{BIG_NODES}-node serving path launch counts {launches} and "
                     f"{replayed}, expected {want}")
    cpu_big = leaf_params(params_big, "cpu")
    fc_big_cpu, _ = engine.inference_batched(
        engine.make_eval_step(mcfg_big, "cpu"), cpu_big, big_set, BATCH, "cpu")
    shape = (len(big_set), cfg.horizon, BIG_NODES)
    if fc_big.shape != shape or not np.isfinite(fc_big).all():
        return _fail(f"{BIG_NODES}-node forecasts {fc_big.shape}, expected {shape} "
                     "and finite")
    big_err = float(abs(fc_big - fc_big_cpu).max())
    print(f"[4 serving path] {BIG_NODES}-node model, {len(big_set)} windows in 2 "
          f"batches through engine.inference_batched: "
          f"wrapper launches {launches}; forecasts, card vs CPU plain path: "
          f"max_abs_err {big_err:.3e} (atol 1e-3)")
    if big_err > 1e-3:
        return _fail(f"{BIG_NODES}-node card forecasts differ from the CPU plain path "
                     f"by {big_err}")
    # and one train step of it, counters set to 0 just before and read just
    # after, against the CPU plain path's step of phase 3 (same dropout mask)
    params_big_gpu = leaf_params(params_big, dev)
    ops.reset_launches()
    loss_big, grads_big = step_grads(params_big_gpu, mcfg_big, x_big, y_big,
                                     mask_big.to(dev))
    torch.cuda.synchronize()
    launches, replayed = take_launches(ops, results)
    spe_pair = (("spectral_fwd_save", "spectral_bwd_reread")
                if cuda_spectral.SAVE_ACTS_BWD else ("spectral_fwd", "spectral_bwd"))
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"gru_fwd_grid": 1, "gru_bwd_grid": 1, "attention_kq_fwd": 1,
                 "attention_kq_bwd": 1, "cheb_graph_conv_fwd": 2, spe_pair[0]: 2,
                 spe_pair[1]: 2})
    if launches != want or any(replayed.values()):
        return _fail(f"{BIG_NODES}-node train step launch counts {launches} and "
                     f"{replayed}, expected {want}")
    bad, worst, worst_name = compare_grads(grads_big, grads_big_cpu)
    loss_err = abs(loss_big.item() - loss_big_cpu.item())
    print(f"[4 serving path] {BIG_NODES}-node model, one train step on the card: "
          f"wrapper launches {launches}; loss {loss_big.item():.6f} "
          f"(abs err {loss_err:.3e}, atol 1e-5); {len(grads_big)} gradients against "
          f"the CPU plain path, worst max_abs_err {worst:.3e} at {worst_name} (atol "
          f"{GRAD_ATOL_REL:g} of each gradient's largest entry, rtol {GRAD_RTOL:g})")
    if loss_err > 1e-5 or bad:
        return _fail(f"{BIG_NODES}-node step gradients differ from the CPU plain path: "
                     f"loss err {loss_err}, leaves (name, err, max) {bad[:5]}")
    del params_big_gpu, grads_big

    # one train step of synthetic-1k's shape (benchmarks/suite.py
    # LARGE_CONFIGS: N = 1024, W = 12, horizon 3, multi 5, batch 8, dense) on a
    # seeded series: the grid kernels at H = 1024, counters set to 0 just
    # before and read just after, the loss and gradients against the CPU
    # plain path's step with the same dropout mask
    mcfg_1k = cfg.model_config(S1K_NODES)
    params_1k = init_params(cfg.seed, mcfg_1k, device=dev)
    series_1k = np.random.default_rng(10).standard_normal(
        (WINDOW + HORIZON + S1K_BATCH - 1, S1K_NODES))
    set_1k = WindowDataset(series_1k, WINDOW, HORIZON, cfg.norm_method,
                           compute_norm_stats(series_1k, cfg.norm_method))
    hi_1k = torch.from_numpy(set_1k.epoch_batches(S1K_BATCH, shuffle=False)[0]).long()
    x_1k, y_1k = engine.gather_windows(torch.from_numpy(set_1k.data).to(dev), hi_1k.to(dev),
                                       WINDOW, HORIZON)
    mask_1k = torch.from_numpy(
        np.random.default_rng(12).random((S1K_BATCH, S1K_NODES, S1K_NODES))
        < 1.0 - mcfg_1k.dropout_rate)
    t0 = time.perf_counter()
    loss_1k_cpu, grads_1k_cpu = step_grads(leaf_params(params_1k, "cpu"), mcfg_1k,
                                           x_1k.cpu(), y_1k.cpu(), mask_1k)
    cpu_1k_s = time.perf_counter() - t0
    params_1k_gpu = leaf_params(params_1k, dev)
    ops.reset_launches()
    loss_1k, grads_1k = step_grads(params_1k_gpu, mcfg_1k, x_1k, y_1k, mask_1k.to(dev))
    torch.cuda.synchronize()
    launches, replayed = take_launches(ops, results)
    if launches != want or any(replayed.values()):
        return _fail(f"synthetic-1k train step launch counts {launches} and {replayed}, "
                     f"expected {want}")
    bad, worst, worst_name = compare_grads(grads_1k, grads_1k_cpu)
    loss_err = abs(loss_1k.item() - loss_1k_cpu.item())
    print(f"[4 serving path] synthetic-1k shape (N={S1K_NODES}, W={WINDOW}, horizon "
          f"{HORIZON}, multi {MULTI}, batch {S1K_BATCH}), one train step on the card: wrapper "
          f"launches {launches}; loss {loss_1k.item():.6f} (abs err {loss_err:.3e}, atol "
          f"1e-5); {len(grads_1k)} gradients against the CPU plain path ({cpu_1k_s:.1f} s "
          f"on the host), worst max_abs_err {worst:.3e} at {worst_name} (atol "
          f"{GRAD_ATOL_REL:g} of each gradient's largest entry, rtol {GRAD_RTOL:g})")
    if loss_err > 1e-5 or bad:
        return _fail(f"synthetic-1k step gradients differ from the CPU plain path: loss "
                     f"err {loss_err}, leaves (name, err, max) {bad[:5]}")
    del params_1k_gpu, grads_1k, grads_1k_cpu

    # the COVID-19 shape: one batch through engine.inference_batched and one
    # train step, counters set to 0 just before and read just after each,
    # against the CPU plain path (tolerances of the 512-node model)
    ops.reset_launches()
    fc_cov, _ = engine.inference_batched(engine.make_eval_step(mcfg_cov, dev), params_cov,
                                         cov_set, BATCH, dev)
    launches, replayed = take_launches(ops, results)
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(fwd_per_batch)
    if launches != want or any(replayed.values()):
        return _fail(f"COVID-19 serving path launch counts {launches} and {replayed}, "
                     f"expected {want}")
    fc_cov_cpu, _ = engine.inference_batched(
        engine.make_eval_step(mcfg_cov, "cpu"), leaf_params(params_cov, "cpu"), cov_set,
        BATCH, "cpu")
    shape = (BATCH, COVID_HORIZON, COVID_NODES)
    if fc_cov.shape != shape or not np.isfinite(fc_cov).all():
        return _fail(f"COVID-19 forecasts {fc_cov.shape}, expected {shape} and finite")
    cov_err = float(abs(fc_cov - fc_cov_cpu).max())
    print(f"[4 serving path] COVID-19 shape (N={COVID_NODES}, W={COVID_WINDOW}, horizon "
          f"{COVID_HORIZON}, multi {MULTI}), {len(cov_set)} windows in 1 batch through "
          f"engine.inference_batched: wrapper launches {launches}; forecasts, card vs CPU "
          f"plain path: max_abs_err {cov_err:.3e} (atol 1e-3)")
    if cov_err > 1e-3:
        return _fail(f"COVID-19 card forecasts differ from the CPU plain path by {cov_err}")
    params_cov_gpu = leaf_params(params_cov, dev)
    ops.reset_launches()
    loss_cov, grads_cov = step_grads(params_cov_gpu, mcfg_cov, x_cov, y_cov, mask_cov.to(dev))
    torch.cuda.synchronize()
    launches, replayed = take_launches(ops, results)
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"gru_fwd": 1, "gru_bwd": 1, "attention_kq_fwd": 1, "attention_kq_bwd": 1,
                 "cheb_graph_conv_fwd": 2, spe_pair[0]: 2, spe_pair[1]: 2})
    if launches != want or any(replayed.values()):
        return _fail(f"COVID-19 train step launch counts {launches} and {replayed}, "
                     f"expected {want}")
    bad, worst, worst_name = compare_grads(grads_cov, grads_cov_cpu)
    loss_err = abs(loss_cov.item() - loss_cov_cpu.item())
    print(f"[4 serving path] COVID-19 shape, one train step on the card: wrapper launches "
          f"{launches}; loss {loss_cov.item():.6f} (abs err {loss_err:.3e}, atol 1e-5); "
          f"{len(grads_cov)} gradients against the CPU plain path, worst max_abs_err "
          f"{worst:.3e} at {worst_name} (atol {GRAD_ATOL_REL:g} of each gradient's "
          f"largest entry, rtol {GRAD_RTOL:g})")
    if loss_err > 1e-5 or bad:
        return _fail(f"COVID-19 step gradients differ from the CPU plain path: loss err "
                     f"{loss_err}, leaves (name, err, max) {bad[:5]}")
    del params_cov_gpu, grads_cov

    # --- 5. train path ---
    cfg_t = TrainConfig(dataset="ECG_data", train=True, epoch=1, batch_size=BATCH,
                        window_size=WINDOW, horizon=HORIZON, multi_layer=MULTI,
                        optimizer="RMSProp", dropout_rate=0.5, device="cuda",
                        data_dir=cfg.data_dir, output_dir=out_root)
    run_dir = os.path.join(out_root, cfg.dataset, "train_run")
    steps = len(train_batches)
    valid_batches = len(sets["valid"].epoch_batches(BATCH, shuffle=False))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    valid_metrics, _ = engine.train(train_data, valid_data, cfg_t, run_dir)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    print(f"[5 train path] engine.train: 1 epoch of {steps} steps ({len(sets['train'])} "
          f"windows) and a validate pass of {valid_batches} batches, {train_s:.3f} s "
          f"with the captures of its chunk and eval programs; wrapper launches "
          f"{launches}; launched by graph replays {replayed}")
    # train: the full batches go through replays of captured chunks (greedy
    # over CHUNK_SIZES), after WARM_STEPS eager steps before the first capture;
    # what no chunk takes, and the short last batch, are eager steps. validate:
    # as phase 4.
    full_steps = steps - (1 if len(sets["train"]) % BATCH else 0)
    chunked, left = 0, full_steps
    for size in engine.CHUNK_SIZES:
        chunked += left // size * size
        left %= size
    eager_steps = engine.WARM_STEPS + steps - chunked
    valid_full = valid_batches - (1 if len(sets["valid"]) % BATCH else 0)
    # a train step's spectral pair follows the package's switch; eval forwards
    # record no gradient and launch the plain forward
    train_spe = (("spectral_fwd_save", "spectral_bwd_reread")
                 if cuda_spectral.SAVE_ACTS_BWD else ("spectral_fwd", "spectral_bwd"))
    step_kernels = {"gru_fwd": 1, "gru_bwd": 1, "attention_kq_fwd": 1,
                    "attention_kq_bwd": 1, "cheb_graph_conv_fwd": 2,
                    train_spe[0]: 2, train_spe[1]: 2}
    want = dict.fromkeys(ops.KERNELS, 0)
    want_replayed = dict(want)
    for name, n in step_kernels.items():
        want[name] = n * eager_steps
        want_replayed[name] = n * chunked
    for name, n in fwd_per_batch.items():
        want[name] += n * (1 + valid_batches - valid_full)
        want_replayed[name] += n * valid_full
    if launches != want or replayed != want_replayed:
        return _fail(f"train path launch counts {launches} and {replayed}, expected "
                     f"{want} and {want_replayed}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    if len(epochs) != 1 or not all(math.isfinite(e["loss"]) for e in epochs):
        return _fail(f"epoch events {epochs}")
    if not any(e["event"] == "validate" for e in events):
        return _fail("no validate event in metrics.jsonl")
    if not math.isfinite(float(valid_metrics["mae"])):
        return _fail(f"validate MAE is {valid_metrics['mae']}")
    for f in ("norm_stat.json", "0_stemgnn.ckpt", "_stemgnn.ckpt"):
        if not os.path.exists(os.path.join(run_dir, f)):
            return _fail(f"{f} not written by engine.train")
    print(f"[5 train path] epoch loss {epochs[0]['loss']:.6f}, validate MAE "
          f"{float(valid_metrics['mae']):.6f}; checkpoints and metrics.jsonl written")

    # one epoch at compute_dtype bfloat16, counters set to 0 just before and
    # read just after: the same launches with the bf16 arms in place of the
    # graph conv's and spectral kernels' f32 ones
    run_dir_bf = os.path.join(out_root, cfg.dataset, "train_run_bf16")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    valid_bf, _ = engine.train(train_data, valid_data,
                               dataclasses.replace(cfg_t, compute_dtype="bfloat16"), run_dir_bf)
    torch.cuda.synchronize()
    train_bf_s = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    bf_arm = {"cheb_graph_conv_fwd": "cheb_graph_conv_fwd_bf16",
              "spectral_fwd": "spectral_fwd_bf16", "spectral_bwd": "spectral_bwd_bf16",
              "spectral_fwd_save": "spectral_fwd_save_bf16",
              "spectral_bwd_reread": "spectral_bwd_reread_bf16"}
    want_bf = dict.fromkeys(ops.KERNELS, 0)
    want_bf_replayed = dict(want_bf)
    for name in ops.KERNELS:
        if want[name] or want_replayed[name]:
            want_bf[bf_arm.get(name, name)] = want[name]
            want_bf_replayed[bf_arm.get(name, name)] = want_replayed[name]
    if launches != want_bf or replayed != want_bf_replayed:
        return _fail(f"bf16 train path launch counts {launches} and {replayed}, expected "
                     f"{want_bf} and {want_bf_replayed}")
    with open(os.path.join(run_dir_bf, "metrics.jsonl")) as f:
        epochs_bf = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    if (len(epochs_bf) != 1 or not math.isfinite(epochs_bf[0]["loss"])
            or not math.isfinite(float(valid_bf["mae"]))):
        return _fail(f"bf16 epoch events {epochs_bf}, validate {valid_bf}")
    print(f"[5 train path] engine.train at compute_dtype bfloat16: 1 epoch, {train_bf_s:.3f} "
          f"s with its captures; wrapper launches {launches}; launched by graph replays "
          f"{replayed}; epoch loss {epochs_bf[0]['loss']:.6f} (f32 {epochs[0]['loss']:.6f}), "
          f"validate MAE {float(valid_bf['mae']):.6f} (f32 "
          f"{float(valid_metrics['mae']):.6f})")

    # (a) one step on the card against the CPU plain path, same dropout mask
    # (tolerance: `compare_grads`)
    train_dev = train_cpu.to(dev)
    params_gpu = leaf_params(params, dev)
    x_gpu, y_gpu = engine.gather_windows(train_dev, his[0].to(dev), WINDOW, HORIZON)
    mask0 = masks[0].to(dev)
    loss_gpu, grads_gpu = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0)
    grads_gpu = {k: g.clone() for k, g in grads_gpu.items()}
    bad, worst, worst_name = compare_grads(grads_gpu, grads_cpu)
    loss_err = abs(loss_gpu.item() - loss_cpu.item())
    gmax = max(g.abs().max().item() for g in grads_cpu.values())
    print(f"[5 train path] one step, card vs CPU plain path: loss {loss_gpu.item():.6f} "
          f"(abs err {loss_err:.3e}, atol 1e-5); {len(grads_cpu)} gradients, worst "
          f"max_abs_err {worst:.3e} at {worst_name} (atol {GRAD_ATOL_REL:g} of each "
          f"gradient's largest entry, rtol {GRAD_RTOL:g}; largest entry of all "
          f"{gmax:.3e})")
    if loss_err > 1e-5 or bad:
        return _fail(f"step gradients differ from the CPU plain path: loss err "
                     f"{loss_err}, leaves (name, err, max) {bad[:5]}")

    # (b) the same step again: bitwise the same gradients (no atomics)
    loss_again, grads_again = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0)
    differ = [k for k, g in grads_again.items() if not torch.equal(g, grads_gpu[k])]
    if differ or not torch.equal(loss_again, loss_gpu):
        return _fail(f"two runs of one step differ in {differ[:5]}")
    print(f"[5 train path] the same step twice: loss and all {len(grads_gpu)} "
          "gradients bitwise equal")

    # (b') the same step at compute_dtype bfloat16, twice, against the CPU bf16
    # plain path (loss atol 1e-5; each gradient within BF16_ATOL_REL of its
    # largest entry, and BF16_CLOSER times closer to the CPU bf16 gradients
    # than to the CPU f32 ones)
    loss_cpu_bf, grads_cpu_bf = step_grads(leaf_params(params, "cpu"), mcfg, x_cpu, y_cpu,
                                           masks[0], "bfloat16")
    loss_bf, grads_bf = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0, "bfloat16")
    grads_bf = {k: g.clone() for k, g in grads_bf.items()}
    loss_bf2, grads_bf2 = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0, "bfloat16")
    differ = [k for k, g in grads_bf2.items() if not torch.equal(g, grads_bf[k])]
    names = list(grads_cpu_bf)
    bad, worst, ratio, rel = bf16_agreement([grads_bf[k] for k in names],
                                       [grads_cpu_bf[k] for k in names],
                                       [grads_cpu[k] for k in names], BF16_ATOL_REL)
    loss_err = abs(loss_bf.item() - loss_cpu_bf.item())
    print(f"[5 train path] one bf16 step, card vs CPU bf16 plain path: loss "
          f"{loss_bf.item():.6f} (abs err {loss_err:.3e}, atol 1e-5; f32 step "
          f"{loss_gpu.item():.6f}); {len(names)} gradients, worst max_abs_err {worst:.3e} "
          f"({rel:.3e} of its gradient's largest entry) "
          f"(each within {BF16_ATOL_REL:.4g} of its largest entry: "
          f"{'yes' if not bad else 'NO, ' + ', '.join(names[i] for i in bad[:5])}; "
          f"{ratio:.1f} times closer to the CPU bf16 gradients than to the CPU f32 ones, "
          f"at least {BF16_CLOSER:g}); the same step twice "
          f"{'bitwise equal' if not differ and torch.equal(loss_bf, loss_bf2) else 'DIFFERS'}")
    if loss_err > 1e-5 or bad or ratio < BF16_CLOSER or differ or not torch.equal(
            loss_bf, loss_bf2):
        return _fail(f"bf16 step differs from the CPU bf16 plain path: loss err {loss_err}, "
                     f"leaves {[names[i] for i in bad[:5]]}, ratio {ratio}, rerun {differ[:5]}")

    # (b2) the same bf16 step with the spectral pair's bf16-storage arm
    # (SAVE_ACTS_F32 off), counters set to 0 just before and read just after,
    # twice, against the CPU bf16 plain path with the same switch (as (b'))
    cuda_spectral.SAVE_ACTS_F32 = False
    try:
        ops.reset_launches()
        loss_bs, grads_bs = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0, "bfloat16")
        torch.cuda.synchronize()
        launches, replayed = take_launches(ops, results)
        grads_bs = {k: g.clone() for k, g in grads_bs.items()}
        loss_bs2, grads_bs2 = step_grads(params_gpu, mcfg, x_gpu, y_gpu, mask0, "bfloat16")
        loss_cpu_bs, grads_cpu_bs = step_grads(leaf_params(params, "cpu"), mcfg, x_cpu, y_cpu,
                                               masks[0], "bfloat16")
    finally:
        cuda_spectral.SAVE_ACTS_F32 = True
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({"gru_fwd": 1, "gru_bwd": 1, "attention_kq_fwd": 1, "attention_kq_bwd": 1,
                 "cheb_graph_conv_fwd_bf16": 2})
    want.update(dict.fromkeys(("spectral_fwd_save_bf16acts", "spectral_bwd_reread_bf16acts")
                              if cuda_spectral.SAVE_ACTS_BWD
                              else ("spectral_fwd_bf16", "spectral_bwd_bf16"), 2))
    differ = [k for k, g in grads_bs2.items() if not torch.equal(g, grads_bs[k])]
    bad, worst, ratio, rel = bf16_agreement([grads_bs[k] for k in names],
                                            [grads_cpu_bs[k] for k in names],
                                            [grads_cpu[k] for k in names], BF16_ATOL_REL)
    loss_err = abs(loss_bs.item() - loss_cpu_bs.item())
    moved = max(((grads_bs[k] - grads_bf[k]).abs().max() / grads_bf[k].abs().max().clamp_min(
        1e-30)).item() for k in names)
    print(f"[5 train path] one bf16 step with bf16 saved arrays (SAVE_ACTS_F32 off), card vs "
          f"CPU bf16 plain path with the same switch: wrapper launches {launches}; loss "
          f"{loss_bs.item():.6f} (abs err {loss_err:.3e}, atol 1e-5); gradients worst "
          f"max_abs_err {worst:.3e} ({rel:.3e} of its largest entry; each within "
          f"{BF16_ATOL_REL:.4g}: {'yes' if not bad else 'NO, ' + str(bad[:5])}; "
          f"{ratio:.1f} times closer to the CPU bf16 gradients than to the CPU f32 ones); the "
          f"same step twice {'bitwise equal' if not differ else 'DIFFERS'}; up to "
          f"{moved:.3e} of a gradient's largest entry from the f32-storage step's")
    if (launches != want or any(replayed.values()) or loss_err > 1e-5 or bad
            or ratio < BF16_CLOSER or differ or not torch.equal(loss_bs, loss_bs2)):
        return _fail(f"bf16-storage step: launches {launches} (expected {want}), loss err "
                     f"{loss_err}, leaves {[names[i] for i in bad[:5]]}, ratio {ratio}, rerun "
                     f"{differ[:5]}")

    # (b3) one step at param_dtype bfloat16 at each compute_dtype, on the card
    # and on the CPU (the same bf16 parameters, batch and mask), through the
    # engine's train step and the leafwise RMSprop. On each side, beside the
    # step of f32 parameters that hold the same bf16 values (`step_grads`):
    # every gradient the optimizer is handed and every moment of the dtype the
    # JAX package's Pallas path gives it (f32 for the leaves whose gradient a
    # kernel returns, bf16 for the rest), and bitwise that step's gradient
    # (rounded to bf16 where bf16): what param_dtype adds to a step is the
    # promotion, the dtypes and the rounding, nothing else. Card against CPU:
    # the loss within 1e-5; each gradient within its arm's tolerance (as (a)
    # and (b')) plus twice the distance of the two sides' f32-parameter steps
    # on that leaf (with bf16-valued weights an attention score can sit on the
    # LeakyReLU's kink, where the two sides' sums take other branches) plus a
    # bf16 ulp (2^-7) of a bf16 one. The card's parameters and moments after
    # the step bitwise what the CPU's leafwise RMSprop makes of the card's own
    # gradients from the same parameters (the update is elementwise IEEE
    # arithmetic, rounded alike on both)
    for cd, g_tol, g_rtol in (("float32", GRAD_ATOL_REL, GRAD_RTOL),
                              ("bfloat16", BF16_ATOL_REL, 0.0)):
        runs, bad = {}, []
        for where, src, xb, yb in (("cpu", train_cpu, x_cpu, y_cpu),
                                   ("cuda", train_dev, x_gpu, y_gpu)):
            flat_p = {k: v.detach().to(where).to(torch.bfloat16).requires_grad_(True)
                      for k, v in flatten_params(params).items()}
            opt_p = make_optimizer("RMSProp", flat_p.values(), cfg_t.lr)
            handed, real_step = [], opt_p.step
            opt_p.step = lambda grads, h=handed, s=real_step: (h.append(list(grads)), s(grads))
            before = {k: v.detach().clone() for k, v in flat_p.items()}
            loss_p = engine.make_train_step(mcfg, opt_p, flat_p.values(), compute_dtype=cd)(
                unflatten_params(flat_p), src, his[0].to(where), dropout_mask=masks[0].to(where))
            _, ref = step_grads(leaf_params({k: v.float() for k, v in before.items()}, where),
                                mcfg, xb, yb, masks[0].to(where), cd)
            grads_p = dict(zip(flat_p, handed[0]))
            for k, g in grads_p.items():
                want_dtype = torch.float32 if kernel_grad_leaf(k) else torch.bfloat16
                dtypes = {g.dtype, opt_p.state[flat_p[k]]["square_avg"].dtype}
                if dtypes != {want_dtype} or flat_p[k].dtype != torch.bfloat16:
                    bad.append(f"{where} {k} dtypes {dtypes}")
                elif not torch.equal(g, ref[k].to(want_dtype)):
                    bad.append(f"{where} {k} gradient not the f32-parameter step's")
            if where == "cuda":
                flat_r = {k: v.detach().cpu().clone().requires_grad_(True)
                          for k, v in before.items()}
                opt_r = make_optimizer("RMSProp", flat_r.values(), cfg_t.lr)
                opt_r.step([grads_p[k].detach().cpu() for k in flat_r])
                for k, p in flat_r.items():
                    if not (torch.equal(p, flat_p[k].detach().cpu()) and torch.equal(
                            opt_r.state[p]["square_avg"],
                            opt_p.state[flat_p[k]]["square_avg"].cpu())):
                        bad.append(f"{k}: the card's RMSprop step is not the CPU's on its "
                                   f"gradients")
            runs[where] = (loss_p.item(), grads_p, flat_p, before,
                           {k: v.detach().cpu() for k, v in ref.items()})
        (l_cpu, g_cpu, p_cpu, _, ref_cpu), (l_gpu, g_gpu, _, _, ref_gpu) = (
            runs["cpu"], runs["cuda"])
        for k in p_cpu:
            if any(k in b_ for b_ in bad):
                continue
            gc, gg = g_cpu[k].float(), g_gpu[k].detach().float().cpu()
            ulp = BF16_ULP if g_cpu[k].dtype == torch.bfloat16 else 0.0
            noise = (ref_gpu[k] - ref_cpu[k]).abs().max()
            tol = g_tol * gc.abs().max() + 1e-12 + 2 * noise + (g_rtol + ulp) * gc.abs()
            if not bool(((gg - gc).abs() <= tol).all()):
                bad.append(f"{k} gradient {(gg - gc).abs().max().item():.3e} (the f32 steps' "
                           f"distance {noise.item():.3e})")
        n_f32 = sum(kernel_grad_leaf(k) for k in p_cpu)
        print(f"[5 train path] one step at param_dtype bfloat16, compute_dtype {cd}: on the "
              f"card and on the CPU, {n_f32} gradients and RMSProp moments f32, "
              f"{len(p_cpu) - n_f32} bf16, each gradient bitwise the f32-parameter step's on "
              f"the same values (rounded where bf16); card vs CPU: loss {l_gpu:.6f} (abs err "
              f"{abs(l_gpu - l_cpu):.3e}, atol 1e-5), gradients within {g_tol:g} of their "
              f"largest entry, rtol {g_rtol:g}, twice the f32 steps' distance and a bf16 ulp; "
              f"the card's parameters and moments bitwise the CPU's RMSprop on the card's "
              f"gradients: {'yes' if not bad else 'NO, ' + ', '.join(bad[:4])}")
        if bad or abs(l_gpu - l_cpu) > 1e-5:
            return _fail(f"param_dtype bfloat16 step at compute_dtype {cd}: {bad[:6]}, loss "
                         f"{l_gpu} against {l_cpu}")

    # (c) three RMSProp steps, card against CPU, masks from one numpy seed. An
    # RMSProp step moves an entry by up to lr / sqrt(1 - alpha) = 1e-3 whatever
    # the gradient's size, so entries whose gradient is rounding noise may differ
    # by a fraction of that.
    PARAM_ATOL = 1e-4
    finals = {}
    for where, tree, src in (("cpu", leaf_params(params, "cpu"), train_cpu),
                             (dev, leaf_params(params, dev), train_dev)):
        flat = flatten_params(tree)
        opt = make_optimizer("RMSProp", flat.values(), cfg_t.lr)
        for i in range(3):
            xb, yb = engine.gather_windows(src, his[i].to(where), WINDOW, HORIZON)
            _, grads = step_grads(tree, mcfg, xb, yb, masks[i].to(where))
            for k, p in flat.items():
                p.grad = grads[k]
            opt.step()
        finals[str(where)] = {k: p.detach().cpu() for k, p in flat.items()}
    init_flat = flatten_params(params)
    perr = max((finals["cuda"][k] - finals["cpu"][k]).abs().max().item()
               for k in finals["cpu"])
    moved = max((finals["cpu"][k] - init_flat[k].cpu()).abs().max().item()
                for k in finals["cpu"])
    print(f"[5 train path] parameters after three RMSProp steps, card vs CPU: "
          f"max_abs_err {perr:.3e} (atol {PARAM_ATOL:g}; the steps moved an entry by "
          f"up to {moved:.3e})")
    if not perr <= PARAM_ATOL:
        return _fail(f"three-step trajectory differs from the CPU's by {perr}")

    # (e) train windows/s: one more epoch of steps through the engine's train
    # step, host clock from before the first step to after the last has
    # finished on the card
    tree = leaf_params(params, dev)
    flat = flatten_params(tree)
    opt = make_optimizer("RMSProp", flat.values(), cfg_t.lr)
    train_step = engine.make_train_step(mcfg, opt, flat.values())
    gen = torch.Generator(device=dev)
    gen.manual_seed(engine.epoch_generator_seed(cfg_t.seed, 1))
    his_dev = [torch.from_numpy(b.astype(np.int64)).to(dev) for b in train_batches]
    for hi_b in his_dev[:3]:
        train_step(tree, train_dev, hi_b, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hi_b in his_dev:
        train_step(tree, train_dev, hi_b, gen)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    n_win = sum(len(b) for b in train_batches)
    kernel_ms = sum(results[k]["ms"] * n for k, n in step_kernels.items())
    print(f"[5 train path] train step {epoch_s / steps * 1e3:.3f} ms of host clock "
          f"({steps} steps, batch {BATCH}, after 3 warm steps); the step's kernels' "
          f"device time per step from phase 3: {kernel_ms:.3f} ms")
    print(f"[5 train path] train {n_win / epoch_s:.1f} windows/s")
    profile_steps(lambda hi_b: train_step(tree, train_dev, hi_b, gen), his_dev[:10],
                  epoch_s / steps * 1e3)
    # the same at compute_dtype bfloat16: the bf16 arms' kernels alone, without
    # their wrappers' casts
    tree_bf = leaf_params(params, dev)
    flat_bf = flatten_params(tree_bf)
    step_bf = engine.make_train_step(mcfg, make_optimizer("RMSProp", flat_bf.values(), cfg_t.lr),
                                     flat_bf.values(), compute_dtype="bfloat16")
    for hi_b in his_dev[:3]:
        step_bf(tree_bf, train_dev, hi_b, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hi_b in his_dev[3:13]:
        step_bf(tree_bf, train_dev, hi_b, gen)
    torch.cuda.synchronize()
    profile_steps(lambda hi_b: step_bf(tree_bf, train_dev, hi_b, gen), his_dev[:10],
                  (time.perf_counter() - t0) / 10 * 1e3, "5 train path, bf16")
    del tree_bf, flat_bf, step_bf

    # --- 6. chunk path: a captured chunk against the same steps taken eagerly ---
    CHUNK = 16
    finals = {}
    for mode in ("eager", "chunk"):
        tree_c = leaf_params(params, dev)
        flat_c = flatten_params(tree_c)
        opt_c = make_optimizer("RMSProp", flat_c.values(), cfg_t.lr)
        gen_c = torch.Generator(device=dev)
        gen_c.manual_seed(engine.epoch_generator_seed(cfg_t.seed, 2))
        hi_matrix = torch.stack(his_dev[:CHUNK])
        if mode == "eager":
            step_c = engine.make_train_step(mcfg, opt_c, flat_c.values())
            losses_c = torch.stack([step_c(tree_c, train_dev, hi_b, gen_c)
                                    for hi_b in hi_matrix])
        else:
            epoch_fn = engine.make_epoch_fn(mcfg, opt_c, flat_c.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses_c = epoch_fn(tree_c, train_dev, hi_matrix, gen_c)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
        finals[mode] = (losses_c, flat_c,
                        [opt_c.state[p]["square_avg"] for p in flat_c.values()])
    (l_e, p_e, s_e), (l_c, p_c, s_c) = finals["eager"], finals["chunk"]
    differ = [k for k in p_e if not torch.equal(p_e[k], p_c[k])]
    if (not torch.equal(l_e, l_c) or differ
            or not all(torch.equal(a, b) for a, b in zip(s_e, s_c))):
        return _fail(f"a {CHUNK}-step chunk differs from the eager steps: losses "
                     f"{l_e.tolist()} and {l_c.tolist()}, parameters {differ[:5]}")
    print(f"[6 chunk path] a {CHUNK}-step chunk through make_epoch_fn (warm-up, capture "
          f"and first replay {capture_s:.3f} s) against the same steps through the "
          f"eager train step: {CHUNK} losses, {len(p_e)} parameters and their RMSProp "
          f"moments bitwise equal; last loss {l_c[-1].item():.6f}")

    # the same at param_dtype bfloat16: a 16-step chunk over bf16 parameters
    # (the leafwise RMSprop, f32 copies of the kernels' leaves inside the
    # captured steps) against the same steps taken eagerly, bitwise, each
    # moment of its dtype
    finals_b = {}
    for mode in ("eager", "chunk"):
        flat_b = {k: v.detach().to(dev).to(torch.bfloat16).requires_grad_(True)
                  for k, v in flatten_params(params).items()}
        tree_b = unflatten_params(flat_b)
        opt_b = make_optimizer("RMSProp", flat_b.values(), cfg_t.lr)
        gen_b = torch.Generator(device=dev)
        gen_b.manual_seed(engine.epoch_generator_seed(cfg_t.seed, 3))
        if mode == "eager":
            step_b = engine.make_train_step(mcfg, opt_b, flat_b.values())
            losses_b = torch.stack([step_b(tree_b, train_dev, hi_b, gen_b)
                                    for hi_b in hi_matrix])
        else:
            losses_b = engine.make_epoch_fn(mcfg, opt_b, flat_b.values())(
                tree_b, train_dev, hi_matrix, gen_b)
        finals_b[mode] = (losses_b, flat_b, [opt_b.state[p]["square_avg"]
                                             for p in flat_b.values()])
    (l_e, p_e, s_e), (l_c, p_c_b, s_c_b) = finals_b["eager"], finals_b["chunk"]
    differ = [k for k in p_e if not (p_c_b[k].dtype == torch.bfloat16
                                     and torch.equal(p_e[k], p_c_b[k]))]
    moment_dtypes = sorted({str(t.dtype) for t in s_c_b})
    if (not torch.equal(l_e, l_c) or differ
            or not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(s_e, s_c_b))
            or moment_dtypes != ["torch.bfloat16", "torch.float32"]):
        return _fail(f"a {CHUNK}-step chunk at param_dtype bfloat16 differs from the eager "
                     f"steps: losses {l_e.tolist()} and {l_c.tolist()}, parameters "
                     f"{differ[:5]}, moments {moment_dtypes}")
    print(f"[6 chunk path] the same at param_dtype bfloat16: {CHUNK} losses, {len(p_e)} bf16 "
          f"parameters and their RMSProp moments ({', '.join(moment_dtypes)}) bitwise equal; "
          f"last loss {l_c[-1].item():.6f}")

    # --- 7. bench path ---
    def bench_line(label, res):
        print(f"[7 bench path] {label}: " + json.dumps(res))

    def run_train_bench(label, reread=False, acts_f32=True, **kw):
        """bench.measure with the counters set to 0 just before and read just
        after, the spectral switches set for the run; returns (result, wrapper
        launches, launches by replays)."""
        saved = cuda_spectral.SAVE_ACTS_BWD, cuda_spectral.SAVE_ACTS_F32
        cuda_spectral.SAVE_ACTS_BWD, cuda_spectral.SAVE_ACTS_F32 = reread, acts_f32
        try:
            ops.reset_launches()
            res = bench.measure(**kw)
            counts = take_launches(ops, results)
        finally:
            cuda_spectral.SAVE_ACTS_BWD, cuda_spectral.SAVE_ACTS_F32 = saved
        bench_line(label, res)
        if not math.isfinite(res["loss"]) or res["repeats"] < 3:
            raise RuntimeError(f"bench {label}: loss {res['loss']}, repeats "
                               f"{res['repeats']}")
        return (res, *counts)

    torch.cuda.reset_peak_memory_stats()
    arms = []
    for reread in (False, True, True, False):
        label = "train, spectral reread" if reread else "train, spectral recompute"
        res, launches, replayed = run_train_bench(label, reread=reread)
        arms.append((reread, res))
        total = {k: launches[k] + replayed[k] for k in launches}
        steps_run = total["gru_bwd"]
        on, off = ("spectral_fwd_save", "spectral_bwd_reread"), ("spectral_fwd",
                                                                 "spectral_bwd")
        if not reread:
            on, off = off, on
        if (steps_run <= 0 or any(total[k] != 2 * steps_run for k in on)
                or any(total[k] for k in off)):
            return _fail(f"bench {label}: with SAVE_ACTS_BWD {reread} the launches "
                         f"are {launches} and {replayed}")
        print(f"[7 bench path] {label}: {steps_run} steps, wrapper launches "
              f"{launches}; launched by graph replays {replayed}")
    print(f"[7 bench path] peak device memory over the four train runs: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    rec_ms = [r["step_time_ms"] for reread, r in arms if not reread]
    rer_ms = [r["step_time_ms"] for reread, r in arms if reread]
    spread_ms = max(max(rec_ms) - min(rec_ms), max(rer_ms) - min(rer_ms))
    gain_ms = statistics.mean(rec_ms) - statistics.mean(rer_ms)
    print(f"[7 bench path] spectral A/B, median step ms: recompute {rec_ms}, reread "
          f"{rer_ms}; reread is {gain_ms:+.4f} ms a step faster (mean of two runs each); "
          f"the two runs of one arm differ by up to {spread_ms:.4f} ms: reread "
          f"{'beats' if gain_ms > spread_ms else 'does not beat'} recompute by more "
          f"than that")

    default_reread = cuda_spectral.SAVE_ACTS_BWD
    one_step, _, _ = run_train_bench(
        "train, one-step graph replayed per step", reread=default_reread,
        chunk_steps=1)
    print(f"[7 bench path] with the package's spectral backward "
          f"({'reread' if default_reread else 'recompute'}): a 64-step graph per "
          f"dispatch {(rer_ms if default_reread else rec_ms)[0]:.4f} ms a step, a "
          f"one-step graph replayed per step {one_step['step_time_ms']:.4f} ms, the "
          f"eager step of phase 5 {epoch_s / steps * 1e3:.4f} ms")

    # the same train step at compute_dtype bfloat16, with each spectral
    # backward: the bf16 arms launch, the f32 arms of the graph conv and the
    # spectral kernels do not
    bf_ms = {}
    for reread in (False, True):
        label = f"train bf16, spectral {'reread' if reread else 'recompute'}"
        res, launches, replayed = run_train_bench(label, reread=reread,
                                                  compute_dtype="bfloat16")
        bf_ms[reread] = res["step_time_ms"]
        total = {k: launches[k] + replayed[k] for k in launches}
        steps_run = total["gru_bwd"]
        pair = (("spectral_fwd_save_bf16", "spectral_bwd_reread_bf16") if reread
                else ("spectral_fwd_bf16", "spectral_bwd_bf16"))
        f32_arms = ("cheb_graph_conv_fwd", "spectral_fwd", "spectral_bwd",
                    "spectral_fwd_save", "spectral_bwd_reread")
        if (steps_run <= 0 or any(total[k] != 2 * steps_run for k in pair)
                or total["cheb_graph_conv_fwd_bf16"] != 2 * steps_run
                or any(total[k] for k in f32_arms)):
            return _fail(f"bench {label}: the launches are {launches} and {replayed}")
        print(f"[7 bench path] {label}: {steps_run} steps, wrapper launches {launches}; "
              f"launched by graph replays {replayed}")
    print(f"[7 bench path] train step, median ms: f32 reread {rer_ms}, recompute {rec_ms}; "
          f"bf16 reread {bf_ms[True]:.4f}, recompute {bf_ms[False]:.4f}")
    # the bf16 reread step with each storage of the saved arrays, in the order
    # f32, bf16, bf16, f32 (SAVE_ACTS_F32)
    store_ms = {True: [], False: []}
    arms16 = {True: ("spectral_fwd_save_bf16", "spectral_bwd_reread_bf16"),
              False: ("spectral_fwd_save_bf16acts", "spectral_bwd_reread_bf16acts")}
    for acts_f32 in (True, False, False, True):
        label = f"train bf16, spectral reread, {'f32' if acts_f32 else 'bf16'} saved arrays"
        res, launches, replayed = run_train_bench(label, reread=True, acts_f32=acts_f32,
                                                  compute_dtype="bfloat16")
        store_ms[acts_f32].append(res["step_time_ms"])
        total = {k: launches[k] + replayed[k] for k in launches}
        steps_run = total["gru_bwd"]
        if (steps_run <= 0 or any(total[k] != 2 * steps_run for k in arms16[acts_f32])
                or any(total[k] for k in arms16[not acts_f32])):
            return _fail(f"bench {label}: the launches are {launches} and {replayed}")
        print(f"[7 bench path] {label}: {steps_run} steps, wrapper launches {launches}; "
              f"launched by graph replays {replayed}")
    gain_ms = statistics.mean(store_ms[True]) - statistics.mean(store_ms[False])
    spread_ms = max(max(v) - min(v) for v in store_ms.values())
    print(f"[7 bench path] bf16 saved-array storage A/B, median step ms: f32 {store_ms[True]}, "
          f"bf16 {store_ms[False]}; bf16 storage is {gain_ms:+.4f} ms a step faster (mean of "
          f"two runs each); the two runs of one arm differ by up to {spread_ms:.4f} ms")

    ops.reset_launches()
    res_eval = bench.measure_eval()
    take_launches(ops, results)
    bench_line("eval, chunked program", res_eval)
    res_eager = bench.measure_eval(chunked=False)
    bench_line("eval, eager per-batch loop", res_eager)
    print(f"[7 bench path] eval {res_eval['windows_per_s']:.1f} windows/s chunked, "
          f"{res_eager['windows_per_s']:.1f} eager, ratio "
          f"{res_eval['windows_per_s'] / res_eager['windows_per_s']:.4f}")
    ops.reset_launches()
    res_eval_bf = bench.measure_eval(compute_dtype="bfloat16")
    launches, replayed = take_launches(ops, results)
    bench_line("eval bf16, chunked program", res_eval_bf)
    if not replayed["spectral_fwd_bf16"] or replayed["spectral_fwd"]:
        return _fail(f"bench eval bf16: the launches are {launches} and {replayed}")
    print(f"[7 bench path] eval, chunked program: f32 {res_eval['step_time_ms']:.4f} ms a "
          f"batch ({res_eval['windows_per_s']:.1f} windows/s), bf16 "
          f"{res_eval_bf['step_time_ms']:.4f} ms ({res_eval_bf['windows_per_s']:.1f} "
          f"windows/s)")

    # --- 8. asynchronous checkpoint ---
    async_dir = os.path.join(out_root, "async_ckpt")
    saver = ckpt.AsyncCheckpointer()
    try:
        saver.submit(async_dir, tree_c, opt_c.state_dict(), epoch=0,
                     meta={"epoch": 0})
        saver.wait()
    finally:
        saver.close()
    loaded, loaded_opt, meta = ckpt.load(async_dir, epoch=0, device=dev)
    loaded = flatten_params(loaded)
    differ = [k for k in p_c if not torch.equal(loaded[k], p_c[k].detach())]
    moments_ok = all(
        torch.equal(loaded_opt["state"][i]["square_avg"], sq.cpu())
        for i, sq in enumerate(s_c))
    if differ or not moments_ok or meta.get("epoch") != 0:
        return _fail(f"the asynchronous checkpoint differs from the live state: "
                     f"{differ[:5]}, moments equal {moments_ok}, meta {meta}")
    print(f"[8 async checkpoint] one submit, wait, load: {len(loaded)} parameters and "
          f"their RMSProp moments equal to the live ones")

    # the same for the bf16 parameters and mixed-dtype moments of phase 6's
    # chunk: each leaf of its dtype and bitwise, the moments loaded back into
    # a leafwise RMSprop with their dtypes kept
    saver = ckpt.AsyncCheckpointer()
    try:
        saver.submit(async_dir, tree_b, opt_b.state_dict(), epoch=1, meta={"epoch": 1})
        saver.wait()
    finally:
        saver.close()
    loaded_b, loaded_opt_b, _ = ckpt.load(async_dir, epoch=1, device=dev)
    loaded_b = flatten_params(loaded_b)
    opt_l = make_optimizer("RMSProp", [v.requires_grad_(True) for v in loaded_b.values()],
                           cfg_t.lr)
    opt_l.load_state_dict({"state": loaded_opt_b["state"],
                           "param_groups": opt_l.state_dict()["param_groups"]})
    differ = [k for k in p_c_b if not (loaded_b[k].dtype == torch.bfloat16
                                       and torch.equal(loaded_b[k], p_c_b[k].detach()))]
    moments_ok = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        [opt_l.state[p]["square_avg"] for p in loaded_b.values()], s_c_b))
    if differ or not moments_ok:
        return _fail(f"the bf16 checkpoint differs from the live state: {differ[:5]}, "
                     f"moments equal {moments_ok}")
    print(f"[8 async checkpoint] bf16 parameters: {len(loaded_b)} bf16 parameters and their "
          f"RMSProp moments (bf16 and f32) equal to the live ones, dtype for dtype")

    # --- 9. summary ---
    print(f"[9 summary] chip_smoke ran {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in results.values():
        if r["launches"] <= 0:
            return _fail(f"{r['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
