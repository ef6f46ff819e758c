#!/usr/bin/env python3
"""Drive stemgnn_tpu_torch's serving, training and bench paths on one NVIDIA
GPU and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. device: CUDA present; the card's name and power limit from nvidia-smi;
     TF32 off for every f32 comparison.
  2. build: nvcc of every kernel source in stemgnn_tpu_torch/csrc.
  3. kernels: each of the twenty-two kernels at the shapes its path gives it (the
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
     cuDNN. The attention forward and backward at B = 32, N = 140, 25, 141,
     512; B = 8, N = 1024; B = 1, N = 7,300 and 8,192 (the backward's chunked
     route), within 1e-5 of each output's largest entry, each twice,
     bitwise, one kernel a call each (torch.profiler; where three profiles
     in a row name nothing, the kernel nodes of a CUDA graph of the call,
     `kernels_of_graph`, held to the profiler's names at the flagship),
     timed beside the plain versions and their byte bounds. The spectral forwards (the output and the 12 saved arrays) and
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
     reread bitwise its recompute (up to D1 = 2048 the bf16 forwards run on
     tensor cores, mma.sync, and the bf16 backwards on Hopper's route, TMA
     bulk copies feeding mma.sync and wgmma, so every bf16 shape above holds
     those kernels; the profiler shows each bf16 saving forward on the chain
     kernel of its route, and both reread arms and the recompute on the
     backward's kernels of its route, `bf16_bwd_route`; where a profile
     lost some of a call's events and so fails a route check, the kernel
     nodes of a CUDA graph of the call decide, `route_kernels`). The redesigned bf16
     wrappers' times beside
     their parent design's (PARENT_DESIGN_MS), their bounds and the f32
     arms'; both bf16 forwards and the bf16 recompute backward on the chain
     kernel on tensor cores, and the bf16 graph conv one kernel a call
     (torch.profiler: no cast kernel before it) with tensor-core
     instructions and no FFMA in its SASS (cuobjdump). The bf16 graph conv
     also at synthetic-1k whole, COVID-19 and a ragged shape, and at every
     shape beside torch.mm on bf16 operands cast before the call and with
     its two casts in it, its bound the f32 bytes it reads and writes (the
     bf16-operand bound printed beside it). The bf16-storage arm of the
     saving pair (SAVE_ACTS_F32 off: `spectral_fwd_save_bf16acts`,
     `spectral_bwd_reread_bf16acts`) at the flagship beside the f32-storage
     arm's times, and at every spectral shape above: its 12 bf16 planes
     bitwise the f32-storage planes rounded to bf16, its output bitwise, two
     rereads bitwise, both held to the arm's plain versions by the bf16 rules;
     both storage arms timed at the COVID-19 shape and past D1 = 2048. The
     stretch path's kernels at its own shapes: the GRU cluster kernels at a
     segment's step count, no longer the hidden size (synthetic-100k-seggru:
     1024 steps of 100 rows at H = 64, on the GRU input and cotangent of one
     train step of the CPU plain path; synthetic-4k-seggru: 512 steps of 32
     rows at H = 128, seeded), within GRID_ATOL_REL of each array's largest
     entry, the backward twice bitwise, timed beside the bound and cuDNN; the
     spectral serving and saving forwards and the reread backward of both
     arms at 102,400 rows, D1 = 96, on seeded inputs, by the rules above,
     timed beside their bounds, and every spectral rule of `spectral_checks`
     at that shape. The row-block arms of the attention pair and the graph
     conv (both arms; the node-sharded dense path's) at the blocks a 'graph'
     axis gives them (`ROWS_SHAPES`: the flagship's B = 32, N = 140 on M = 70
     and 35 rows, the plain path's key, query and mul_L rows; synthetic-1k's
     B = 8, N = 1024 on M = 512 and 256, seeded), each within its atol of its
     largest entry of its plain version and timed beside its bound and the
     library call (torch.matmul, torch.mm with out_dtype f32); at M = N each
     arm on the square call's plan and bitwise the square wrappers' outputs
     (a check of routing only: both reach the same kernels with the same
     arguments, so it cannot show the parent's bits, which the ECG losses of
     phase 7 and `utils/kernel_variants.py against=` do).
     C.7: each arm's saving forward and reread backward on a row count that
     puts its chain past 65,535 row tiles (1,573,888 rows at D1 = 96 on 132
     SMs), against their plain versions, untimed.
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
     Then the stretch path (sparse latent graph, `ops/sparse.py`): two windows
     of synthetic-100k-seggru (102,400 nodes, multi 2, batch 1, sparse_k 64,
     a 64-unit GRU over segments of 1024 nodes) and two batches of the
     dense-GRU sparse variant (sparse_k 64 at N = 1024, batch 8: the grid GRU)
     through engine.inference_batched on seeded series, counters set to 0
     just before and read just after, the forecasts and the first batch's
     graph (the top-k index set; c, degree, inv_sqrt) against the CPU plain
     path. Then the JAX package's checkpoints (tests/torch_port_fixtures,
     written by its make_fixtures.py on a host with JAX: the JAX engine's
     output after one epoch on a seeded series of 16 nodes, window 12,
     multi 2, RMSProp at f32 and Adam at param_dtype bfloat16): engine.test on
     a copy of each, counters set to 0 just before and read just after, its
     test forecasts against the CPU plain path on the same parameters and
     against the JAX package's own forecasts stored beside it, each within
     1e-3 (normalized values); and the host time of checkpoint.load on a file
     of the JAX package's at the flagship's width (flax's bytes, written here
     by tests/torch_port_fixtures/flax_bytes.py), every leaf read back as
     written.
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
     three RMSProp steps against the CPU; and train windows/s. The stretch
     path: one train step of each of phase 4's two stretch models with its
     [N, k] mask, counters around it, loss and every gradient against the
     CPU plain path, twice bitwise, and the 100k step's peak allocated memory
     (at most 10 GB); one epoch of engine.train on ECG_data with --sparse_k
     16 --gru_hidden 32 --gru_segment 35, counters held to the expected
     launches. --resume from the JAX package's RMSProp checkpoint of phase 4:
     the parameters and moments the engine starts from bitwise the
     checkpoint's, then one more epoch on the card with its counters. One
     ECG epoch at --init_stream threefry, counters held to the expected
     launches, its initial parameters held leaf by leaf to the sha256 of the
     JAX package's draw (tests/torch_port_fixtures/threefry_ecg_seed0.json),
     and the draw's host time.
  6. chunk path: one 16-step chunk through engine.make_epoch_fn (a captured
     CUDA graph) against the same steps through the eager train step: losses,
     parameters and optimizer state bitwise equal; the same at param_dtype
     bfloat16 (bf16 parameters, f32 and bf16 moments), and for
     synthetic-100k-seggru (its [N, k] masks).
  7. bench path: bench.measure and bench.measure_eval at full width, their
     results as JSON lines; the train step with the spectral saving forward
     and reread backward (SAVE_ACTS_BWD on) against the recompute backward,
     in the order recompute, reread, reread, recompute; a one-step graph
     replayed per step beside the 64-step graph; the train step at
     compute_dtype bfloat16 with each spectral backward; the bf16 reread step
     with each storage of the saved arrays, in the order f32, bf16, bf16,
     f32; the eager eval loop beside the eval program, and the eval program
     at bfloat16; bench.measure and bench.measure_eval at
     synthetic-100k-seggru, f32 and bf16 (chunks of STRETCH_CHUNK steps,
     STRETCH_STEPS a timed window), counters around each.
  8. asynchronous checkpoint: one submit, wait, load, compare with the live
     parameters and optimizer state; the same for phase 6's bf16 parameters
     and mixed-dtype moments, dtype for dtype.
  9. distributed: a process group of this process alone over NCCL (a
     FileStore in a temporary directory) and a (1, 1) mesh. (a) The ECG
     flagship's step through parallel.train.make_sharded_train_step, f32 and
     bf16: its loss and every parameter after one RMSProp step bitwise the
     engine's unsharded step's (a sum over one rank changes no bit), with its
     counters. (b) synthetic-32k-sharded at full width (32,768 nodes, window
     12, horizon 3, multi 5, batch 2, sparse_k 64, a 64-unit GRU over segments
     of 1024, force_sparse_shard: the node-sharded dispatch of
     parallel/sparse_shard.py) against the same model unsharded on the card:
     two windows through engine.inference_batched (a captured eval program,
     its collectives in the graph), forecasts within 1e-3 and the graph's
     top-k index set exact, c, degree and inv_sqrt within 1e-5; one train
     step with its [N, k] mask, loss within 1e-5 and every gradient by phase
     5's f32 rule, the step twice bitwise, its counters (the GRU pair and the
     spectral pair, no attention, no graph conv) and its peak allocated
     memory. (c) bench.measure and bench.measure_eval at synthetic-32k-sharded
     and synthetic-32k-seggru (the unsharded dispatch), f32 and bf16, in the
     order unsharded, sharded, sharded, unsharded, counters around each.
     (d) Where torch.cuda.device_count() >= 2: two NCCL processes, one card
     each, run the flagship's data-parallel step on a (2, 1) mesh (held to
     one card's step by phase 5's rule) and synthetic-32k-sharded's step on a
     (1, 2) mesh (held to the CPU's f64 step by `noise_grads_agreement`),
     and synthetic-1k's dense step on a (1, 2) mesh without and with the
     ring (held to one card's step by phase 5's rule, the row-block arms'
     launches counted, each rank's ms a step beside one card's); with one
     card the line {"distributed_2card": "not run", "cards": 1}. (e) Where
     torch.cuda.device_count() >= 2: the launch across hosts, two torchrun
     groups on this host (--nnodes 2 --nproc_per_node 1, a card each by
     CUDA_VISIBLE_DEVICES, a working directory each with the dataset
     missing, Python's hash salted otherwise on each): the flagship's
     data-parallel step on (2, 1), held to (d)'s by phase 5's rule, both
     hosts' synthesized datasets equal, and one epoch of the CLI whose files
     only rank 0's directory holds; with one card the line
     {"multihost_2card": "not run", "cards": 1}.
 10. a `kernels` JSON line (launches summed over the paths: calls of the
     wrappers plus what replays of captured graphs launched; every kernel at
     least once, but for the row-block arms on a host of one card: they run
     only on the node-sharded dense path, which needs two ranks and so two
     cards), then the result line.

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
# the stretch path: the JAX package's synthetic-100k-seggru suite cell
# (benchmarks/suite.py:51; 102,400 nodes, multi 2, batch 1, a top-64 latent
# graph, a GRU of 64 hidden units over segments of 1024 nodes), its
# synthetic-4k-seggru GRU (hidden 128 over segments of 512 at batch 4), and
# the dense-GRU sparse variant (sparse_k 64 alone) at synthetic-1k's N and batch
S100K = "synthetic-100k-seggru"
S4K_GRU = dict(nodes=4096, batch=4, hidden=128, segment=512)
SPARSE_K = 64
# phase 7's synthetic-100k-seggru bench: steps a captured chunk, steps a timed window
STRETCH_CHUNK, STRETCH_STEPS = 16, 32


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
    five op wrappers of `stemgnn_tpu_torch.ops`, its arguments, its output and
    the cotangent that reaches the output."""

    NAMES = ("gru_over_nodes", "gru_over_nodes_segmented", "attention_kq", "cheb_graph_conv",
             "spe_seq_cell")

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


# A stretch train step's gradients, card against the CPU. At 102,400 nodes the
# top-k columns' A^T x sums over every node, so the spectral cell's input
# reaches |x| ~ 1e4 on those rows and the step's gradients are sums of terms
# far larger than their results: the CPU's own f32 step stands up to 4.6e-2
# of a gradient's largest entry from its f64 step (this script's phase 5, on
# the host of an NVIDIA H100 80GB HBM3). So each gradient of the card's step is held to
# the CPU's f64 step (the same inputs and mask) within the larger of
# GRAD_ATOL_REL of its largest entry and STEP_NOISE_FACTOR times the CPU f32
# step's own distance to it, and over all gradients within STEP_NOISE_L2
# times that distance in L2. Measured on the card: 7.8 times at worst (a bias
# gradient: the card adds 6,400 row tiles' partial sums in order, the CPU sums
# pairwise), 2.06 times in L2.
STEP_NOISE_FACTOR, STEP_NOISE_L2 = 10.0, 4.0


def noise_grads_agreement(grads, g32, g64):
    """(leaves out of tolerance, the worst max|K - P64| over max|P32 - P64| of
    a leaf and its name, the L2 ratio) of the card's gradients `grads` against
    the CPU's f64 step `g64`, with the CPU's f32 step `g32` as the scale (the
    rule above). `g32` may be a list of f32 steps held as right: the scale is
    then, leaf by leaf and in L2, the largest of their distances."""
    import torch

    refs = g32 if isinstance(g32, (list, tuple)) else [g32]
    bad, worst, worst_name, d_k, d_32 = [], 0.0, "", 0.0, [0.0] * len(refs)
    for name, a64 in g64.items():
        k = grads[name].detach().double().cpu()
        dists = [torch.dist(r[name].detach().double().cpu(), a64, math.inf).item()
                 for r in refs]
        err, noise = torch.dist(k, a64, math.inf).item(), max(dists)
        if err > max(GRAD_ATOL_REL * a64.abs().max().item(), STEP_NOISE_FACTOR * noise) + 1e-30:
            bad.append((name, err, noise))
        ratio = err / noise if noise > 0 else (math.inf if err else 0.0)
        if ratio > worst:
            worst, worst_name = ratio, name
        d_k += torch.dist(k, a64).item() ** 2
        for i, r in enumerate(refs):
            d_32[i] += torch.dist(r[name].detach().double().cpu(), a64).item() ** 2
    d_32 = max(d_32)
    l2 = math.sqrt(d_k / d_32) if d_32 > 0 else (math.inf if d_k else 0.0)
    if not l2 <= STEP_NOISE_L2:
        bad.append(("L2", l2, STEP_NOISE_L2))
    return bad, worst, worst_name, l2


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

    from stemgnn_tpu_torch.ops import cuda_attention, cuda_gru, torch_impl

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
    ] + spectral_bwd_cases(on_card(call["args"][0]), params["blocks"][0]["glu"],
                           on_card(call["g"]), call["args"][2])


def spectral_bwd_cases(gfted, glu, g_spe, multi: int):
    """The two f32 spectral backward kernels, as `backward_cases` gives the
    others, on the cell's input gfted [B, 4, N, W], its six GLU dicts and the
    cotangent g_spe of its output."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    glu = [{s: {leaf: t.detach() for leaf, t in p[s].items()} for s in p} for p in glu]
    b, k, n, w = gfted.shape
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

    b, w, n = x.shape
    k = 4
    gru = params["gru"]
    key, query, mul_L, feat, gfted = forward_inputs(params, mcfg, x)

    cudnn_gru = cudnn_gru_like(gru, x.device)
    xs = x.permute(2, 0, 1).contiguous()  # [N, B, W], cuDNN's sequence-major input
    xt = feat.permute(1, 0, 2).reshape(n, b * w).contiguous()  # [N, B*W]
    lk = mul_L[1:].contiguous()
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
         4 * ((k - 1) * n * n + b * n * w + b * k * n * w),  # order 0 of L unread
         2 * (k - 1) * n * n * b * w),
    ] + spectral_fwd_cases(gfted, params["blocks"][0]["glu"], mcfg.multi_layer)


def spectral_fwd_cases(gfted, glu, multi: int):
    """The two f32 spectral forward kernels, as `forward_cases` gives the
    others, on the cell's input gfted [B, 4, N, W] and its six GLU dicts."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = gfted.shape
    wm = w * multi
    d0, d1 = k * w, k * wm
    rows = b * n
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
        ("spectral_fwd", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:81",
         lambda: cuda_spectral.spe_seq_cell(gfted, glu, multi),
         lambda: cuda_spectral.spe_seq_cell_plain(gfted, glu, multi),
         None,
         # DFT as f32 products (kernel) against cuFFT (plain), as the CPU test
         # of the Pallas kernel holds them (tests/test_pallas_kernels.py:47)
         5e-4, 1e-4,
         4 * (rows * d0 + glu_w + rows * d1),
         spe_flops),
        ("spectral_fwd_save", "stemgnn_tpu_torch/csrc/spectral.cu",
         "stemgnn_tpu/ops/pallas_spectral.py:104",
         lambda: flat_save(cuda_spectral.spe_seq_cell_save(gfted, glu, multi)),
         lambda: flat_save(cuda_spectral.spe_seq_cell_save_plain(gfted, glu, multi)),
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
    `backward_cases`). The spectral arms' bytes count their operands as
    bf16; the graph conv's, the f32 operands it is handed (`graph_bf16_case`)."""
    dev = x.device
    _, _, mul_L, feat, gfted = forward_inputs(params, mcfg, x)

    call = rec.calls["spe_seq_cell"][0]
    return [graph_bf16_case("cheb_graph_conv_fwd_bf16", mul_L, feat)] + spectral_bf16_cases(
        gfted, params["blocks"][0]["glu"], mcfg.multi_layer,
        call["args"][0].detach().to(dev).contiguous(), call["g"].detach().to(dev).contiguous())


def mm_bf16_yardsticks(mul_L, feat):
    """The bf16 graph conv's library yardsticks on mul_L [K, M, N] and x [B,
    N, W]: ("with casts", torch.mm of the orders 1..K-1 and x as bf16
    operands with an f32 result, cast before the timed call; the same call
    with its two casts inside it (`kernel_variants.library_bf16`); the bytes
    of the bf16 operands it reads and its f32 result). None where this torch
    build has no torch.mm(..., out_dtype=float32) on bf16 operands."""
    from stemgnn_tpu_torch.utils import kernel_variants

    k, m, n = mul_L.shape
    b, _, w = feat.shape
    pre, cast = kernel_variants.library_bf16(mul_L, feat)
    try:
        pre()
    except (TypeError, RuntimeError) as exc:
        print(f"[3 kernel] cheb_graph_conv_fwd_bf16: this torch build has no "
              f"torch.mm(..., out_dtype=float32) on bf16 operands ({exc}): no library time")
        return None
    # order 0 of mul_L is never read: its slab of the output is zeros
    return ("with casts", lambda: [pre()], lambda: [cast()],
            2 * ((k - 1) * m * n + b * n * w) + 4 * b * k * m * w)


def graph_bf16_case(name, mul_L, feat, rows: bool = False):
    """The bf16 graph conv (the square call, or the row-block call on mul_L
    [K, M, N]) as `bf16_cases` lays a case out: its bytes the f32 operands
    the call reads (orders 1..K-1 of mul_L, and x) and its f32 output, as
    the function moves them (the bf16-operand bytes are printed beside
    them, `check_bf16_cases`)."""
    from stemgnn_tpu_torch.ops import cuda_graph

    k, m, n = mul_L.shape
    b, _, w = feat.shape
    fn = cuda_graph.cheb_graph_conv_rows if rows else cuda_graph.cheb_graph_conv
    return (name, "stemgnn_tpu_torch/csrc/graph.cu", "stemgnn_tpu/ops/pallas_graph.py:33",
            lambda: [fn(mul_L, feat, "bfloat16")],
            lambda: [cuda_graph.cheb_graph_conv_plain(mul_L, feat, "bfloat16")],
            lambda: [cuda_graph.cheb_graph_conv_plain(mul_L, feat)],
            mm_bf16_yardsticks(mul_L, feat),
            1e-4, 1e-5,  # the f32 arm's, scaled: no rounding after the products
            4 * ((k - 1) * m * n + b * n * w + b * k * m * w),
            2 * (k - 1) * m * n * b * w)


def spectral_bf16_cases(gfted, glu, multi: int, gfted_bwd, g_spe):
    """The six bf16 spectral arms, as `bf16_cases` gives the graph conv's: the
    forward arms on the cell's input gfted [B, 4, N, W], the backward arms on
    the input gfted_bwd and the output's cotangent g_spe of one train step;
    glu the six GLU dicts."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    b, k, n, w = gfted.shape
    wm = w * multi
    d0, d1 = k * w, k * wm
    rows = b * n
    bf = "bfloat16"
    glu_2d = sum(p[s]["w"].numel() for p in glu for s in ("left", "right"))
    glu_b = sum(p[s]["b"].numel() for p in glu for s in ("left", "right"))
    spe_flops = (2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm)
                 + 8 * k * w * w * d1)
    glu_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1)
    reread_flops = 2 * glu_flops + 2 * rows * 2 * k * wm * wm + 16 * k * w * w * d1
    glu_bwd = [{s: {leaf: t.detach() for leaf, t in p[s].items()} for s in p} for p in glu]
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

    from stemgnn_tpu_torch.ops import _build, cuda_gru, torch_impl

    b, w, n = x.shape
    h = n
    gru = params["gru"]
    card = _build.card_limits(x.device)
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


def segmented_gru_check(gru, x, g, seg: int, tag: str):
    """The GRU cluster kernels at a segmented GRU's shape (n != h): x [B, W, N]
    the model's input and g [B, N, H] the cotangent of the GRU's output,
    folded as `gru_over_nodes_segmented` folds them into S * B rows of `seg`
    steps. Both held against the plain recurrences with the atol scaled to
    the plain result's largest entry (GRID_ATOL_REL, GRID_RTOL), timed as
    graph replays beside the plain versions, the bound and cuDNN (printed
    only); the saving forward's output bitwise the serving one's and the
    backward twice, bitwise. Returns an error message, or None."""
    import torch

    from stemgnn_tpu_torch.ops import _build, cuda_gru, torch_impl

    x_fold = cuda_gru.fold_segments(x, seg).contiguous()  # [S*B, W, seg]
    g_fold = cuda_gru.fold_segments(g.transpose(1, 2), seg).transpose(1, 2).contiguous()
    rows, h = x_fold.shape[0], gru["w_hh"].shape[1]
    card = _build.card_limits(x.device)
    plan, bplan = cuda_gru.launch_plan(rows, h, *card), cuda_gru.bwd_plan(rows, h, *card)
    if (plan.route, bplan.route) != ("cluster", "cluster"):
        return f"{tag}: the GRU at {rows} rows, H={h} takes the {plan.route} route"
    with torch.no_grad():
        x_proj = torch_impl.gru_input_projection(gru, x_fold).contiguous()
        a_all = gru["w_hh"].T.contiguous()
        _, saved = torch_impl.gru_scan(x_proj, a_all, gru["b_hh"], save=True)
    cudnn_fwd, cudnn_fwd_bwd = cudnn_gru_calls(gru, x_fold, g_fold)
    fail = check_cases([
        ("gru_fwd", "", "", lambda: cuda_gru.gru_over_nodes(gru, x_fold),
         lambda: cuda_gru.gru_over_nodes_plain(gru, x_fold), cudnn_fwd, GRID_ATOL_REL,
         GRID_RTOL, *gru_fwd_work(gru, x_fold)),
        ("gru_bwd", "", "", lambda: cuda_gru.gru_scan_bwd(saved, g_fold, a_all),
         lambda: cuda_gru.gru_scan_bwd_plain(saved, g_fold, a_all),
         ("graph_or_stream", cudnn_fwd_bwd), GRID_ATOL_REL, GRID_RTOL,
         *gru_bwd_work(saved, g_fold, a_all))],
        {}, f"3 kernel, {tag}", scaled=True, calls=2, replays=3)
    if fail is not None:
        return fail
    with torch.no_grad():
        out_s, saved_s = cuda_gru._launch_fwd(x_proj, a_all, gru["b_hh"], True)
        out_f, _ = cuda_gru._launch_fwd(x_proj, a_all, gru["b_hh"], False)
        got = cuda_gru.gru_scan_bwd(saved, g_fold, a_all)
        again = cuda_gru.gru_scan_bwd(saved, g_fold, a_all)
        torch.cuda.synchronize()
    planes = max(((saved_s[:, q] - saved[:, q]).abs().max()
                  / saved[:, q].abs().max().clamp_min(1e-30)).item() for q in range(5))
    same_out, same_bwd = torch.equal(out_f, out_s), torch.equal(got, again)
    print(f"[3 kernel, {tag}] GRU at n = {seg} steps, {rows} rows (S * B), H = {h}: cluster "
          f"route, forward {plan.groups} clusters of {plan.cluster} blocks, backward "
          f"{bplan.groups} of {bplan.cluster}; the 5 saved planes within {planes:.3e} of "
          f"their largest entry (at most {GRID_ATOL_REL:g}); serving output bitwise the "
          f"saving one: {same_out}; two backwards {'bitwise equal' if same_bwd else 'DIFFER'}")
    if not (same_out and same_bwd) or not planes <= GRID_ATOL_REL:
        return (f"{tag}: saved planes {planes}, serving output bitwise {same_out}, "
                f"backward rerun bitwise {same_bwd}")
    return None


def stretch_spectral_check(glu, multi: int, n: int, dev, tag: str):
    """The spectral serving and saving forwards and the reread backward, both
    arms, at the stretch shape (batch 1, n rows) on seeded inputs (x from a
    standard normal, the cotangent 1e-3 of one), held against their plain
    versions by phase 3's rules and timed beside their bounds (printed only).
    Seeded: the train step's own cell input has rows of |x| in the thousands
    at n = 102,400 (the top-k columns' A^T x sums over every node), where
    f32 sums in two orders part by more than an absolute atol (PERF.md,
    section 7). Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    rng = np.random.default_rng(19)
    gfted = torch.from_numpy(rng.standard_normal((1, 4, n, WINDOW)).astype(np.float32)).to(dev)
    g_spe = torch.from_numpy((1e-3 * rng.standard_normal((1, 4, n, WINDOW * multi)))
                             .astype(np.float32)).to(dev)
    b, k, _, w = gfted.shape
    sms = cuda_spectral._sms(dev)
    fplan = cuda_spectral.fwd_mma_plan(b, k, n, w, w * multi, sms)
    bplan = cuda_spectral.bwd_tc_plan(b, k, n, w, w * multi, sms)
    print(f"[{tag}] {b * n} rows, D1 = {k * w * multi}: the bf16 chain forward on "
          f"{fplan.tiles} row tiles of {fplan.tile_rows} (grid (2, {fplan.tiles}): gridDim.y "
          f"takes up to 65,535), the bf16 backward's rows kernel on {bplan.clusters} clusters "
          f"of 2 blocks of up to {16 * bplan.m_tiles} rows, its weight gradients on "
          f"{bplan.wgrad_units} blocks in {bplan.nseg} row segments")
    keep = ("spectral_fwd", "spectral_fwd_save", "spectral_bwd_reread",
            "spectral_fwd_bf16", "spectral_fwd_save_bf16", "spectral_bwd_reread_bf16")
    return (check_cases(spectral_fwd_cases(gfted, glu, multi), {}, tag, calls=2, replays=3)
            or check_cases([c for c in spectral_bwd_cases(gfted, glu, g_spe, multi)
                            if c[0] in keep], {}, tag, scaled=True, calls=2, replays=3)
            or check_bf16_cases([c for c in spectral_bf16_cases(gfted, glu, multi, gfted, g_spe)
                                 if c[0] in keep], {}, tag, calls=2, replays=3))


def graph_agreement(g, g_cpu):
    """(the top-k index sets equal, the largest abs error of c, degree and
    inv_sqrt) of a sparse latent graph on the card against the CPU's."""
    same_idx = set(g.idx.tolist()) == set(g_cpu.idx.tolist())
    if not same_idx:
        return False, float("inf")
    # the same columns, in the order each side's top-k gave them
    order = [g.idx.tolist().index(j) for j in g_cpu.idx.tolist()]
    err = max((g.c[:, order].cpu() - g_cpu.c).abs().max().item(),
              (g.degree.cpu() - g_cpu.degree).abs().max().item(),
              (g.inv_sqrt.cpu() - g_cpu.inv_sqrt).abs().max().item())
    return True, err


def shape_checks(dev):
    """The GRU forward (cluster and grid routes, both variants), the GRU
    backward (both routes, and each twice: bitwise the same) and the graph
    convolution against their plain versions at other shapes than the
    flagship's, untimed, on seeded inputs. Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import _build, cuda_graph, cuda_gru, torch_impl

    rng = np.random.default_rng(3)
    limits = _build.card_limits(dev)

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


# The attention pair against its plain versions at other shapes than the
# flagship's model inputs: each output within ATT_ATOL_REL of its own largest
# entry of the plain version (the backward's row and column sums of up to N
# terms below 1 in another order), rtol 0. (B, N): the flagship, COVID-19
# (N = 25), N = 141 (no multiple of 4: 4-byte runs), 512 and 1024 (the
# widest row a warp holds), and 7,300 and 8,192 at B = 1 (the backward's
# chunked route; the earlier two-launch design refused N past 7,264).
ATT_ATOL_REL = 1e-5
ATT_SHAPES = ((32, 140), (32, 25), (32, 141), (32, 512), (8, 1024), (1, 7300), (1, 8192))
# the attention pair's device ms a call at the flagship in its earlier
# two-launch design (its C entries timed in turns with this design's by
# `kernel_variants attention against=` on an NVIDIA H100 80GB HBM3 at 700.00 W,
# PERF.md section 6), printed beside this run's
ATT_PARENT_MS = {"attention_kq_fwd": 0.00385, "attention_kq_bwd": 0.00774}


def attention_checks(dev):
    """Both attention kernels at ATT_SHAPES on seeded inputs: each against its
    plain version, each run twice (bitwise the same), the kernels one call
    launches (torch.profiler: the backward one kernel, no second pass; at
    the flagship `kernels_of_graph` too, held to the profiler's), and both
    timed beside the plain versions and their byte bounds. Returns an
    error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import _build, cuda_attention

    alpha = 0.2
    sms, smem = _build.card_limits(dev)
    for b, n in ATT_SHAPES:
        rng = np.random.default_rng(11 + n)
        key, query = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
                      for _ in range(2))
        g = torch.from_numpy((1e-3 * rng.standard_normal((b, n, n))).astype(np.float32)).to(dev)
        with torch.no_grad():
            got = [cuda_attention.attention_kq(key, query, alpha) for _ in range(2)]
            p = cuda_attention.attention_kq_plain(key, query, alpha)
            dgot = [cuda_attention.attention_kq_bwd(key, query, p, g, alpha) for _ in range(2)]
            dwant = cuda_attention.attention_kq_bwd_plain(key, query, p, g, alpha)
            torch.cuda.synchronize()
        bad, worst = [], 0.0
        for label, t, ref in (("output", got[0], p), ("dkey", dgot[0][0], dwant[0]),
                              ("dquery", dgot[0][1], dwant[1])):
            err, scale = (t - ref).abs().max().item(), ref.abs().max().item()
            worst = max(worst, err / scale if scale > 0 else err)
            if not torch.allclose(t, ref, atol=ATT_ATOL_REL * scale, rtol=0.0):
                bad.append(label)
        same = torch.equal(got[0], got[1]) and all(
            torch.equal(a, c) for a, c in zip(*dgot))
        calls = {"attention_kq_fwd": lambda: cuda_attention.attention_kq(key, query, alpha),
                 "attention_kq_bwd": lambda: cuda_attention.attention_kq_bwd(key, query, p, g,
                                                                            alpha)}
        plains = {"attention_kq_fwd": lambda: cuda_attention.attention_kq_plain(key, query,
                                                                               alpha),
                  "attention_kq_bwd": lambda: cuda_attention.attention_kq_bwd_plain(
                      key, query, p, g, alpha)}
        big = b * n * n > 3e7
        for name, fn in calls.items():
            with torch.no_grad():
                names = kernels_of_call(fn)
                ms = cuda_ms(fn, calls=2 if big else 20, replays=3 if big else 10)
                plain_ms = cuda_ms(plains[name], calls=2 if big else 20,
                                   replays=3 if big else 10)
            nbytes = 4 * (2 * b * n + b * n * n) if name.endswith("fwd") else (
                4 * (4 * b * n + 2 * b * n * n))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            parent = (f", the earlier design's {ATT_PARENT_MS[name]:.5f} ms (PERF.md)"
                      if (b, n) == (BATCH, 140) else "")
            print(f"[3 kernel] {name} B={b} N={n}: "
                  f"{'not measured' if names is None else len(names)} kernel(s) a call"
                  f"{'' if names is None else ' ' + str([nm.split('>(')[0] + '>' for nm in names])}; "
                  f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
                  f"(bytes, {nbytes:.4e} B){parent}")
            if names is not None and len(names) != 1:
                return f"{name} at B={b} N={n} launches {names}, expected one kernel"
            if names is None and (b, n) == (BATCH, 140):
                return f"the profiler could not name the kernels of {name} at the flagship"
            if (b, n) == (BATCH, 140):  # the fallback of kernels_of_call, held to the profiler
                fail = same_kernels(names, kernels_of_graph(fn), name)
                if fail is not None:
                    return fail
        print(f"[3 kernel] attention B={b} N={n} (plans {cuda_attention.fwd_plan(b, n, sms)}, "
              f"{cuda_attention.bwd_plan(b, n, sms, smem)}): the "
              f"output, dkey and dquery within {ATT_ATOL_REL:g} of their largest entry, rtol 0 "
              f"(worst {worst:.3e} of it): {'yes' if not bad else bad}; two runs of each "
              f"{'bitwise equal' if same else 'DIFFER'}")
        del g, p, got, dgot, dwant
        if bad or not same:
            return f"attention at B={b} N={n}: {bad} (bitwise reruns: {same})"
    return None


# The row-block arms of the attention pair and the graph conv (the node-sharded
# dense path, parallel/dense_shard.py) at the blocks a 'graph' axis gives them:
# (B, N, M) of the flagship on 2 and 4 ranks and of synthetic-1k on 2 and 4.
# The kernels line keeps synthetic-1k's on 2 ranks (the (1, 2) mesh of phase
# 9 (d)); the others are printed.
ROWS_SHAPES = ((BATCH, 140, 70), (BATCH, 140, 35), (S1K_BATCH, S1K_NODES, 512),
               (S1K_BATCH, S1K_NODES, 256))
ROWS_KEPT = (S1K_BATCH, S1K_NODES, 512)
ROW_ARMS = ("attention_kq_fwd_rows", "attention_kq_bwd_rows", "cheb_graph_conv_fwd_rows",
            "cheb_graph_conv_fwd_rows_bf16")


def rows_cases(key, query, p, g, mul_L, feat, alpha: float):
    """(f32 cases, bf16 cases) of the row-block arms on key [B, M], query
    [B, N], the forward's p and a cotangent g [B, M, N], mul_L [4, M, N] and
    x [B, N, W], as `forward_cases` and `bf16_cases` lay them out."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_attention, cuda_graph

    b, m = key.shape
    n, w, k = query.shape[1], feat.shape[2], mul_L.shape[0]
    lk = mul_L[1:].contiguous()
    xt = feat.permute(1, 0, 2).reshape(n, b * w).contiguous()
    src_a, src_g = "stemgnn_tpu_torch/csrc/attention.cu", "stemgnn_tpu_torch/csrc/graph.cu"
    f32 = [
        ("attention_kq_fwd_rows", src_a, "stemgnn_tpu/ops/pallas_attention.py:29",
         lambda: cuda_attention.attention_rows(key, query, alpha),
         lambda: cuda_attention.attention_rows_plain(key, query, alpha), None,
         ATT_ATOL_REL, 0.0, 4 * (b * m + b * n + b * m * n), 6 * b * m * n),
        ("attention_kq_bwd_rows", src_a, "stemgnn_tpu/ops/pallas_attention.py:65",
         lambda: torch.cat(cuda_attention.attention_rows_bwd(key, query, p, g, alpha), 1),
         lambda: torch.cat(cuda_attention.attention_rows_bwd_plain(key, query, p, g, alpha),
                           1),
         None, ATT_ATOL_REL, 1e-4, 4 * (2 * b * m + 2 * b * n + 2 * b * m * n),
         8 * b * m * n),
        ("cheb_graph_conv_fwd_rows", src_g, "stemgnn_tpu/ops/pallas_graph.py:33",
         lambda: cuda_graph.cheb_graph_conv_rows(mul_L, feat),
         lambda: cuda_graph.cheb_graph_conv_plain(mul_L, feat),
         lambda: torch.matmul(lk, xt),
         1e-5, 1e-5, 4 * ((k - 1) * m * n + b * n * w + b * k * m * w),
         2 * (k - 1) * m * n * b * w),
    ]
    return f32, [graph_bf16_case("cheb_graph_conv_fwd_rows_bf16", mul_L, feat, rows=True)]


def rows_checks(dev, results, params, mcfg, x):
    """The row-block arms at ROWS_SHAPES, each against its plain version and
    timed beside its bound (`check_cases`, scaled: each output within its
    atol of its largest entry), the flagship's on the plain path's key,
    query and mul_L of the batch x (the last node block's rows), synthetic-1k's
    on seeded ones; ROWS_KEPT's into `results`. Then the square calls' routes:
    at M = N each arm's plan is the square call's (`fwd_plan`, `bwd_plan`,
    `launch_plan`) and its outputs the square wrappers' bits, at the flagship.
    This checks routing only: both wrappers reach the same kernels with the
    same arguments once the plans match, so it says nothing of the parent
    tree's bits. Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import _build, cuda_attention, cuda_graph

    alpha = mcfg.leaky_rate
    sms, smem = _build.card_limits(dev)
    key_f, query_f, mul_L_f, feat_f, _ = forward_inputs(params, mcfg, x)
    for b, n, m in ROWS_SHAPES:
        rng = np.random.default_rng(20 + n + m)
        if n == key_f.shape[1]:
            blk = slice(n - m, n)
            key, query = key_f[:, blk].contiguous(), query_f
            mul_L, feat = mul_L_f[:, blk].contiguous(), feat_f
        else:
            key, query = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                          for s in ((b, m), (b, n)))
            mul_L = torch.from_numpy((rng.standard_normal((4, m, n)) / math.sqrt(n))
                                     .astype(np.float32)).to(dev)
            mul_L[0] = 0.0
            feat = torch.from_numpy(rng.standard_normal((b, n, WINDOW)).astype(np.float32)).to(
                dev)
        g = torch.from_numpy((1e-3 * rng.standard_normal((b, m, n))).astype(np.float32)).to(dev)
        with torch.no_grad():
            p = cuda_attention.attention_rows_plain(key, query, alpha)
        f32, bf16 = rows_cases(key, query, p, g, mul_L, feat, alpha)
        keep = results if (b, n, m) == ROWS_KEPT else {}
        tag = f"3 kernel, row block B={b} N={n} M={m}"
        fail = (check_cases(f32, keep, tag, scaled=True)
                or check_bf16_cases(bf16, keep, tag))
        if fail is not None:
            return fail
        print(f"[{tag}] plans: {cuda_attention.fwd_plan(b, n, sms, m=m)}, "
              f"{cuda_attention.bwd_plan(b, n, sms, smem, m=m)}, "
              f"{cuda_graph.launch_plan(4, n, b, WINDOW, m=m)}, "
              f"{cuda_graph.mma_plan(4, n, b, WINDOW, sms, m=m)}")
    # M = N: the square calls' plans and bits (routing, not the parent's bits)
    b, n = key_f.shape
    same_plans = (cuda_attention.fwd_plan(b, n, sms, m=n) == cuda_attention.fwd_plan(b, n, sms)
                  and cuda_attention.bwd_plan(b, n, sms, smem, m=n)
                  == cuda_attention.bwd_plan(b, n, sms, smem)
                  and cuda_graph.launch_plan(4, n, b, WINDOW, m=n)
                  == cuda_graph.launch_plan(4, n, b, WINDOW)
                  and cuda_graph.mma_plan(4, n, b, WINDOW, sms, m=n)
                  == cuda_graph.mma_plan(4, n, b, WINDOW, sms))
    g = torch.from_numpy((1e-3 * np.random.default_rng(24).standard_normal((b, n, n)))
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        p = cuda_attention.attention_kq(key_f, query_f, alpha)
        pairs = [(cuda_attention.attention_rows(key_f, query_f, alpha), p)]
        pairs += list(zip(cuda_attention.attention_rows_bwd(key_f, query_f, p, g, alpha),
                          cuda_attention.attention_kq_bwd(key_f, query_f, p, g, alpha)))
        pairs += [(cuda_graph.cheb_graph_conv_rows(mul_L_f, feat_f, cd),
                   cuda_graph.cheb_graph_conv(mul_L_f, feat_f, cd))
                  for cd in ("float32", "bfloat16")]
        torch.cuda.synchronize()
    same_bits = [torch.equal(a, c) for a, c in pairs]
    print(f"[3 kernel] row-block arms at M = N (B={b}, N={n}): the square calls' plans "
          f"{'yes' if same_plans else 'NO'}; outputs bitwise the square kernels' (attention, "
          f"dkey, dquery, graph conv f32, bf16): {same_bits}")
    if not same_plans or not all(same_bits):
        return f"the row-block arms at M = N leave the square route: plans {same_plans}, " \
               f"bits {same_bits}"
    return None


# The bf16 graph conv at the shapes the flagship's model inputs and the row
# blocks leave out: synthetic-1k whole (the square call one card makes at
# --compute_dtype bfloat16) and a ragged shape (N, B and W no multiples of 4),
# on seeded inputs, held and timed as `check_bf16_cases` holds the flagship's
# (printed only: the kernels line keeps the flagship's and ROWS_KEPT's).
GRAPH_BF16_SHAPES = {"synthetic-1k": (S1K_BATCH, S1K_NODES, WINDOW), "ragged": (7, 141, 13)}


def graph_bf16_checks(dev):
    """The bf16 graph conv at GRAPH_BF16_SHAPES. Returns an error message, or
    None."""
    import numpy as np
    import torch

    for tag, (b, n, w) in GRAPH_BF16_SHAPES.items():
        rng = np.random.default_rng(40 + n)
        mul_L = torch.from_numpy((rng.standard_normal((4, n, n)) / math.sqrt(n))
                                 .astype(np.float32)).to(dev)
        mul_L[0] = 0.0
        feat = torch.from_numpy(rng.standard_normal((b, n, w)).astype(np.float32)).to(dev)
        fail = check_bf16_cases([graph_bf16_case("cheb_graph_conv_fwd_bf16", mul_L, feat)], {},
                                f"3 kernel, bf16 graph conv {tag} B={b} N={n} W={w}")
        if fail is not None:
            return fail
    return None


# C.7: the spectral chain kernels past 65,535 row tiles, where a grid's y stops
# and where they were refused while they took a tile a blockIdx.y (now block x
# takes chain x % 2 of tile x / 2: csrc/spectral.cu launch_chains): the stretch
# cell's D1 = 96 (W = 12, multi 2) on a batch of rows that puts each arm's
# chain past that count on this card.
# Rows past 65,535 row tiles of each chain kernel, from: the f32 chain's
# largest tile is 24 rows (csrc/spectral.cu kFTiles), so 65,536 of them are
# past the ceiling whichever tile its plan takes. The bf16 chain's tile is its
# plan's (`fwd_mma_plan`, which its launch takes), 16 to 80 rows by the row
# count: `grid_ceiling_check` goes up from here to a count past it too.
CEILING_ROWS_FROM = 65_536 * 24
MAX_GRID_Y = 65_535  # blocks a grid may have along y, on every card


def grid_ceiling_check(glu, dev):
    """Each arm's saving forward and reread backward at the least row count
    from CEILING_ROWS_FROM up, in steps of 1,024, at which the bf16 chain's
    plan has more than 65,535 row tiles on this card (the f32 chain's has at
    any of them), against their plain versions by phase 3's rules (untimed).
    Returns an error message, or None."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.ops import cuda_spectral

    multi, k, w = 2, 4, WINDOW
    sms = cuda_spectral._sms(dev)
    rows = CEILING_ROWS_FROM
    while cuda_spectral.fwd_mma_plan(1, k, rows, w, w * multi, sms).tiles <= MAX_GRID_Y:
        rows += 1024
    f32_tiles = -(-rows // 24)  # at the least: 24 rows is the largest f32 tile
    bf16_tiles = cuda_spectral.fwd_mma_plan(1, k, rows, w, w * multi, sms).tiles
    rng = np.random.default_rng(25)
    gfted = torch.from_numpy(rng.standard_normal((1, k, rows, w)).astype(np.float32)).to(dev)
    g_spe = torch.from_numpy((1e-3 * rng.standard_normal((1, k, rows, w * multi)))
                             .astype(np.float32)).to(dev)
    tag = "3 kernel, C.7 grid ceiling"
    print(f"[{tag}] {rows} rows, D1 = {k * w * multi}: the f32 chain on {f32_tiles} row "
          f"tiles or more, the bf16 chain on {bf16_tiles}, past the {MAX_GRID_Y} blocks of "
          f"a grid's y (each a grid of 2 * tiles blocks along x)")
    keep = ("spectral_fwd_save", "spectral_bwd_reread", "spectral_fwd_save_bf16",
            "spectral_bwd_reread_bf16")
    return (check_cases([c for c in spectral_fwd_cases(gfted, glu, multi) if c[0] in keep],
                        {}, tag, timed=False)
            or check_cases([c for c in spectral_bwd_cases(gfted, glu, g_spe, multi)
                            if c[0] in keep], {}, tag, scaled=True, timed=False)
            or check_bf16_cases([c for c in spectral_bf16_cases(gfted, glu, multi, gfted, g_spe)
                                 if c[0] in keep], {}, tag, timed=False))


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
        fail = fail or bf16_bwd_route(
            lambda: cuda_spectral.spe_seq_cell_bwd_reread(x, glu, g, acts16, m, bf), d1,
            "bf16-storage reread")
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


def spectral_checks(dev, glu, multi: int, extra=()):
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
    timed (seed 0) beside its bound; then the shapes in `extra`, (B, N, W,
    multi, GLU weights, the generator of x and g, timed) each. f32: the
    serving forward's output, and
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
    cases += list(extra)
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
                    # and the backwards' kernels: Hopper's route up to D1 = 2048
                    for label, fn in (
                            ("reread", lambda: cuda_spectral.spe_seq_cell_bwd_reread(
                                x, glu_w, g, acts, m, cd)),
                            ("recompute", lambda: cuda_spectral.spe_seq_cell_bwd(
                                x, glu_w, g, m, cd))):
                        fail = fail or bf16_bwd_route(fn, d1, label)
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


def profile_steps(step, batches, step_ms: float, tag: str = "5 train path",
                  groups=()) -> None:
    """Print where the card's time goes in a train step: torch.profiler over
    `batches`, device time per step by kernel name, their sum, and that sum
    over `step_ms` (the unprofiled host-clock step) as the card's busy share;
    for each of `groups`, also the kernels whose name holds it, their count and
    time.
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
    for group in groups:
        held = {k: v for k, v in kernels.items() if group in k.lower()}
        print(f"[{tag}] the {len(held)} kernels whose name holds {group!r}: "
              f"{sum(held.values()) / n:.4f} ms per step")


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
                replays: int = 10, timed: bool = True):
    """Hold each case's kernel against its plain version and time both; fills
    `results`. Returns an error message, or None. With `scaled` a case's atol
    is a fraction of the plain result's largest entry: the cotangents of a
    real train step, and so the backward kernels' outputs, are far below 1.
    `calls` and `replays` size the timed graphs (fewer for a slow kernel);
    without `timed`, the check alone, printed."""
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
            del got, want
        if not timed:
            print(f"[{phase}] {name}: max_abs_err {err:.3e} (atol {atol:g}"
                  f"{f' of the largest entry {scale:.3e}' if scaled else ''}, rtol {rtol:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not math.isfinite(err):
                return f"{name} disagrees with its plain version: {err}"
            continue
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


def check_bf16_cases(cases, results, phase: str, calls: int = 20, replays: int = 10,
                     timed: bool = True):
    """`check_cases` for the bf16 arms (`bf16_cases`): each array of the
    kernel's result within the case's atol of its largest entry (and rtol) of
    the bf16 plain version's, and the kernel's results BF16_CLOSER times
    closer to the bf16 plain version than to the f32 one (`bf16_agreement`);
    the bound at the bf16 tensor-core rate, the f32 CUDA-core bound printed
    beside it. Fills `results`; returns an error message, or None."""
    import torch

    for (name, source, replaces, kern, plain, plain_f32, lib, atol, rtol, nbytes,
         flops) in cases:
        # ("with casts", pre-cast, with casts, bf16-operand bytes): the graph
        # conv's yardsticks
        cast = lib[2:] if isinstance(lib, tuple) and lib[0] == "with casts" else None
        lib = lib[1] if cast is not None else lib
        with torch.no_grad():
            got = kern()
            torch.cuda.synchronize()
            bad, err, ratio, rel = bf16_agreement(got, plain(), plain_f32(), atol, rtol)
        if not timed:
            del got
            ok = not bad and ratio >= BF16_CLOSER and math.isfinite(err)
            print(f"[{phase}] {name}: max_abs_err {err:.3e}, {rel:.3e} of its array's "
                  f"largest entry (each of its arrays within {atol:.4g} of its largest "
                  f"entry: {'yes' if not bad else f'NO, arrays {bad[:8]}'}; {ratio:.1f} times "
                  f"closer to the bf16 plain version than to the f32 one, at least "
                  f"{BF16_CLOSER:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                return f"{name} disagrees with its bf16 plain version: {err}, arrays {bad[:8]}"
            continue
        ms, plain_ms, lib_ms, one_call_ms = time_case(phase, name, kern, plain, lib, calls,
                                                      replays)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        f32_ms, f32_by = bound(nbytes, flops)
        if cast is not None:  # the graph conv: f32 operands in, f32 out
            with torch.no_grad():
                cast_ms = cuda_ms(cast[0], calls=calls, replays=replays)
            print(f"[{phase}] {name}: library with its two casts inside the call "
                  f"{cast_ms:.5f} ms (pre-cast {lib_ms:.5f}); kernel {ms:.5f} ms against "
                  f"the f32-byte bound {bound_ms:.5f} ({nbytes:.4e} B) and the bound at "
                  f"bf16-operand bytes {bound(cast[1], flops, BF16_FLOP_PER_S)[0]:.5f} "
                  f"({cast[1]:.4e} B)")
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


# The earlier design's device ms a wrapper call of the redesigned bf16 kernels
# (PERF.md section 6, this script's phase 3 on an NVIDIA H100 80GB HBM3 at
# 700.00 W): the bf16 backwards of both storage arms and the bf16-storage
# saving forward as the earlier mma.sync design ran them, the bf16 graph
# conv (square and the (1, 2) row block) as the scalar-FMA kernel ran it and
# the scalar bf16 spectral forwards. Printed beside this run's times and
# bounds.
PARENT_DESIGN_MS = {"spectral_bwd_reread_bf16": 0.23620, "spectral_bwd_bf16": 0.31018,
                    "spectral_bwd_reread_bf16acts": 0.23375,
                    "spectral_fwd_save_bf16acts": 0.11184,
                    "cheb_graph_conv_fwd_bf16": 0.00607,
                    "cheb_graph_conv_fwd_rows_bf16": 0.02224, "spectral_fwd_bf16": 0.21594,
                    "spectral_fwd_save_bf16": 0.24158}


def kernels_of_call(fn):
    """The names of the CUDA kernels one call of fn launches, by
    torch.profiler, or by `kernels_of_graph` where three profiles in a row
    fail or record no kernel at all (the tracer now and then hands back an
    empty list or raises); None where neither can say."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    why = "no kernel in 3 profiles"
    for _ in range(3):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and not ev.is_user_annotation]
        except RuntimeError as exc:
            why, names = f"the profiler failed: {exc}", []
        if names:
            return names
    names = kernels_of_graph(fn)
    print(f"[3 kernel] kernels of a call: the profiler could not say ({why}); "
          f"{'not measured' if names is None else 'named by a CUDA graph of the call'}")
    return names


def route_kernels(fn, holds):
    """The kernels of one call of fn by `kernels_of_call`; where they fail
    `holds` (a check of a list of names), the kernel nodes of a CUDA graph of
    the call instead, provided the profile named no kernel the graph lacks.
    The profiler now and then loses events: one run named four of the six
    kernels of a bf16 backward past D1 = 2048, dropping the first two; a
    graph's nodes are every launch of the call. None where neither can say."""
    from collections import Counter

    names = kernels_of_call(fn)
    if names is not None and holds(names):
        return names
    graph_names = kernels_of_graph(fn)
    if graph_names is None:
        return names

    def ids(found):  # the name and template arguments, without the parameter list
        return Counter(nm.replace("(anonymous namespace)::", "").split("(")[0].replace(" ", "")
                       for nm in found)

    if names is not None and not ids(names) <= ids(graph_names):
        print(f"[3 kernel] the profiler named {names}, which a CUDA graph of the call "
              f"({graph_names}) does not hold; the profile decides")
        return names
    print(f"[3 kernel] the profiler named {names}; a CUDA graph of the call names "
          f"{graph_names}, which decide")
    return graph_names


def same_kernels(names, graph_names, label: str):
    """An error message unless `kernels_of_graph` names the kernels the
    profiler named for one call (`names`), template arguments included; None,
    and a line printed, where it does."""
    def ids(found):
        return [nm.split(">(")[0].replace(" ", "") for nm in found]

    if graph_names is None or ids(graph_names) != ids(names):
        return (f"{label}: the kernels of a CUDA graph of a call {graph_names} are not those "
                f"the profiler named {names}")
    print(f"[3 kernel] {label}: a CUDA graph of a call names the profiler's kernels "
          f"{ids(graph_names)}")
    return None


def kernels_of_graph(fn):
    """The names of the CUDA kernels one call of fn launches, read from the
    kernel nodes of a CUDA graph that captures the call: libcuda's
    cuGraphKernelNodeGetParams_v2 and cuFuncGetName (cuKernelGetName where
    the node holds a library kernel), demangled by libstdc++'s
    __cxa_demangle. None where any step fails. Unlike the profiler it needs
    no tracer, so it gives the same answer every time."""
    import ctypes

    import torch

    vp = ctypes.c_void_p
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        cxx = ctypes.CDLL("libstdc++.so.6")
        cxx.__cxa_demangle.restype = vp
        cxx.__cxa_demangle.argtypes = [ctypes.c_char_p, vp, vp, ctypes.POINTER(ctypes.c_int)]
        libc = ctypes.CDLL(None)
        libc.free.argtypes = [vp]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        raw = vp(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
            return None
        nodes = (vp * count.value)()
        if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
            return None
        names = []
        for node in nodes[: count.value]:
            kind = ctypes.c_int(-1)
            if cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)) != 0:
                return None
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 unsigned ints and padding,
            # kernelParams, extra, kern, ctx
            params = (vp * 9)()
            if cu.cuGraphKernelNodeGetParams_v2(vp(node), params) != 0:
                return None
            name = ctypes.c_char_p()
            rc = (cu.cuFuncGetName(ctypes.byref(name), vp(params[0])) if params[0]
                  else cu.cuKernelGetName(ctypes.byref(name), vp(params[7])))
            if rc != 0 or not name.value:
                return None
            status = ctypes.c_int(-1)
            out = cxx.__cxa_demangle(name.value, None, None, ctypes.byref(status))
            if status.value == 0 and out:
                names.append(ctypes.string_at(out).decode())
                libc.free(out)
            else:
                names.append(name.value.decode())
        graph.reset()
        return names or None
    except (AttributeError, OSError, RuntimeError) as exc:
        print(f"[3 kernel] kernels of a CUDA graph of a call: not measured ({exc})")
        return None


def bf16_chain_route(fn, d1: int):
    """An error message unless one call of fn (a bf16 spectral entry that runs
    the chain forward) launches the chain kernel of its route, by
    torch.profiler: `spectral_chain_mma_kernel` up to D1 = 2048, the wide
    scalar `spectral_chain_wide_kernel` past it, and never the scalar
    `spectral_chain_kernel`, by `route_kernels`; also an error where neither
    the profiler nor a CUDA graph can name the kernels. None, and a line
    printed, where it does."""
    from stemgnn_tpu_torch.ops import cuda_spectral

    want = ("spectral_chain_mma_kernel" if d1 <= cuda_spectral.MMA_MAX_D1
            else "spectral_chain_wide_kernel")

    def chain_of(names):
        return [nm.split(">(")[0] + ">" for nm in names if "spectral_chain" in nm]

    def holds(names):
        chain = chain_of(names)
        return (any(want in nm for nm in chain)
                and not any("spectral_chain_kernel" in nm for nm in chain))

    names = route_kernels(fn, holds)
    if names is None:
        return f"the kernels of a bf16 chain call at D1 = {d1} could not be named"
    chain = chain_of(names)
    if not holds(names):
        return f"a bf16 chain call at D1 = {d1} launches {chain}, expected {want} alone"
    print(f"[3 kernel] bf16 chain at D1 = {d1}: launches {chain}")
    return None


# The bf16 backward's kernels on Hopper's route, up to D1 = 2048
# (csrc/spectral.cu `bwd_tc_launch`), and the scalar ones it replaced there.
BF16_BWD_KERNELS = ("spectral_pack_kernel", "spectral_bwd_rows_tc_kernel",
                    "spectral_wgrad_wg_kernel")
SCALAR_BWD_KERNELS = ("spectral_bwd_rows_kernel", "spectral_wgrad_kernel",
                      "spectral_reduce_kernel", "spectral_bias_kernel", "spectral_dx_kernel")


def bf16_bwd_route(fn, d1: int, label: str):
    """An error message unless one call of fn (a bf16 spectral backward: a
    reread of either storage arm, or the recompute) launches the kernels of
    its route, by `route_kernels`: up to D1 = 2048 the three of
    `BF16_BWD_KERNELS` and none of the scalar backward's, past it the wide
    scalar rows kernel and none of the three; also an error where neither
    the profiler nor a CUDA graph can name the kernels. None, and a line
    printed, where it does."""
    import re

    from stemgnn_tpu_torch.ops import cuda_spectral

    def ids(names):
        return [m.group(1) for nm in names or [] for m in [re.search(r"(spectral_\w+?)[<(]", nm)]
                if m]

    def holds(found):
        names = ids(found)
        if d1 <= cuda_spectral.MMA_MAX_D1:
            return (all(k in names for k in BF16_BWD_KERNELS)
                    and not any(k in names for k in SCALAR_BWD_KERNELS))
        return ("spectral_bwd_rows_wide_kernel" in names
                and not any(k in names for k in BF16_BWD_KERNELS))

    found = route_kernels(fn, holds)
    names = ids(found)
    if not names:
        return f"the kernels of the bf16 {label} backward at D1 = {d1} could not be named"
    if not holds(found):
        return f"the bf16 {label} backward at D1 = {d1} launches {names}"
    print(f"[3 kernel] bf16 {label} backward at D1 = {d1}: launches {names}")
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
        f32 = results.get(name.replace("_bf16acts", "").replace("_bf16", ""), {}).get("ms")
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
        names = route_kernels(
            lambda: cuda_graph.cheb_graph_conv(mul_L, feat, "bfloat16"),
            lambda found: len(found) == 1 and "cheb_graph_conv_mma_kernel" in found[0])
    if names is None:
        return "the kernels of a cheb_graph_conv_fwd_bf16 call could not be named"
    print(f"[3 kernel] cheb_graph_conv_fwd_bf16: {len(names)} kernel(s) a call: {names}")
    if len(names) != 1 or "cheb_graph_conv_mma_kernel" not in names[0]:
        return f"cheb_graph_conv_fwd_bf16 launches {names}, expected its one kernel"
    return graph_tensor_cores()


def graph_tensor_cores():
    """The SASS of the built graph library (cuobjdump, beside the nvcc that
    built it): the bf16 graph conv's kernel holds tensor-core instructions
    (HMMA or HGMMA) and no FFMA, so no scalar loop makes its output. Returns
    an error message (also where cuobjdump is missing or fails), or None."""
    from stemgnn_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(os.path.realpath(_build._nvcc())), "cuobjdump")
    if not os.path.exists(tool):
        return f"no cuobjdump beside nvcc ({tool}): the graph conv's SASS cannot be read"
    lib = _build.build_all()[0] / "libgraph.so"
    run = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
    if run.returncode != 0:
        return f"cuobjdump -sass {lib} exited {run.returncode}: {run.stderr[-2000:]}"
    sass = run.stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif name is not None:
            for op in counts[name]:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
    mma = {k: v for k, v in counts.items() if "cheb_graph_conv_mma_kernel" in k}
    print(f"[3 kernel] cheb_graph_conv_mma_kernel SASS (cuobjdump): {list(mma.values())}")
    if not mma or not all(v["HMMA"] + v["HGMMA"] > 0 and v["FFMA"] == 0 for v in mma.values()):
        return f"the bf16 graph conv's kernels are not on the tensor cores: {mma}"
    return None


# the distributed phase: the JAX suite's node-sharded cell (benchmarks/suite.py:57,
# its 9th field force_sparse_shard True) and the same model unsharded
S32K_SHARDED, S32K = "synthetic-32k-sharded", "synthetic-32k-seggru"
DENSE_ONLY = ("attention_kq_fwd", "attention_kq_bwd", "cheb_graph_conv_fwd",
              "cheb_graph_conv_fwd_bf16") + ROW_ARMS


def sharded_32k(dev):
    """(the synthetic-32k-sharded model config with force_sparse_shard, its
    unsharded twin, init_params(0), a seeded series of two windows as a
    WindowDataset, the first batch's [N, k] dropout mask)."""
    import dataclasses

    import numpy as np
    import torch

    from stemgnn_tpu_torch import bench
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.data import WindowDataset, compute_norm_stats
    from stemgnn_tpu_torch.models import init_params

    kw = bench.config_kwargs(S32K_SHARDED)
    mcfg = StemGNNConfig(units=kw["n_nodes"], window_size=kw["window"], horizon=kw["horizon"],
                         multi_layer=kw["multi"], sparse_k=kw["sparse_k"],
                         gru_hidden=kw["gru_hidden"], gru_segment=kw["gru_segment"],
                         force_sparse_shard=kw["force_sparse_shard"])
    series = np.random.default_rng(15).standard_normal(
        (kw["window"] + kw["horizon"] + kw["batch"] - 1, kw["n_nodes"]))
    data_set = WindowDataset(series, kw["window"], kw["horizon"], "z_score",
                             compute_norm_stats(series, "z_score"))
    mask = torch.from_numpy(np.random.default_rng(16).random((mcfg.units, mcfg.sparse_k))
                            < 1.0 - mcfg.dropout_rate)
    return (mcfg, dataclasses.replace(mcfg, force_sparse_shard=False),
            init_params(0, mcfg, device=dev), data_set, mask)


def step_on(mcfg, params, data, hi, mask, mesh=None, compute_dtype="float32",
            shard_batch=True, use_ring=False):
    """One train step of fresh copies of `params` through the engine's step (on
    `mesh` through parallel.train.make_sharded_train_step): (loss, {name:
    gradient}, {name: parameter after the step})."""
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.parallel.train import make_sharded_train_step
    from stemgnn_tpu_torch.train import engine
    from stemgnn_tpu_torch.train.optim import make_optimizer

    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_params(params).items()}
    opt = make_optimizer("RMSProp", flat.values(), 1e-4)
    if mesh is None:
        step = engine.make_train_step(mcfg, opt, flat.values(), compute_dtype=compute_dtype)
    else:
        step = make_sharded_train_step(mcfg, opt, flat.values(), mesh,
                                       compute_dtype=compute_dtype, shard_batch=shard_batch,
                                       use_ring=use_ring)
    loss = step(unflatten_params(flat), data, hi, dropout_mask=mask)
    return (loss, {k: v.grad.detach().clone() for k, v in flat.items()},
            {k: v.detach().clone() for k, v in flat.items()})


def s1k_dense(dev):
    """(synthetic-1k's dense model config, init_params(0), a seeded series
    [64, N] on the card, window ends [8], a [8, N, N] dropout mask): the
    dense partition's cell of phase 9 (d)."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import init_params

    mcfg = StemGNNConfig(units=S1K_NODES, window_size=WINDOW, horizon=HORIZON,
                         multi_layer=MULTI)
    rng = np.random.default_rng(26)
    data = torch.from_numpy(rng.standard_normal((64, S1K_NODES)).astype(np.float32)).to(dev)
    hi = torch.from_numpy(rng.integers(WINDOW, 64 - HORIZON, size=S1K_BATCH)).to(dev)
    mask = torch.from_numpy(rng.random((S1K_BATCH, S1K_NODES, S1K_NODES))
                            < 1.0 - mcfg.dropout_rate).to(dev)
    return mcfg, init_params(0, mcfg, device=dev), data, hi, mask


def step_ms(mcfg, params, data, hi, mask, mesh=None, use_ring=False, steps: int = 5) -> float:
    """Device-clock ms of one eager train step of `params` (copies) through the
    engine's step (on `mesh` the sharded one), after two warm steps: CUDA
    events around `steps` steps, synchronized."""
    import torch

    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.parallel.train import make_sharded_train_step
    from stemgnn_tpu_torch.train import engine
    from stemgnn_tpu_torch.train.optim import make_optimizer

    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_params(params).items()}
    opt = make_optimizer("RMSProp", flat.values(), 1e-4)
    step = (engine.make_train_step(mcfg, opt, flat.values()) if mesh is None else
            make_sharded_train_step(mcfg, opt, flat.values(), mesh, use_ring=use_ring))
    tree = unflatten_params(flat)
    for _ in range(2):
        step(tree, data, hi, dropout_mask=mask)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step(tree, data, hi, dropout_mask=mask)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def two_card_rank(flagship, stretch):
    """A rank of phase 9's two-card group (NCCL, card = rank): the flagship's
    data-parallel step on a (2, 1) mesh, synthetic-32k-sharded's step on a
    (1, 2) mesh, each (loss, {name: gradient as a numpy array}); then
    synthetic-1k's dense step on a (1, 2) mesh without and with the ring,
    each (loss, gradients, ms a step, the row-block arms' launches in one
    step). `flagship`: (its TrainConfig fields, train split, window ends,
    [B, N, N] mask); `stretch`: the first batch's window ends and [N, k]
    mask."""
    import torch

    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    cfg_kw, data, hi, mask = flagship
    mcfg = TrainConfig(**cfg_kw).model_config(data.shape[1])
    mesh = make_mesh(2, 1)
    loss, grads, _ = step_on(mcfg, init_params(0, mcfg, device=dev), torch.from_numpy(data).to(dev),
                             torch.from_numpy(hi).to(dev), torch.from_numpy(mask).to(dev), mesh)
    out.append((loss.item(), {k: g.cpu().numpy() for k, g in grads.items()}))
    mcfg_s, _, params_s, set_s, _ = sharded_32k(dev)
    hi_s, mask_s = stretch
    loss, grads, _ = step_on(mcfg_s, params_s, torch.from_numpy(set_s.data).to(dev),
                             torch.from_numpy(hi_s).to(dev), torch.from_numpy(mask_s).to(dev),
                             make_mesh(1, 2))
    out.append((loss.item(), {k: g.cpu().numpy() for k, g in grads.items()}))
    del params_s, grads
    from stemgnn_tpu_torch import ops

    mcfg_1k, params_1k, data_1k, hi_1k, mask_1k = s1k_dense(dev)
    mesh = make_mesh(1, 2)
    for ring in (False, True):
        ops.reset_launches()
        loss, grads, _ = step_on(mcfg_1k, params_1k, data_1k, hi_1k, mask_1k, mesh,
                                 use_ring=ring)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launches().items() if k in ROW_ARMS}
        ms = step_ms(mcfg_1k, params_1k, data_1k, hi_1k, mask_1k, mesh, use_ring=ring)
        out.append((loss.item(), {k: g.cpu().numpy() for k, g in grads.items()}, ms, counts))
    return out


# the JAX package's bytes (tests/torch_port_fixtures/make_fixtures.py wrote
# them on a host with JAX): two output directories it trained on a seeded
# series, and the sha256 of its threefry init's leaves at the ECG flagship
FIXTURES = os.path.join(HERE, "tests", "torch_port_fixtures")


def fixture_series():
    """(fixtures.json, the train, valid and test splits of its seeded series)."""
    from stemgnn_tpu_torch.data import split_by_ratio, synthesize

    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        fx = json.load(f)
    s = fx["series"]
    return fx, split_by_ratio(synthesize(s["name"], T=s["T"], N=s["N"], seed=s["seed"]),
                              7, 2, 1)


def fixture_config(fx, case: str, **kw):
    from stemgnn_tpu_torch.config import TrainConfig

    return TrainConfig(dataset=fx["series"]["name"], device="cuda",
                       **dict(fx["config"], **fx["cases"][case], **kw))


def epoch_launches(kernels, n_train: int, n_valid: int, batch: int, step_kernels: dict,
                   fwd_per_batch: dict):
    """(wrapper calls, launches by graph replays) expected of one epoch of
    engine.train on n_train windows with a validate pass on n_valid, as phase
    5 counts them: full batches in captured chunks (greedy over CHUNK_SIZES,
    after WARM_STEPS eager steps before the first capture), the rest eager;
    the validate pass as engine.test's."""
    from stemgnn_tpu_torch.train import engine

    steps, full = -(-n_train // batch), n_train // batch
    chunked, left = 0, full
    for size in engine.CHUNK_SIZES:
        chunked += left // size * size
        left %= size
    eager = (engine.WARM_STEPS if chunked else 0) + steps - chunked
    want, want_replayed = eval_launches(kernels, n_valid, batch, fwd_per_batch)
    for name, n in step_kernels.items():
        want[name] += n * eager
        want_replayed[name] += n * chunked
    return want, want_replayed


def eval_launches(kernels, n: int, batch: int, fwd_per_batch: dict):
    """(wrapper calls, launches by graph replays) expected of engine.test or a
    validate pass over n windows, as phase 4 counts them: the full batches one
    replay of a captured graph after one warm batch, the short last batch an
    eager call."""
    batches, full = -(-n // batch), n // batch
    want = dict.fromkeys(kernels, 0)
    want_replayed = dict(want)
    for name, k in fwd_per_batch.items():
        want[name] = k * (1 + batches - full)
        want_replayed[name] = k * full
    return want, want_replayed


class EpochSpy:
    """Within the block, engine._train_epochs records the parameters and the
    optimizer state engine.train hands it (what a run starts its first epoch
    from) and its start epoch, then runs."""

    def __init__(self, engine):
        self.engine, self.original = engine, engine._train_epochs

    def __enter__(self):
        def spy(cfg, mcfg, flat, opt, *rest):
            self.flat = {k: v.detach().cpu().clone() for k, v in flat.items()}
            self.state = {i: {k: v.detach().cpu().clone() for k, v in opt.state[p].items()}
                          for i, p in enumerate(flat.values()) if p in opt.state}
            self.start = rest[7]
            return self.original(cfg, mcfg, flat, opt, *rest)

        self.engine._train_epochs = spy
        return self

    def __exit__(self, *exc):
        self.engine._train_epochs = self.original


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape with the same bytes."""
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().cpu().reshape(-1).view(torch.uint8),
        b.detach().cpu().reshape(-1).view(torch.uint8))


def jax_serving_phase(dev, results, out_root, fwd_per_batch):
    """Phase 4's serving from the JAX package's checkpoints: engine.test on a
    copy of each fixture directory, counters around it; the test forecasts
    against the CPU plain path on the same parameters and against the JAX
    package's own, both within 1e-3 (phase 4's rule, normalized values). Then
    the host time to read a checkpoint of the JAX package's at the ECG
    flagship's width. 0, or the code of `_fail`."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch import ops
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.data import WindowDataset
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.train import checkpoint as ckpt
    from stemgnn_tpu_torch.train import engine
    from tests.torch_port_fixtures import flax_bytes

    fx, (_, _, test_data) = fixture_series()
    for case in fx["cases"]:
        cfg = fixture_config(fx, case, train=False, output_dir=out_root)
        train_dir = os.path.join(out_root, "jax_fixture", case, "train")
        test_dir = os.path.join(out_root, "jax_fixture", case, "test")
        shutil.copytree(os.path.join(FIXTURES, case, "train"), train_dir)
        test_set = WindowDataset(test_data, cfg.window_size, cfg.horizon, cfg.norm_method,
                                 ckpt.load_norm_stat(train_dir))
        n_batches = len(test_set.epoch_batches(cfg.batch_size, shuffle=False))
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = engine.test(test_data, cfg, train_dir, test_dir)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, replayed = take_launches(ops, results)
        want, want_replayed = eval_launches(ops.KERNELS, len(test_set), cfg.batch_size,
                                            fwd_per_batch)
        params, _, meta = ckpt.load(train_dir, device=dev)
        params_cpu = ckpt.load(train_dir, device="cpu")[0]
        dtypes = sorted({str(v.dtype) for v in flatten_params(params).values()})
        mcfg = cfg.model_config(test_data.shape[1])
        fc, _ = engine.inference_batched(engine.make_eval_step(mcfg, dev), params, test_set,
                                         cfg.batch_size, dev)
        fc_cpu, _ = engine.inference_batched(engine.make_eval_step(mcfg, "cpu"), params_cpu,
                                             test_set, cfg.batch_size, "cpu")
        fc_jax = np.load(os.path.join(FIXTURES, case, "forecasts.npy"))
        ok_shape = fc.shape == fc_cpu.shape == fc_jax.shape and np.isfinite(fc).all()
        err_cpu = float(abs(fc - fc_cpu).max()) if ok_shape else math.inf
        err_jax = float(abs(fc - fc_jax).max()) if ok_shape else math.inf
        print(f"[4 serving path] the JAX package's {case} checkpoint (parameters {dtypes}, "
              f"meta {meta}): engine.test over {len(test_set)} windows in {n_batches} batches, "
              f"{secs:.3f} s; wrapper launches {launches}; launched by graph replays "
              f"{replayed}; test MAE {float(metrics['mae']):.6f}; forecasts {fc.shape}, card "
              f"vs CPU plain path max_abs_err {err_cpu:.3e}, card vs the JAX package's "
              f"forecasts {err_jax:.3e} (atol 1e-3, normalized values)")
        if launches != want or replayed != want_replayed:
            return _fail(f"{case}: launch counts {launches} and {replayed}, expected {want} "
                         f"and {want_replayed}")
        if not ok_shape or err_cpu > 1e-3 or err_jax > 1e-3:
            return _fail(f"{case}: forecasts {fc.shape} differ from the CPU plain path by "
                         f"{err_cpu} and from the JAX package's by {err_jax}")
        want_dtype = "torch.bfloat16" if cfg.param_dtype == "bfloat16" else "torch.float32"
        if dtypes != [want_dtype] or not all(math.isfinite(float(metrics[k]))
                                             for k in ("mae", "mape", "rmse")):
            return _fail(f"{case}: parameters {dtypes}, metrics {metrics}")

    # a checkpoint of the JAX package's at the flagship's width (its bytes as
    # flax writes them: tests/test_torch_port_fixtures.py), read on this host
    mcfg = TrainConfig(window_size=WINDOW, horizon=HORIZON, multi_layer=MULTI).model_config(140)
    params = {k: v.numpy() for k, v in flatten_params(init_params(0, mcfg, "cpu")).items()}
    tree = unflatten_params(params)
    rng = np.random.default_rng(5)
    nu = unflatten_params({k: np.abs(rng.standard_normal(v.shape)).astype(np.float32)
                                  for k, v in params.items()})
    meta = {"epoch": 0, "best_validate_mae": 1.0, "non_decrease_count": 0, "rng_seed": 0}
    blob = flax_bytes.checkpoint_bytes(flax_bytes.jax_layout(tree),
                                       flax_bytes.rmsprop_state(nu, 109, 1e-4), meta)
    flag_dir = os.path.join(out_root, "jax_flagship")
    os.makedirs(flag_dir)
    with open(os.path.join(flag_dir, "0_stemgnn.ckpt"), "wb") as f:
        f.write(blob)
    walls = {}
    for where in ("cpu", dev):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, opt_state, got_meta = ckpt.load(flag_dir, epoch=0, device=where)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[str(where)] = statistics.median(times)
    flat = flatten_params(got)
    flat_nu = flatten_params(nu)
    ok = got_meta == meta and list(flat) == list(params) and all(
        np.array_equal(flat[k].cpu().numpy(), params[k])
        and np.array_equal(opt_state["state"][i]["square_avg"].numpy(), flat_nu[k])
        for i, k in enumerate(params))
    ckpt.save(os.path.join(flag_dir, "port"), got, opt_state, epoch=0, meta=meta)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ckpt.load(os.path.join(flag_dir, "port"), epoch=0, device="cpu")
        times.append(time.perf_counter() - t0)
    n_params = sum(v.size for v in params.values())
    print(f"[4 serving path] a JAX package's checkpoint at the flagship's width ({n_params} "
          f"parameters and their RMSProp moments, {len(blob)} bytes): checkpoint.load "
          f"median of 5 {walls['cpu'] * 1e3:.2f} ms to host tensors, "
          f"{walls[str(dev)] * 1e3:.2f} ms onto the card; the port's own format of the "
          f"same state {statistics.median(times) * 1e3:.2f} ms to host tensors; every "
          f"leaf as written: {ok}")
    if not ok:
        return _fail("the flagship-width JAX checkpoint did not read back as written")
    return 0


def jax_train_phase(dev, results, out_root, step_kernels, fwd_per_batch, sets, train_data,
                    valid_data, cfg_t):
    """Phase 5's --resume from the JAX package's RMSProp checkpoint and its
    threefry init (module docstring). 0, or the code of `_fail`."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from stemgnn_tpu_torch import ops
    from stemgnn_tpu_torch.data import WindowDataset, compute_norm_stats
    from stemgnn_tpu_torch.models.convert import flatten_params
    from stemgnn_tpu_torch.models.initializers import init_params_threefry
    from stemgnn_tpu_torch.train import checkpoint as ckpt
    from stemgnn_tpu_torch.train import engine

    # --resume from the JAX engine's directory after its epoch 0; its epoch
    # checkpoint is byte for byte its best one (make_fixtures.py checks it),
    # which alone is committed
    fx, (f_train, f_valid, _) = fixture_series()
    run_dir = os.path.join(out_root, "jax_fixture", "resume")
    shutil.copytree(os.path.join(FIXTURES, "rmsprop_f32", "train"), run_dir)
    shutil.copyfile(os.path.join(run_dir, "_stemgnn.ckpt"), os.path.join(run_dir, "0_stemgnn.ckpt"))
    want_p, want_o, _ = ckpt.load(run_dir, epoch=0, device="cpu")
    cfg = fixture_config(fx, "rmsprop_f32", epoch=2, resume=True, output_dir=out_root)
    stats = compute_norm_stats(f_train, cfg.norm_method)
    n_train, n_valid = (len(WindowDataset(d, cfg.window_size, cfg.horizon, cfg.norm_method,
                                          stats)) for d in (f_train, f_valid))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with EpochSpy(engine) as spy:
        engine.train(f_train, f_valid, cfg, run_dir)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    want, want_replayed = epoch_launches(ops.KERNELS, n_train, n_valid, cfg.batch_size,
                                         step_kernels, fwd_per_batch)
    flat_want = flatten_params(want_p)
    count = want_o["state"][0]["step"].item()
    params_ok = list(spy.flat) == list(flat_want) and all(
        same_bits(spy.flat[k], v) for k, v in flat_want.items())
    moments_ok = len(spy.state) == len(flat_want) and all(
        same_bits(spy.state[i]["square_avg"], want_o["state"][i]["square_avg"])
        and spy.state[i]["step"].item() == count for i in range(len(flat_want)))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        epochs = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    print(f"[5 train path] --resume from the JAX package's RMSProp checkpoint (epoch 0, "
          f"step {count:g}): start epoch {spy.start}; restored parameters bitwise the "
          f"checkpoint's: {params_ok}; moments and steps: {moments_ok}; one more epoch on the "
          f"card, {secs:.3f} s with its captures, loss "
          f"{epochs[-1]['loss'] if epochs else float('nan'):.6f}; wrapper launches {launches}; "
          f"launched by graph replays {replayed}")
    if spy.start != 1 or not params_ok or not moments_ok:
        return _fail(f"--resume from the JAX checkpoint: start {spy.start}, parameters "
                     f"{params_ok}, moments {moments_ok}")
    if launches != want or replayed != want_replayed:
        return _fail(f"resumed epoch launch counts {launches} and {replayed}, expected {want} "
                     f"and {want_replayed}")
    if len(epochs) != 1 or not math.isfinite(epochs[0]["loss"]) or not os.path.exists(
            os.path.join(run_dir, "1_stemgnn.ckpt")):
        return _fail(f"resumed epoch: events {epochs}, 1_stemgnn.ckpt written "
                     f"{os.path.exists(os.path.join(run_dir, '1_stemgnn.ckpt'))}")

    # --init_stream threefry: one ECG epoch at full width; the draw computed on
    # this host held to the JAX package's by each leaf's sha256
    with open(os.path.join(FIXTURES, "threefry_ecg_seed0.json")) as f:
        tf = json.load(f)
    mcfg = cfg_t.model_config(train_data.shape[1])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        init_params_threefry(0, mcfg, device="cpu")
        times.append(time.perf_counter() - t0)
    run_dir = os.path.join(out_root, cfg_t.dataset, "train_run_threefry")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with EpochSpy(engine) as spy:
        valid_metrics, _ = engine.train(train_data, valid_data,
                                        dataclasses.replace(cfg_t, init_stream="threefry"),
                                        run_dir)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    want, want_replayed = epoch_launches(ops.KERNELS, len(sets["train"]), len(sets["valid"]),
                                         cfg_t.batch_size, step_kernels, fwd_per_batch)
    bad = [k for k, v in spy.flat.items()
           if k not in tf["leaves"] or list(v.shape) != tf["leaves"][k]["shape"]
           or hashlib.sha256(v.numpy().tobytes()).hexdigest() != tf["leaves"][k]["sha256"]]
    bad += sorted(set(tf["leaves"]) - set(spy.flat))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        epochs = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    print(f"[5 train path] --init_stream threefry: the draw on this host (numpy) "
          f"{statistics.median(times) * 1e3:.1f} ms (median of 3); {len(spy.flat) - len(bad)} "
          f"of {len(tf['leaves'])} leaves bitwise the JAX package's (sha256); one ECG epoch, "
          f"{secs:.3f} s with its captures, loss "
          f"{epochs[0]['loss'] if epochs else float('nan'):.6f}, validate MAE "
          f"{float(valid_metrics['mae']):.6f}; wrapper launches {launches}; launched by "
          f"graph replays {replayed}")
    if bad:
        return _fail(f"threefry leaves not the JAX package's draw: {bad[:5]}")
    if launches != want or replayed != want_replayed:
        return _fail(f"threefry epoch launch counts {launches} and {replayed}, expected "
                     f"{want} and {want_replayed}")
    if len(epochs) != 1 or not math.isfinite(epochs[0]["loss"]):
        return _fail(f"threefry epoch events {epochs}")
    return 0


def distributed_phase(dev, results, cfg, train_data, his, masks, bench_line, run_train_bench):
    """Phase 9 (module docstring): 0, or the code of `_fail`."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch import bench, ops
    from stemgnn_tpu_torch.models import init_params, stemgnn
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.ops import cuda_spectral
    from stemgnn_tpu_torch.parallel.mesh import make_mesh, world_of_one
    from stemgnn_tpu_torch.parallel.train import make_sharded_train_step
    from stemgnn_tpu_torch.train.optim import make_optimizer
    from stemgnn_tpu_torch.train import engine

    reread = cuda_spectral.SAVE_ACTS_BWD
    # the spectral pair a train step launches, by compute_dtype
    pairs = {"float32": ("spectral_fwd_save", "spectral_bwd_reread") if reread
             else ("spectral_fwd", "spectral_bwd"),
             "bfloat16": ("spectral_fwd_save_bf16", "spectral_bwd_reread_bf16") if reread
             else ("spectral_fwd_bf16", "spectral_bwd_bf16")}
    with world_of_one(dev):
        mesh = make_mesh(1, 1)
        print(f"[9 distributed] a process group of one rank over NCCL "
              f"({torch.distributed.get_backend()}), world {torch.distributed.get_world_size()}"
              f", a (1, 1) mesh")
        # (a) the flagship's data-parallel step on the (1, 1) mesh against the
        # engine's unsharded step, f32 and bf16: the loss and every parameter
        # after one RMSProp step bitwise (the sums over one rank change no bit)
        mcfg = cfg.model_config(train_data.shape[1])
        params = init_params(cfg.seed, mcfg, device=dev)
        data = torch.from_numpy(train_data).to(dev)
        hi, mask = his[0].to(dev), masks[0].to(dev)
        for cd in ("float32", "bfloat16"):
            loss_u, _, after_u = step_on(mcfg, params, data, hi, mask, compute_dtype=cd)
            ops.reset_launches()
            loss_m, _, after_m = step_on(mcfg, params, data, hi, mask, mesh, compute_dtype=cd)
            torch.cuda.synchronize()
            launches, replayed = take_launches(ops, results)
            differ = [k for k in after_u if not torch.equal(after_u[k], after_m[k])]
            print(f"[9 distributed] (a) ECG flagship, compute_dtype {cd}: "
                  f"parallel.train.make_sharded_train_step on the (1, 1) mesh against the "
                  f"engine's step: loss {loss_m.item():.9f} against {loss_u.item():.9f}, "
                  f"{'bitwise' if torch.equal(loss_m, loss_u) else 'DIFFERS'}; "
                  f"{len(after_u) - len(differ)} of {len(after_u)} parameters after the step "
                  f"bitwise; wrapper launches {launches}")
            want = dict.fromkeys(ops.KERNELS, 0)
            conv = "cheb_graph_conv_fwd" + ("_bf16" if cd == "bfloat16" else "")
            want.update({"gru_fwd": 1, "gru_bwd": 1, "attention_kq_fwd": 1,
                         "attention_kq_bwd": 1, conv: 2, pairs[cd][0]: 2, pairs[cd][1]: 2})
            if differ or not torch.equal(loss_m, loss_u) or launches != want:
                return _fail(f"(a) {cd}: the sharded step differs from the unsharded one: "
                             f"loss {loss_m.item()} against {loss_u.item()}, {differ[:5]}")
        del params, data

        # (b) synthetic-32k-sharded at full width against the same model
        # unsharded on the card: two windows through engine.inference_batched
        # and one train step with its [N, k] mask, twice bitwise
        mcfg_s, mcfg_u, params_s, set_s, mask_s = sharded_32k(dev)
        data_s = torch.from_numpy(set_s.data).to(dev)
        hi_s = torch.from_numpy(set_s.epoch_batches(len(set_s), shuffle=False)[0]).long()
        mask_s = mask_s.to(dev)
        fc = {}
        for tag, m_cfg, m in (("unsharded", mcfg_u, None), ("sharded", mcfg_s, mesh)):
            ops.reset_launches()
            t0 = time.perf_counter()
            fc[tag], _ = engine.inference_batched(
                engine.make_eval_step(m_cfg, dev, mesh=m), params_s, set_s, len(set_s), dev,
                engine.make_eval_epoch_fn(m_cfg, dev, mesh=m))
            serve_s = time.perf_counter() - t0
            launches, replayed = take_launches(ops, results)
            total = {k: launches[k] + replayed[k] for k in launches}
            print(f"[9 distributed] (b) {S32K_SHARDED if m else S32K}, {len(set_s)} windows "
                  f"through engine.inference_batched ({tag}), {serve_s:.3f} s with its "
                  f"capture; wrapper launches (the warm-up before the capture) {launches}; "
                  f"launched by graph replays {replayed}")
            # one batch: the replay's GRU forward and 2 spectral forwards
            if (replayed["gru_fwd"] != 1 or replayed["spectral_fwd"] != 2
                    or any(total[k] for k in DENSE_ONLY)):
                return _fail(f"(b) {tag} serving launches {launches} and {replayed}")
        shape = (len(set_s), mcfg_s.horizon, mcfg_s.units)
        err = float(np.abs(fc["sharded"] - fc["unsharded"]).max())
        x0, _ = engine.gather_windows(data_s, hi_s.to(dev), mcfg_s.window_size,
                                      mcfg_s.horizon)
        with torch.inference_mode():
            _, g_sh = stemgnn.forward(params_s, mcfg_s, x0, mesh=mesh)
            _, g_un = stemgnn.forward(params_s, mcfg_u, x0)
        same_idx, g_err = graph_agreement(g_sh, type(g_un)(*(t.cpu() for t in g_un)))
        print(f"[9 distributed] (b) forecasts {fc['sharded'].shape}, sharded against "
              f"unsharded: max_abs_err {err:.3e} (atol 1e-3), "
              f"{'bitwise' if np.array_equal(fc['sharded'], fc['unsharded']) else 'not bitwise'}"
              f"; the graph: top-{mcfg_s.sparse_k} index sets "
              f"{'equal' if same_idx else 'DIFFER'}, c, degree and inv_sqrt max_abs_err "
              f"{g_err:.3e} (atol 1e-5)")
        if (fc["sharded"].shape != shape or not np.isfinite(fc["sharded"]).all() or err > 1e-3
                or not same_idx or not g_err <= 1e-5):
            return _fail(f"(b) sharded serving: shape {fc['sharded'].shape}, err {err}, "
                         f"index sets equal {same_idx}, graph {g_err}")
        loss_u, grads_u, _ = step_on(mcfg_u, params_s, data_s, hi_s.to(dev), mask_s)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        loss_m, grads_m, _ = step_on(mcfg_s, params_s, data_s, hi_s.to(dev), mask_s, mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches, replayed = take_launches(ops, results)
        loss_m2, grads_m2, _ = step_on(mcfg_s, params_s, data_s, hi_s.to(dev), mask_s, mesh)
        rerun = [k for k in grads_m if not torch.equal(grads_m[k], grads_m2[k])]
        bad, worst, worst_name = compare_grads(grads_m, {k: g.cpu() for k, g in grads_u.items()})
        bitwise = (torch.equal(loss_m, loss_u)
                   and all(torch.equal(grads_m[k], grads_u[k]) for k in grads_u))
        loss_err = abs(loss_m.item() - loss_u.item())
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update({"gru_fwd": 1, "gru_bwd": 1, pairs["float32"][0]: 2,
                     pairs["float32"][1]: 2})
        print(f"[9 distributed] (b) {S32K_SHARDED}, one train step on the (1, 1) mesh: "
              f"wrapper launches {launches}; loss {loss_m.item():.6f} (abs err {loss_err:.3e} "
              f"against the unsharded step's, atol 1e-5); {len(grads_m)} gradients, worst "
              f"max_abs_err {worst:.3e} at {worst_name} (atol {GRAD_ATOL_REL:g} of each "
              f"gradient's largest entry, rtol {GRAD_RTOL:g}); against the unsharded step "
              f"{'bitwise' if bitwise else 'not bitwise'}; the same step twice "
              f"{'bitwise equal' if not rerun and torch.equal(loss_m, loss_m2) else 'DIFFERS'}"
              f"; peak allocated {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
              f"the {base / 2**30:.3f} GiB held before the step)")
        if (launches != want or any(replayed.values()) or loss_err > 1e-5 or bad or rerun
                or not torch.equal(loss_m, loss_m2)):
            return _fail(f"(b) sharded train step: launches {launches} (expected {want}), "
                         f"loss err {loss_err}, leaves {bad[:5]}, rerun {rerun[:5]}")
        del grads_u, grads_m, grads_m2
        # where the time of the step goes, unsharded and sharded: the engine's
        # eager step (on the (1, 1) mesh for the sharded one), 3 warm steps, 5
        # on the host clock, 5 under torch.profiler (NCCL's kernels and copies
        # among the rest)
        for tag, m_cfg, m in ((S32K, mcfg_u, None), (S32K_SHARDED, mcfg_s, mesh)):
            flat_p = {k: v.detach().clone().requires_grad_(True)
                      for k, v in flatten_params(params_s).items()}
            opt_p = make_optimizer("RMSProp", flat_p.values(), 1e-4)
            step_p = (engine.make_train_step(m_cfg, opt_p, flat_p.values()) if m is None
                      else make_sharded_train_step(m_cfg, opt_p, flat_p.values(), m))
            tree_p, hi_d = unflatten_params(flat_p), hi_s.to(dev)
            for _ in range(3):
                step_p(tree_p, data_s, hi_d, dropout_mask=mask_s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step_p(tree_p, data_s, hi_d, dropout_mask=mask_s)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / 5 * 1e3
            print(f"[9 distributed] (b) {tag}: the eager train step {step_ms:.3f} ms of host "
                  f"clock (5 steps after 3 warm)")
            profile_steps(lambda hi_b: step_p(tree_p, data_s, hi_b, dropout_mask=mask_s),
                          [hi_d] * 5, step_ms, f"9 distributed, {tag}",
                          groups=("nccl", "memcpy"))
        del flat_p, tree_p, step_p, data_s

        # (c) the bench at synthetic-32k-sharded and at synthetic-32k-seggru
        # (the same model, unsharded dispatch), f32 and bf16, train and eval,
        # in the order unsharded, sharded, sharded, unsharded, counters around
        # each: the gap is the sharded dispatch's own cost on one card
        stretch_bench = dict(steps=STRETCH_STEPS, warmup=STRETCH_CHUNK,
                             chunk_steps=STRETCH_CHUNK)
        times = {}
        for cd in ("float32", "bfloat16"):
            for name in (S32K, S32K_SHARDED, S32K_SHARDED, S32K):
                kw = dict(bench.config_kwargs(name), compute_dtype=cd, **stretch_bench)
                label = f"{name} train, {cd}"
                res, launches, replayed = run_train_bench(label, reread=reread, **kw)
                total = {k: launches[k] + replayed[k] for k in launches}
                steps_run = total["gru_bwd"]
                if (steps_run <= 0 or total["gru_fwd"] != steps_run
                        or any(total[k] != 2 * steps_run for k in pairs[cd])
                        or any(total[k] for k in DENSE_ONLY)):
                    return _fail(f"bench {label}: the launches are {launches} and {replayed}")
                ops.reset_launches()
                res_e = bench.measure_eval(**kw)
                launches, replayed = take_launches(ops, results)
                bench_line(f"{name} eval, {cd}", res_e)
                fwd = "spectral_fwd" + ("_bf16" if cd == "bfloat16" else "")
                if (not replayed["gru_fwd"] or replayed[fwd] != 2 * replayed["gru_fwd"]
                        or any(launches[k] + replayed[k] for k in DENSE_ONLY)):
                    return _fail(f"bench {name} eval {cd}: the launches are {launches} and "
                                 f"{replayed}")
                times.setdefault((name, cd), []).append(
                    (res["step_time_ms"], res_e["step_time_ms"]))
        for cd in ("float32", "bfloat16"):
            (tu1, eu1), (tu2, eu2) = times[S32K, cd]
            (ts1, es1), (ts2, es2) = times[S32K_SHARDED, cd]
            print(f"[9 distributed] (c) {cd}, median ms in the order unsharded, sharded, "
                  f"sharded, unsharded: train {tu1:.4f}, {ts1:.4f}, {ts2:.4f}, {tu2:.4f}; "
                  f"eval {eu1:.4f}, {es1:.4f}, {es2:.4f}, {eu2:.4f}; the sharded dispatch "
                  f"costs {(ts1 + ts2 - tu1 - tu2) / 2:+.4f} ms a train step and "
                  f"{(es1 + es2 - eu1 - eu2) / 2:+.4f} ms an eval batch (the unsharded runs "
                  f"differ by {abs(tu1 - tu2):.4f} and {abs(eu1 - eu2):.4f})")

    return two_card_checks(dev, cfg, train_data, his, masks, results)


def two_card_checks(dev, cfg, train_data, his, masks, results=None):
    """Phase 9 (d): where the host has two cards or more, the flagship's
    data-parallel step on a (2, 1) mesh, synthetic-32k-sharded's step on a
    (1, 2) mesh and synthetic-1k's dense step on a (1, 2) mesh, without and
    with the ring, in two NCCL processes. The flagship and synthetic-1k are
    held to one card's step by the f32 rule of phase 5, and synthetic-1k's
    ms a step on each rank printed beside one card's; the row-block arms'
    launches in its steps go to `results`. The 32k step's gradients upstream of the top-k
    (the GRU, weight_query) are f32 noise as large as the gradients, and the
    CPU's f32 step, phase 5's scale, stands farther from the f64 step than one
    card's step on one host and far closer on another (its BLAS sums in
    another order). So the two-card step is held to the CPU's f64 step by
    `noise_grads_agreement` with two f32 steps as the scale, the CPU's and one
    card's. 0, or the code of `_fail`."""
    import numpy as np
    import torch

    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.models.convert import flatten_params
    from stemgnn_tpu_torch.parallel.dryrun import run_ranks
    from stemgnn_tpu_torch.train import engine

    cards = torch.cuda.device_count()
    if cards < 2:
        print(json.dumps({"distributed_2card": "not run", "cards": cards}))
        print(json.dumps({"multihost_2card": "not run", "cards": cards}))
        return 0
    _, mcfg_u, params_s, set_s, mask_s = sharded_32k(dev)
    hi_s = torch.from_numpy(set_s.epoch_batches(len(set_s), shuffle=False)[0]).long()
    flag = (dict(batch_size=cfg.batch_size, window_size=cfg.window_size,
                 horizon=cfg.horizon, multi_layer=cfg.multi_layer),
            train_data, his[0].numpy(), masks[0].numpy())
    mcfg = cfg.model_config(train_data.shape[1])
    loss_f, grads_f, _ = step_on(mcfg, init_params(cfg.seed, mcfg, device=dev),
                                 torch.from_numpy(train_data).to(dev), his[0].to(dev),
                                 masks[0].to(dev))
    _, grads_1, _ = step_on(mcfg_u, params_s, torch.from_numpy(set_s.data).to(dev),
                            hi_s.to(dev), mask_s.to(dev))
    x_c, y_c = engine.gather_windows(torch.from_numpy(set_s.data), hi_s, mcfg_u.window_size,
                                     mcfg_u.horizon)
    steps_cpu = {}
    for dt in (torch.float32, torch.float64):
        tree = leaf_params({k: v.detach().to(dt) for k, v in flatten_params(params_s).items()},
                           "cpu")
        steps_cpu[dt] = step_grads(tree, mcfg_u, x_c.to(dt), y_c.to(dt), mask_s)
    t0 = time.perf_counter()
    ranks = run_ranks(2, two_card_rank, (flag, (hi_s.numpy(), mask_s.numpy())),
                      timeout=600.0, device="cuda")
    secs = time.perf_counter() - t0
    verdict = {}
    for i, tag in enumerate(("flagship_2x1", "32k_sharded_1x2")):
        loss_r, grads_r = ranks[0][i]
        same = ranks[1][i][0] == loss_r and all(
            np.array_equal(g, ranks[1][i][1][k]) for k, g in grads_r.items())
        grads_r = {k: torch.from_numpy(g) for k, g in grads_r.items()}
        if i == 0:
            loss_ref = loss_f.item()
            bad, worst, worst_name = compare_grads(grads_r, {k: g.cpu() for k, g in
                                                             grads_f.items()})
            rule = (f"worst gradient max_abs_err {worst:.3e} at {worst_name} (atol "
                    f"{GRAD_ATOL_REL:g} of each largest entry, rtol {GRAD_RTOL:g})")
        else:
            loss_ref = steps_cpu[torch.float64][0].item()
            bad, worst, worst_name, l2 = noise_grads_agreement(
                grads_r, [steps_cpu[torch.float32][1], grads_1], steps_cpu[torch.float64][1])
            rule = (f"gradients against the CPU's f64 step: worst {worst:.3f} x the larger "
                    f"distance of the CPU's f32 step and one card's at {worst_name}, L2 "
                    f"{l2:.3f} x")
        loss_err = abs(loss_r - loss_ref)
        if i == 1:  # the leaves upstream of the top-k, whose f32 gradients are noise
            g64 = steps_cpu[torch.float64][1]
            for name in ("weight_query", "gru/w_ih", "gru/w_hh"):
                d = [torch.dist(g[name].double().cpu(), g64[name], math.inf).item()
                     for g in (grads_r, grads_1, steps_cpu[torch.float32][1])]
                print(f"[9 distributed] (d) {name}: largest entry of the CPU's f64 gradient "
                      f"{g64[name].abs().max().item():.4e}; max distance to it of the two "
                      f"cards' {d[0]:.4e}, one card's {d[1]:.4e}, the CPU f32 step's "
                      f"{d[2]:.4e}")
        verdict[tag] = not bad and loss_err <= 1e-5 and same
        print(f"[9 distributed] (d) {tag} on two cards: loss {loss_r:.6f} (abs err "
              f"{loss_err:.3e}, atol 1e-5); both ranks equal: {same}; {rule}; out of "
              f"tolerance {bad[:3]}")
    # synthetic-1k's dense partition on (1, 2), without and with the ring,
    # against one card's step
    mcfg_1k, params_1k, data_1k, hi_1k, mask_1k = s1k_dense(dev)
    loss_1, grads_1k, _ = step_on(mcfg_1k, params_1k, data_1k, hi_1k, mask_1k)
    ms_1 = step_ms(mcfg_1k, params_1k, data_1k, hi_1k, mask_1k)
    for i, tag in ((2, "s1k_dense_1x2"), (3, "s1k_ring_1x2")):
        loss_r, grads_r, ms_r, counts = ranks[0][i]
        same = ranks[1][i][0] == loss_r and all(
            np.array_equal(g, ranks[1][i][1][k]) for k, g in grads_r.items())
        bad, worst, worst_name = compare_grads({k: torch.from_numpy(g) for k, g in
                                                grads_r.items()},
                                               {k: g.cpu() for k, g in grads_1k.items()})
        loss_err = abs(loss_r - loss_1.item())
        # --use_ring takes the partition's rows (parallel/ring.py
        # `ring_attention` calls the row-block attention arm): the same
        # launches with the ring as without it
        want = {"attention_kq_fwd_rows": 1, "attention_kq_bwd_rows": 1,
                "cheb_graph_conv_fwd_rows": 2, "cheb_graph_conv_fwd_rows_bf16": 0}
        launched = all(r[i][3] == want for r in ranks)
        verdict[tag] = not bad and loss_err <= 1e-5 and same and launched
        if results is not None:
            for name, n in counts.items():
                results[name]["launches"] += n
        print(f"[9 distributed] (d) {tag} on two cards: loss {loss_r:.6f} (abs err "
              f"{loss_err:.3e} against one card's, atol 1e-5); both ranks equal: {same}; "
              f"worst gradient max_abs_err {worst:.3e} at {worst_name} (atol "
              f"{GRAD_ATOL_REL:g} of each largest entry, rtol {GRAD_RTOL:g}), out of "
              f"tolerance {bad[:3]}; row-block launches a step {counts} (expected {want}); "
              f"ms a step: rank 0 {ms_r:.3f}, rank 1 {ranks[1][i][2]:.3f}, one card "
              f"{ms_1:.3f}")
    print(json.dumps({"distributed_2card": "run", "cards": cards, "seconds": round(secs, 1),
                      "agree": verdict}))
    if not all(verdict.values()):
        return _fail(f"(d) the two-card steps differ from their references: {verdict}")
    return multihost_check(flag, ranks[0][0])


def multihost_check(flag, step_2x1) -> int:
    """Phase 9 (e): the launch across hosts. Two torchrun groups on this host,
    `--nnodes 2 --node_rank 0|1 --nproc_per_node 1`, each on a card of its own
    (CUDA_VISIBLE_DEVICES: both ranks have LOCAL_RANK 0), in a working
    directory of its own where the dataset is missing, each salting Python's
    hash otherwise (`host_rank`). Rank 0's flagship data-parallel step on
    (2, 1) is held to (d)'s, `step_2x1`, by the f32 rule of phase 5; both
    hosts synthesize the same dataset; only rank 0's directory holds the
    epoch's files. 0, or the code of `_fail`."""
    import numpy as np
    import torch

    root = os.path.join(HERE, "output", "chip_smoke", "multihost")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    inputs = os.path.join(root, "inputs.pt")
    cfg_kw, data, hi, mask = flag
    torch.save({"cfg": cfg_kw, "data": torch.from_numpy(data), "hi": torch.from_numpy(hi),
                "mask": torch.from_numpy(mask)}, inputs)
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for r in (0, 1):
        cwd = os.path.join(root, f"host{r}")
        os.makedirs(cwd)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(r), PYTHONHASHSEED=str(r + 1),
                   PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node_rank",
               str(r), "--nproc_per_node", "1", "--master_addr", "127.0.0.1", "--master_port",
               str(port), os.path.join(HERE, "chip_smoke.py"), "--host-rank", inputs]
        procs.append(subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:])
            return _fail(f"(e) host {r} exited with {p.returncode}")
    lines = [json.loads(line[len("HOST_RANK "):]) for out in outs
             for line in out.splitlines() if line.startswith("HOST_RANK ")]
    if sorted(x["rank"] for x in lines) != [0, 1]:
        return _fail(f"(e) rank lines {lines}")
    lines.sort(key=lambda x: x["rank"])
    files = {r: sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, f"host{r}"))
                       for d, _, fs in os.walk(os.path.join(root, f"host{r}")) for f in fs)
             for r in (0, 1)}
    got = torch.load(os.path.join(root, "host0", "output", "step.pt"), weights_only=True)
    loss_ref, grads_ref = step_2x1
    bad, worst, worst_name = compare_grads(
        got["grads"], {k: torch.from_numpy(g) for k, g in grads_ref.items()})
    loss_err = abs(got["loss"] - loss_ref)
    bitwise = got["loss"] == loss_ref and all(
        np.array_equal(g.numpy(), grads_ref[k]) for k, g in got["grads"].items())
    same_data = lines[0]["data_sha256"] == lines[1]["data_sha256"]
    same_step = (lines[0]["loss"] == lines[1]["loss"]
                 and lines[0]["grads_sha256"] == lines[1]["grads_sha256"])
    lead_files = {"output/ECG_data/train/0_stemgnn.ckpt", "output/ECG_data/train/_stemgnn.ckpt",
                  "output/ECG_data/train/norm_stat.json", "output/ECG_data/train/metrics.jsonl"}
    files_ok = (files[1] == ["dataset/ECG_data.csv"] and lead_files <= set(files[0])
                and "dataset/ECG_data.csv" in files[0])
    verdict = {"step": not bad and loss_err <= 1e-5, "same_data": same_data,
               "same_step_on_both": same_step, "files_on_rank0_only": files_ok,
               "rank_is_not_local_rank": lines[1]["rank"] == 1 and lines[1]["local_rank"] == 0}
    print(f"[9 distributed] (e) two torchrun hosts of one card each: the flagship's step on "
          f"(2, 1), loss {got['loss']:.6f} (abs err {loss_err:.3e} against (d)'s, atol 1e-5), "
          f"bitwise (d)'s: {bitwise}; worst gradient max_abs_err {worst:.3e} at {worst_name}; "
          f"both hosts synthesized the dataset (sha256 {lines[0]['data_sha256'][:16]}..., "
          f"equal: {same_data}); one epoch of engine.train, epoch loss "
          f"{lines[0]['epoch_loss']:.6f}; files of host 1 {files[1]}; {secs:.1f} s")
    print(json.dumps({"multihost_2card": "run", "cards": torch.cuda.device_count(),
                      "seconds": round(secs, 1), "agree": verdict}))
    if not all(verdict.values()):
        return _fail(f"(e) the launch across hosts: {verdict}")
    return 0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_host_rank(inputs: str) -> int:
    """`torchrun --nnodes 2 ... chip_smoke.py --host-rank INPUTS`: a rank of
    phase 9 (e). It initialises the process group from torchrun's environment
    (NCCL, its card LOCAL_RANK), synthesizes the missing dataset in its
    working directory as the CLI does (`__main__.dataset_file`), takes the
    flagship's data-parallel step on (2, 1) from INPUTS (the step of (d)),
    then trains one epoch of the synthesized ECG_data through the CLI's
    `main`. Rank 0 saves the step in output/step.pt; every rank prints a
    `HOST_RANK` JSON line."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stemgnn_tpu_torch.__main__ import dataset_file, main
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.parallel.mesh import init_distributed, is_lead, make_mesh

    dev = init_distributed("cuda")
    flags = ["--dataset", "ECG_data", "--batch_size", str(BATCH), "--window_size", str(WINDOW),
             "--horizon", str(HORIZON), "--multi_layer", str(MULTI), "--epoch", "1",
             "--data_axis", "2", "--evaluate", "False"]
    path = dataset_file(TrainConfig(dataset="ECG_data"))
    with open(path, "rb") as f:
        data_sha = hashlib.sha256(f.read()).hexdigest()
    x = torch.load(inputs, weights_only=True)
    mcfg = TrainConfig(**x["cfg"]).model_config(x["data"].shape[1])
    loss, grads, _ = step_on(mcfg, init_params(0, mcfg, device=dev), x["data"].to(dev),
                             x["hi"].to(dev), x["mask"].to(dev), make_mesh(2, 1))
    grads = {k: g.detach().cpu() for k, g in grads.items()}
    digest = hashlib.sha256(b"".join(g.numpy().tobytes() for g in grads.values())).hexdigest()
    if is_lead():
        os.makedirs("output", exist_ok=True)
        torch.save({"loss": loss.item(), "grads": grads}, os.path.join("output", "step.pt"))
    rank, local = dist.get_rank(), int(os.environ["LOCAL_RANK"])
    main(flags)  # destroys the process group at its end
    epoch_loss = float("nan")
    log = os.path.join("output", "ECG_data", "train", "metrics.jsonl")
    if os.path.exists(log):
        with open(log) as f:
            epoch_loss = [e for e in map(json.loads, f) if e["event"] == "epoch"][0]["loss"]
    print("HOST_RANK " + json.dumps({"rank": rank, "local_rank": local, "loss": loss.item(),
                                     "grads_sha256": digest, "data_sha256": data_sha,
                                     "epoch_loss": epoch_loss}))
    return 0


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
    from stemgnn_tpu_torch.models import init_params, stemgnn
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
    # the stretch path, synthetic-100k-seggru: a seeded series of 16 windows
    # (phase 6's chunk; phase 4 serves the first 2), its [N, k] dropout mask,
    # and one train step of its model on the CPU plain path (the reference of
    # phase 5 and the inputs of phase 3's stretch checks)
    stretch = bench.config_kwargs(S100K)
    n_s = stretch["n_nodes"]
    cfg_s = dataclasses.replace(cfg, batch_size=stretch["batch"], multi_layer=stretch["multi"],
                                sparse_k=stretch["sparse_k"], gru_hidden=stretch["gru_hidden"],
                                gru_segment=stretch["gru_segment"])
    mcfg_s = cfg_s.model_config(n_s)
    params_s = init_params(cfg.seed, mcfg_s, device=dev)
    series_s = np.random.default_rng(13).standard_normal((WINDOW + HORIZON + 15, n_s))
    set_s = WindowDataset(series_s, WINDOW, HORIZON, cfg.norm_method,
                          compute_norm_stats(series_s, cfg.norm_method))
    set_s2 = WindowDataset(series_s[:WINDOW + HORIZON + 1], WINDOW, HORIZON, cfg.norm_method,
                           set_s.norm_statistic)
    hi_s = torch.from_numpy(set_s.epoch_batches(1, shuffle=False)[0]).long()
    x_s, y_s = engine.gather_windows(torch.from_numpy(set_s.data).to(dev), hi_s.to(dev),
                                     WINDOW, HORIZON)
    mask_s = torch.from_numpy(np.random.default_rng(14).random((n_s, mcfg_s.sparse_k))
                              < 1.0 - mcfg_s.dropout_rate)
    t0 = time.perf_counter()
    with OpRecorder(ops) as rec_s:
        loss_s_cpu, grads_s_cpu = step_grads(leaf_params(params_s, "cpu"), mcfg_s, x_s.cpu(),
                                             y_s.cpu(), mask_s)
    cpu_s_s = time.perf_counter() - t0
    # the dense-GRU sparse variant (sparse_k alone) at synthetic-1k's N and
    # batch: two batches of a seeded series, a seeded [N, k] mask
    mcfg_v = dataclasses.replace(cfg, sparse_k=SPARSE_K).model_config(S1K_NODES)
    params_v = init_params(cfg.seed, mcfg_v, device=dev)
    series_v = np.random.default_rng(16).standard_normal(
        (WINDOW + HORIZON + 2 * S1K_BATCH - 1, S1K_NODES))
    set_v = WindowDataset(series_v, WINDOW, HORIZON, cfg.norm_method,
                          compute_norm_stats(series_v, cfg.norm_method))
    hi_v = torch.from_numpy(set_v.epoch_batches(S1K_BATCH, shuffle=False)[0]).long()
    x_v, y_v = engine.gather_windows(torch.from_numpy(set_v.data).to(dev), hi_v.to(dev),
                                     WINDOW, HORIZON)
    mask_v = torch.from_numpy(np.random.default_rng(17).random((S1K_NODES, SPARSE_K))
                              < 1.0 - mcfg_v.dropout_rate)
    tag_v = f"sparse_k {SPARSE_K} at N={S1K_NODES}, batch {S1K_BATCH}"
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
        fail = attention_checks(dev)
    if fail is None:
        fail = rows_checks(dev, results, params, mcfg, x)
    if fail is None:
        # and at the stretch shape (102,400 rows, D1 = 96), untimed here
        fail = spectral_checks(dev, params["blocks"][0]["glu"], MULTI, extra=[
            (1, n_s, WINDOW, mcfg_s.multi_layer, params_s["blocks"][0]["glu"],
             np.random.default_rng(15), False)])
    if fail is None:
        # the spectral kernels at the COVID-19 shape, timed as above (printed
        # only: the kernels line keeps the flagship's shapes)
        tag = "3 kernel, COVID-19 shape"
        fail = (check_cases([c for c in forward_cases(params_cov, mcfg_cov, x_cov)
                             if c[0].startswith("spectral")], {}, tag)
                or check_cases([c for c in backward_cases(rec_cov, params_cov, mcfg_cov, dev)
                                if c[0].startswith("spectral")], {}, tag, scaled=True))
    if fail is None:
        # the bf16 arms at the flagship's shapes, then the bf16 graph conv at
        # synthetic-1k's and a ragged one
        fail = (check_bf16_cases(bf16_cases(rec, params, mcfg, x), results, "3 kernel")
                or graph_bf16_checks(dev))
    if fail is None:
        # the bf16 graph conv and both storage arms of the bf16 saving pair at
        # the COVID-19 shape, timed as above (printed only)
        fail = check_bf16_cases(
            [c for c in bf16_cases(rec_cov, params_cov, mcfg_cov, x_cov)
             if c[0].startswith(("cheb_graph_conv", "spectral_fwd_save",
                                 "spectral_bwd_reread"))],
            {}, "3 kernel, COVID-19 shape")
    if fail is None:
        fail = bf16_redesigns(results, params, mcfg, x)
    if fail is None:
        # the stretch path's kernels at its own shapes (printed only: the
        # kernels line keeps the flagship's): the GRU cluster kernels at
        # n != h, synthetic-100k-seggru's on the CPU step's GRU input and
        # cotangent, synthetic-4k-seggru's on seeded ones; the spectral
        # kernels on seeded inputs
        call = rec_s.calls["gru_over_nodes_segmented"][0]
        rng_4k = np.random.default_rng(18)
        h4, bound_4k = S4K_GRU["hidden"], 1.0 / math.sqrt(S4K_GRU["hidden"])
        gru_4k = {k: torch.from_numpy(rng_4k.uniform(-bound_4k, bound_4k, shape)
                                      .astype(np.float32)).to(dev)
                  for k, shape in (("w_ih", (3 * h4, WINDOW)), ("w_hh", (3 * h4, h4)),
                                   ("b_ih", (3 * h4,)), ("b_hh", (3 * h4,)))}
        x_4k = torch.from_numpy(rng_4k.standard_normal(
            (S4K_GRU["batch"], WINDOW, S4K_GRU["nodes"])).astype(np.float32)).to(dev)
        g_4k = torch.from_numpy((1e-2 * rng_4k.standard_normal(
            (S4K_GRU["batch"], S4K_GRU["nodes"], h4))).astype(np.float32)).to(dev)
        fail = (segmented_gru_check({k: v.detach() for k, v in params_s["gru"].items()},
                                    call["args"][1].to(dev), call["g"].to(dev),
                                    mcfg_s.gru_segment, f"{S100K} shape")
                or segmented_gru_check(gru_4k, x_4k, g_4k, S4K_GRU["segment"],
                                       "synthetic-4k-seggru shape")
                or stretch_spectral_check(params_s["blocks"][0]["glu"], mcfg_s.multi_layer,
                                          n_s, dev, f"3 kernel, {S100K} shape")
                or grid_ceiling_check(params_s["blocks"][0]["glu"], dev))
    if fail is not None:
        return _fail(fail)
    call = rec_s.calls["spe_seq_cell"][0]
    print(f"[3 kernel] {S100K}: one train step of the CPU plain path (the reference of "
          f"phase 5 and the GRU inputs above) took {cpu_s_s:.1f} s on the host; its first "
          f"spectral cell's input reaches |x| {call['args'][0].abs().max().item():.4g}, its "
          f"output {call['out'].abs().max().item():.4g}")
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
    limits = _build.card_limits(dev)
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

    # the stretch path: synthetic-100k-seggru's 2 windows (batch 1) and the
    # dense-GRU sparse variant's 2 batches through engine.inference_batched,
    # counters set to 0 just before and read just after (a batch: the GRU
    # forward, cluster or grid, and 2 spectral forwards; no attention, no
    # graph conv), the forecasts against the CPU plain path (atol 1e-3) and
    # the first batch's latent graph too: the same top-k index set, and c,
    # degree and inv_sqrt within 1e-5
    for tag, mcfg_x, params_x, set_x, batch, gru_name in (
            (S100K, mcfg_s, params_s, set_s2, 1, "gru_fwd"),
            (tag_v, mcfg_v, params_v, set_v, S1K_BATCH, "gru_fwd_grid")):
        n_b = len(set_x.epoch_batches(batch, shuffle=False))
        ops.reset_launches()
        t0 = time.perf_counter()
        fc_x, _ = engine.inference_batched(engine.make_eval_step(mcfg_x, dev), params_x, set_x,
                                           batch, dev)
        serve_s = time.perf_counter() - t0
        launches, replayed = take_launches(ops, results)
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update({gru_name: n_b, "spectral_fwd": 2 * n_b})
        if launches != want or any(replayed.values()):
            return _fail(f"{tag} serving launch counts {launches} and {replayed}, expected {want}")
        params_x_cpu = leaf_params(params_x, "cpu")
        fc_x_cpu, _ = engine.inference_batched(engine.make_eval_step(mcfg_x, "cpu"),
                                               params_x_cpu, set_x, batch, "cpu")
        shape = (len(set_x), HORIZON, mcfg_x.units)
        if fc_x.shape != shape or not np.isfinite(fc_x).all():
            return _fail(f"{tag} forecasts {fc_x.shape}, expected {shape} and finite")
        err = float(abs(fc_x - fc_x_cpu).max())
        hi0 = torch.from_numpy(set_x.epoch_batches(batch, shuffle=False)[0]).long()
        x0, _ = engine.gather_windows(torch.from_numpy(set_x.data), hi0, WINDOW, HORIZON)
        with torch.inference_mode():
            _, g_card = stemgnn.forward(params_x, mcfg_x, x0.to(dev))
            _, g_cpu = stemgnn.forward(params_x_cpu, mcfg_x, x0)
        same_idx, g_err = graph_agreement(g_card, g_cpu)
        print(f"[4 serving path] {tag}: {len(set_x)} windows in {n_b} batches through "
              f"engine.inference_batched, {serve_s:.3f} s; wrapper launches {launches}; "
              f"forecasts, card vs CPU plain path: max_abs_err {err:.3e} (atol 1e-3); the "
              f"first batch's graph: top-{mcfg_x.sparse_k} index sets "
              f"{'equal' if same_idx else 'DIFFER'}, c, degree and inv_sqrt max_abs_err "
              f"{g_err:.3e} (atol 1e-5)")
        if err > 1e-3 or not same_idx or not g_err <= 1e-5:
            return _fail(f"{tag} serving differs from the CPU plain path: forecasts {err}, "
                         f"index sets equal {same_idx}, graph {g_err}")
        del params_x_cpu
    rc = jax_serving_phase(dev, results, out_root, fwd_per_batch)
    if rc:
        return rc

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

    # the stretch path: one train step of synthetic-100k-seggru and of the
    # dense-GRU sparse variant on the card, counters set to 0 just before and
    # read just after (the GRU pair, cluster or grid, and 2 of each spectral
    # kernel of the step's pair; no attention, no graph conv), the loss (atol
    # 1e-5) against the CPU plain path's step on the same batch and [N, k]
    # mask and every gradient against the CPU's f64 step by the noise rule
    # (`noise_grads_agreement`); the same step again, bitwise;
    # the 100k step's peak allocated memory (at most 10 GB: one [N, N] f32
    # array would be 42 GB)
    t0 = time.perf_counter()
    loss_v_cpu, grads_v_cpu = step_grads(leaf_params(params_v, "cpu"), mcfg_v, x_v.cpu(),
                                         y_v.cpu(), mask_v)
    cpu_v_s = time.perf_counter() - t0

    def f64_step(params_x, mcfg_x, xb, yb, mask_x):
        tree64 = leaf_params({k: v.detach().double() for k, v in
                              flatten_params(params_x).items()}, "cpu")
        return step_grads(tree64, mcfg_x, xb.cpu().double(), yb.cpu().double(), mask_x)

    for tag, mcfg_x, params_x, xb, yb, mask_x, loss_ref, grads_ref, grus, cpu_secs in (
            (S100K, mcfg_s, params_s, x_s, y_s, mask_s, loss_s_cpu, grads_s_cpu,
             ("gru_fwd", "gru_bwd"), cpu_s_s),
            (tag_v, mcfg_v, params_v, x_v, y_v, mask_v, loss_v_cpu, grads_v_cpu,
             ("gru_fwd_grid", "gru_bwd_grid"), cpu_v_s)):
        loss_64, grads_64 = f64_step(params_x, mcfg_x, xb, yb, mask_x)
        params_x_gpu = leaf_params(params_x, dev)
        mask_dev = mask_x.to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        loss_x, grads_x = step_grads(params_x_gpu, mcfg_x, xb, yb, mask_dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches, replayed = take_launches(ops, results)
        grads_x = {k: g.clone() for k, g in grads_x.items()}
        loss_again, grads_again = step_grads(params_x_gpu, mcfg_x, xb, yb, mask_dev)
        differ = [k for k, g in grads_again.items() if not torch.equal(g, grads_x[k])]
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update({grus[0]: 1, grus[1]: 1, train_spe[0]: 2, train_spe[1]: 2})
        bad, worst, worst_name, l2 = noise_grads_agreement(grads_x, grads_ref, grads_64)
        cpu_noise = max((grads_ref[k].double() - g).abs().max().item()
                        / max(g.abs().max().item(), 1e-30) for k, g in grads_64.items())
        loss_err = abs(loss_x.item() - loss_ref.item())
        print(f"[5 train path] {tag}, one train step on the card: wrapper launches "
              f"{launches}; loss {loss_x.item():.6f} (abs err {loss_err:.3e} against the CPU "
              f"plain path's, atol 1e-5); {len(grads_x)} gradients against the CPU's f64 step "
              f"(the CPU's f32 step {cpu_secs:.1f} s on the host, up to {cpu_noise:.3e} of a "
              f"gradient's largest entry from it): each within max({GRAD_ATOL_REL:g} of its "
              f"largest entry, {STEP_NOISE_FACTOR:g} x the CPU f32 step's distance), worst "
              f"{worst:.3f} x at {worst_name}; L2 {l2:.3f} x the CPU f32 step's (at most "
              f"{STEP_NOISE_L2:g}): {'yes' if not bad else 'NO'}; the same step twice "
              f"{'bitwise equal' if not differ and torch.equal(loss_x, loss_again) else 'DIFFERS'}"
              f"; peak allocated {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
              f"the {base / 2**30:.3f} GiB held before the step)")
        if (launches != want or any(replayed.values()) or loss_err > 1e-5 or bad or differ
                or not torch.equal(loss_x, loss_again)):
            return _fail(f"{tag} train step: launches {launches} (expected {want}), loss err "
                         f"{loss_err}, leaves (name, err, noise) {bad[:5]}, rerun {differ[:5]}")
        if tag == S100K and peak > 10e9:
            return _fail(f"the {S100K} step peaked at {peak / 1e9:.2f} GB, past 10 GB")
        del params_x_gpu, grads_x, grads_again
    # where the time of a synthetic-100k-seggru train step goes, at each
    # compute_dtype: the engine's eager train step on the 16 windows of phase
    # 6's series, 3 warm steps, 5 on the host clock, 5 under torch.profiler
    data_p = torch.from_numpy(set_s.data).to(dev)
    his_p = [torch.from_numpy(b.astype(np.int64)).to(dev)
             for b in set_s.epoch_batches(1, shuffle=False)[:13]]
    for cd in ("float32", "bfloat16"):
        flat_p = {k: v.detach().clone().requires_grad_(True)
                  for k, v in flatten_params(params_s).items()}
        tree_p = unflatten_params(flat_p)
        step_p = engine.make_train_step(mcfg_s, make_optimizer("RMSProp", flat_p.values(),
                                                               cfg_t.lr),
                                        flat_p.values(), compute_dtype=cd)
        gen_p = torch.Generator(device=dev).manual_seed(5)
        for hi_b in his_p[:3]:
            step_p(tree_p, data_p, hi_b, gen_p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for hi_b in his_p[3:8]:
            step_p(tree_p, data_p, hi_b, gen_p)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"[5 train path] {S100K}, compute_dtype {cd}: the eager train step "
              f"{step_ms:.3f} ms of host clock (5 steps after 3 warm)")
        profile_steps(lambda hi_b: step_p(tree_p, data_p, hi_b, gen_p), his_p[8:13], step_ms,
                      f"5 train path, {S100K}, {cd}")
    del data_p, flat_p, tree_p, step_p

    # one epoch of engine.train on ECG_data on the stretch path (--sparse_k 16
    # --gru_hidden 32 --gru_segment 35: 4 segments of 35 nodes, 128 rows of the
    # GRU), counters set to 0 just before and read just after and held against
    # the launches of the dense epoch above with the stretch step's kernels
    run_dir_s = os.path.join(out_root, cfg.dataset, "train_run_stretch")
    cfg_ts = dataclasses.replace(cfg_t, sparse_k=16, gru_hidden=32, gru_segment=35)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    valid_s, _ = engine.train(train_data, valid_data, cfg_ts, run_dir_s)
    torch.cuda.synchronize()
    train_s_s = time.perf_counter() - t0
    launches, replayed = take_launches(ops, results)
    want = dict.fromkeys(ops.KERNELS, 0)
    want_replayed = dict(want)
    for name, n in {"gru_fwd": 1, "gru_bwd": 1, train_spe[0]: 2, train_spe[1]: 2}.items():
        want[name] += n * eager_steps
        want_replayed[name] += n * chunked
    for name, n in {"gru_fwd": 1, "spectral_fwd": 2}.items():
        want[name] += n * (1 + valid_batches - valid_full)
        want_replayed[name] += n * valid_full
    with open(os.path.join(run_dir_s, "metrics.jsonl")) as f:
        epochs_s = [e for e in map(json.loads, f) if e["event"] == "epoch"]
    print(f"[5 train path] engine.train on the stretch path (sparse_k 16, gru_hidden 32, "
          f"gru_segment 35): 1 epoch, {train_s_s:.3f} s with its captures; wrapper launches "
          f"{launches}; launched by graph replays {replayed}; epoch loss "
          f"{epochs_s[0]['loss'] if epochs_s else float('nan'):.6f}, validate MAE "
          f"{float(valid_s['mae']):.6f}")
    if launches != want or replayed != want_replayed:
        return _fail(f"stretch train path launch counts {launches} and {replayed}, expected "
                     f"{want} and {want_replayed}")
    if (len(epochs_s) != 1 or not math.isfinite(epochs_s[0]["loss"])
            or not math.isfinite(float(valid_s["mae"]))):
        return _fail(f"stretch epoch events {epochs_s}, validate {valid_s}")

    rc = jax_train_phase(dev, results, out_root, step_kernels, fwd_per_batch, sets,
                         train_data, valid_data, cfg_t)
    if rc:
        return rc

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

    # the same for synthetic-100k-seggru: a 16-step chunk (its [N, k] masks
    # drawn from the generator before the replay) against the same 16 steps
    # taken eagerly, bitwise
    data_s = torch.from_numpy(set_s.data).to(dev)
    hi_s_matrix = torch.from_numpy(
        np.stack(set_s.epoch_batches(1, shuffle=False)[:CHUNK]).astype(np.int64)).to(dev)
    finals_s = {}
    for mode in ("eager", "chunk"):
        flat_x = {k: v.detach().clone().requires_grad_(True)
                  for k, v in flatten_params(params_s).items()}
        tree_x = unflatten_params(flat_x)
        opt_x = make_optimizer("RMSProp", flat_x.values(), cfg_t.lr)
        gen_x = torch.Generator(device=dev)
        gen_x.manual_seed(engine.epoch_generator_seed(cfg_t.seed, 4))
        if mode == "eager":
            step_x = engine.make_train_step(mcfg_s, opt_x, flat_x.values())
            losses_x = torch.stack([step_x(tree_x, data_s, hi_b, gen_x) for hi_b in hi_s_matrix])
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses_x = engine.make_epoch_fn(mcfg_s, opt_x, flat_x.values())(
                tree_x, data_s, hi_s_matrix, gen_x)
            torch.cuda.synchronize()
            capture_x_s = time.perf_counter() - t0
        finals_s[mode] = (losses_x, flat_x, [opt_x.state[p]["square_avg"]
                                             for p in flat_x.values()])
    (l_e, p_e, s_e), (l_c, p_c_s, s_c_s) = finals_s["eager"], finals_s["chunk"]
    differ = [k for k in p_e if not torch.equal(p_e[k], p_c_s[k])]
    if (not torch.equal(l_e, l_c) or differ
            or not all(torch.equal(a, b) for a, b in zip(s_e, s_c_s))):
        return _fail(f"a {CHUNK}-step {S100K} chunk differs from the eager steps: losses "
                     f"{l_e.tolist()} and {l_c.tolist()}, parameters {differ[:5]}")
    print(f"[6 chunk path] {S100K}: a {CHUNK}-step chunk (warm-up, capture and first replay "
          f"{capture_x_s:.3f} s) against the same steps taken eagerly: {CHUNK} losses, "
          f"{len(p_e)} parameters and their RMSProp moments bitwise equal; last loss "
          f"{l_c[-1].item():.6f}")
    del finals_s, p_e, s_e, p_c_s, s_c_s, data_s

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

    # the stretch path: bench.measure and bench.measure_eval at
    # synthetic-100k-seggru (its full width: 102,400 nodes, batch 1), f32 and
    # bf16, counters set to 0 just before and read just after each; chunks of
    # STRETCH_CHUNK steps, STRETCH_STEPS a timed window
    stretch_bench = dict(stretch, steps=STRETCH_STEPS, warmup=STRETCH_CHUNK,
                         chunk_steps=STRETCH_CHUNK)
    pairs = {("float32", True): ("spectral_fwd_save", "spectral_bwd_reread"),
             ("float32", False): ("spectral_fwd", "spectral_bwd"),
             ("bfloat16", True): ("spectral_fwd_save_bf16", "spectral_bwd_reread_bf16"),
             ("bfloat16", False): ("spectral_fwd_bf16", "spectral_bwd_bf16")}
    dense_only = ("attention_kq_fwd", "attention_kq_bwd", "cheb_graph_conv_fwd",
                  "cheb_graph_conv_fwd_bf16")
    for cd in ("float32", "bfloat16"):
        label = f"{S100K} train, {cd}"
        res, launches, replayed = run_train_bench(label, reread=default_reread,
                                                  compute_dtype=cd, **stretch_bench)
        total = {k: launches[k] + replayed[k] for k in launches}
        steps_run = total["gru_bwd"]
        pair = pairs[(cd, default_reread)]
        if (steps_run <= 0 or total["gru_fwd"] != steps_run
                or any(total[k] != 2 * steps_run for k in pair)
                or any(total[k] for k in dense_only)):
            return _fail(f"bench {label}: the launches are {launches} and {replayed}")
        print(f"[7 bench path] {label}: {steps_run} steps, wrapper launches {launches}; "
              f"launched by graph replays {replayed}")
        ops.reset_launches()
        res_e = bench.measure_eval(compute_dtype=cd, **stretch_bench)
        launches, replayed = take_launches(ops, results)
        label = f"{S100K} eval, {cd}"
        bench_line(label, res_e)
        fwd = "spectral_fwd" if cd == "float32" else "spectral_fwd_bf16"
        if (not replayed["gru_fwd"] or replayed[fwd] != 2 * replayed["gru_fwd"]
                or any(launches[k] + replayed[k] for k in dense_only)):
            return _fail(f"bench {label}: the launches are {launches} and {replayed}")
        print(f"[7 bench path] {label}: wrapper launches {launches}; launched by graph "
              f"replays {replayed}; {res['step_time_ms']:.4f} ms a train step, "
              f"{res_e['step_time_ms']:.4f} ms an eval batch")

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

    # --- 9. distributed ---
    t0 = time.perf_counter()
    rc = distributed_phase(dev, results, cfg, sets["train"].data, his, masks, bench_line,
                           run_train_bench)
    if rc:
        return rc
    print(f"[9 distributed] {time.perf_counter() - t0:.1f} s")

    # --- 10. summary ---
    print(f"[10 summary] chip_smoke ran {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    cards = torch.cuda.device_count()
    for r in results.values():
        if r["launches"] > 0:
            continue
        if r["name"] in ROW_ARMS and cards < 2:
            # the node-sharded dense path needs 'graph' > 1: two ranks, two
            # cards (NCCL takes no two ranks on one card); phase 3 held the
            # arms to their plain versions at its blocks
            print(f"[10 summary] {r['name']}: launched on the node-sharded dense path "
                  f"alone, which needs two cards (phase 9 (d)); {cards} card here: 0 "
                  "launches")
            continue
        return _fail(f"{r['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_two_card() -> int:
    """`python3 chip_smoke.py --two-card`: phase 2 and phase 9 (d) and (e)
    alone, on a host of two cards or more."""
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return _fail("--two-card needs two cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.data import (
        WindowDataset, compute_norm_stats, ensure_dataset, load_csv, split_by_ratio)
    from stemgnn_tpu_torch.ops import _build

    print(f"[2 build] {_build.build_all()[1]:.1f} s; {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(0)}")
    cfg = TrainConfig(dataset="ECG_data", train=False, batch_size=BATCH, window_size=WINDOW,
                      horizon=HORIZON, multi_layer=MULTI, device="cuda",
                      data_dir=os.path.join(HERE, "dataset"))
    data = load_csv(ensure_dataset(cfg.dataset, cfg.data_dir))
    train_data = split_by_ratio(data, cfg.train_length, cfg.valid_length, cfg.test_length)[0]
    train_set = WindowDataset(train_data, WINDOW, HORIZON, cfg.norm_method,
                              compute_norm_stats(train_data, cfg.norm_method))
    batches = train_set.epoch_batches(BATCH, shuffle=True,
                                      rng=np.random.default_rng([cfg.seed, 0]))
    his = [torch.from_numpy(b.astype(np.int64)) for b in batches[:1]]
    masks = torch.from_numpy(
        np.random.default_rng(7).random((3, BATCH, data.shape[1], data.shape[1]))
        < 1.0 - cfg.dropout_rate)
    return two_card_checks(torch.device("cuda"), cfg, train_set.data, his, masks)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-rank"]:
        sys.exit(run_host_rank(sys.argv[2]))
    sys.exit(run_two_card() if sys.argv[1:] == ["--two-card"] else run())
