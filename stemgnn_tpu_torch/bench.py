"""Benchmark harness: prints ONE JSON line with the headline metric.

    python -m stemgnn_tpu_torch.bench [--mode train|eval] [--steps N]
        [--repeats R] [--batch B] [--spectral-bwd reread|recompute] [--bf16]
        [--config NAME] [--set-baseline] [--device cpu]

Headline: steady-state training throughput (windows/second) of the ECG
flagship (140 nodes, window 12, horizon 3, multi_layer 5, batch 32, f32,
RMSProp, dropout 0.5), the full train step (forward, backward, update), on
the card. The method is the JAX package's bench.py: the step runs through
the engine's chunked device program (`make_epoch_fn`, one captured CUDA graph
of 64 steps per dispatch), the timed window runs `repeats` times, and the
MEDIAN per-step time is the number of record, with min, max and spread
beside it.

`vs_baseline` is relative to `stemgnn_tpu_torch/bench_baseline.json`, which
`--set-baseline` writes on the card, with the card's name and power limit in
it; without that file it is null. `--mode eval` times the forward-only eval
program (`make_eval_epoch_fn`) and reports its ratio to the per-batch eager
eval loop measured in the same run. `--spectral-bwd` sets, for the run, which
backward the spectral cell trains with (`ops.cuda_spectral.SAVE_ACTS_BWD`).
`--bf16` runs the step (or the eval program) at compute_dtype "bfloat16", the
JAX bench's `--bf16`: the graph conv's and spectral kernels' bf16 arms. The
default stays float32, the precision of the baseline file, so a bf16 train
run's `vs_baseline` is its ratio to that float32 baseline; the JSON line
names the precision.

`--config NAME` measures one of `CONFIGS`, the rows of the JAX suite's
`LARGE_CONFIGS` (benchmarks/suite.py:45) that the port runs: `synthetic-1k`
(dense) and the stretch rows with a segmented GRU, `synthetic-4k-seggru`,
`synthetic-32k-seggru` and `synthetic-100k-seggru` (102,400 nodes, multi 2,
batch 1, sparse_k 64, gru_hidden 64, gru_segment 1024), with the row's batch
unless `--batch` is given. Its train line's `vs_baseline` is null: the
baseline file is the ECG flagship's. `edges_per_s` counts as the JAX bench
counts it, B x 3 x N^2 x 2 a step, the dense graph's entries, also on the
sparse path, which touches B x 4 x N x k of them.

`synthetic-32k-sharded` is `synthetic-32k-seggru` through the node-sharded
dispatch (`force_sparse_shard`, `parallel/sparse_shard.py`) on a (1, 1) mesh:
`measure` and `measure_eval` start a process group of this process alone
(NCCL on the card, gloo on the CPU; `parallel.mesh.world_of_one`), so the
collectives sum over one rank but the kernels and the dispatch are the
multi-card ones, captured into the chunk's CUDA graph with them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.device import card_info, resolve_device
from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
from stemgnn_tpu_torch.models.initializers import init_params
from stemgnn_tpu_torch.ops import cuda_spectral
from stemgnn_tpu_torch.parallel.mesh import make_mesh, world_of_one
from stemgnn_tpu_torch.train.engine import (
    CHUNK_SIZES,
    gather_windows,
    make_epoch_fn,
    make_eval_epoch_fn,
    make_eval_step,
)
from stemgnn_tpu_torch.train.optim import make_optimizer
from stemgnn_tpu_torch.utils.flops import mfu as mfu_fn

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
# name: (n_nodes, window, horizon, multi, batch, sparse_k, gru_hidden, gru_segment),
# the JAX suite's rows (benchmarks/suite.py LARGE_CONFIGS). Not here: the
# dense-GRU sparse rows (synthetic-4k-sparse64, 8k-sparse64: a hidden = N GRU
# at 4096-8192 units).
CONFIGS = {
    "synthetic-1k": (1024, 12, 3, 5, 8, None, None, 0),
    "synthetic-4k-seggru": (4096, 12, 3, 5, 4, 64, 128, 512),
    "synthetic-32k-seggru": (32768, 12, 3, 5, 2, 64, 64, 1024),
    "synthetic-100k-seggru": (102400, 12, 3, 2, 1, 64, 64, 1024),
    "synthetic-32k-sharded": (32768, 12, 3, 5, 2, 64, 64, 1024),
}
# the rows whose 9th field in the JAX suite, force_sparse_shard, is True: the
# node-sharded stretch path on a (1, 1) mesh of a process group of one rank
SHARDED = frozenset({"synthetic-32k-sharded"})


def config_kwargs(name: str) -> dict:
    """`measure` / `measure_eval` keywords of a row of CONFIGS."""
    n, window, horizon, multi, batch, sparse_k, gru_hidden, gru_segment = CONFIGS[name]
    return dict(n_nodes=n, window=window, horizon=horizon, multi=multi, batch=batch,
                sparse_k=sparse_k, gru_hidden=gru_hidden, gru_segment=gru_segment,
                force_sparse_shard=name in SHARDED)
T_LEN = 4096  # rows of the synthetic series the windows are cut from


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _plan(steps, warmup, chunk_steps, repeats, max_extra_repeats):
    """(chunk, chunks per window, steps per window, warm chunks, repeats, most
    repeats): `steps` rounds down to whole chunks (at least one), `warmup` up."""
    chunk = chunk_steps or CHUNK_SIZES[0]
    n_chunks = max(1, steps // chunk)
    if n_chunks * chunk != steps:
        print(f"bench: steps={steps} rounded to {n_chunks * chunk} "
              f"(multiple of chunk={chunk})", file=sys.stderr)
    n_warm = max(1, -(-warmup // chunk)) if warmup else 1
    repeats = max(1, repeats)
    return chunk, n_chunks, n_chunks * chunk, n_warm, repeats, repeats + max(
        0, max_extra_repeats)


def _inputs(seed, n_nodes, window, horizon, chunk, batch, n_dispatch, dev):
    """The series and one [chunk, batch] matrix of window end indices per
    dispatch, from np.random.default_rng(seed), on `dev`."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(
        rng.standard_normal((T_LEN, n_nodes)).astype(np.float32)).to(dev)
    his = [torch.from_numpy(rng.integers(window, T_LEN - horizon, size=(chunk, batch))
                            .astype(np.int64)).to(dev) for _ in range(n_dispatch)]
    return data, his


def _timed_repeats(window_fn, steps, repeats, max_reps, spread_warn):
    """Per-step seconds of `repeats` timed windows (window_fn(rep) runs one
    and returns when its work on the device is done), with up to max_reps -
    repeats more while (max - min) / median exceeds spread_warn."""
    times = []
    for rep in range(max_reps):
        if rep >= repeats:
            med = float(np.median(times))
            spread = (max(times) - min(times)) / med
            if spread <= spread_warn:
                break
            print(f"bench: spread {spread:.1%} > {spread_warn:.0%} after {rep} "
                  "repeats: running one more", file=sys.stderr)
        t0 = time.perf_counter()
        window_fn(rep)
        times.append((time.perf_counter() - t0) / steps)
    return times


def _summary(times, batch, chunk, spread_warn):
    step_time = float(np.median(times))
    spread = (max(times) - min(times)) / step_time
    if spread > spread_warn:
        print(f"bench: WARNING: per-step timing spread {spread:.1%} across "
              f"{len(times)} repeats exceeds {spread_warn:.0%}; the median is "
              "reported", file=sys.stderr)
    return {
        "windows_per_s": batch / step_time,
        "step_time_ms": step_time * 1e3,
        "step_time_ms_min": min(times) * 1e3,
        "step_time_ms_max": max(times) * 1e3,
        "repeats": len(times),
        "spread": spread,
        "chunk_steps": chunk,
    }


def measure(batch=32, steps=128, warmup=None, n_nodes=140, window=12, horizon=3,
            multi=5, seed=0, chunk_steps=None, repeats=3, max_extra_repeats=2,
            spread_warn=0.15, device="cuda", compute_dtype="float32", sparse_k=None,
            gru_hidden=None, gru_segment=0, force_sparse_shard=False):
    """Steady-state train-step time through the engine's chunked epoch program
    (`make_epoch_fn`: on the card one captured CUDA graph of `chunk_steps`
    steps per dispatch, default CHUNK_SIZES[0]), at `compute_dtype`, RMSProp lr
    1e-4, dropout 0.5, weights from init_params(seed).

    Warm-up runs whole chunks (the first pays for the capture); each timed
    window runs `steps` steps and is closed by a synchronize and a read of its
    last loss; `repeats` windows, more while their spread exceeds
    `spread_warn`; the median per-step time is reported, with min, max and
    spread, the loss, the seconds the warm-up took, the edges pushed through
    the graph conv per second, the analytic FLOPs of a step and their share of
    the card's peaks (`mfu`). `sparse_k`, `gru_hidden` and `gru_segment`
    select the stretch path (StemGNNConfig); `force_sparse_shard` runs it
    node-sharded on a (1, 1) mesh (`_mesh_of`)."""
    dev = resolve_device(device)
    with _mesh_of(force_sparse_shard, dev) as mesh:
        cfg = StemGNNConfig(units=n_nodes, window_size=window, horizon=horizon,
                            multi_layer=multi, sparse_k=sparse_k, gru_hidden=gru_hidden,
                            gru_segment=gru_segment, force_sparse_shard=mesh is not None)
        flat = {k: v.requires_grad_(True)
                for k, v in flatten_params(init_params(seed, cfg, device=dev)).items()}
        params = unflatten_params(flat)
        opt = make_optimizer("RMSProp", flat.values(), 1e-4)
        epoch_fn = make_epoch_fn(cfg, opt, flat.values(), compute_dtype=compute_dtype,
                                 mesh=mesh)
        generator = torch.Generator(device=dev).manual_seed(seed)

        chunk, n_chunks, steps, n_warm, repeats, max_reps = _plan(
            steps, warmup, chunk_steps, repeats, max_extra_repeats)
        data, his = _inputs(seed, n_nodes, window, horizon, chunk, batch,
                            n_warm + max_reps * n_chunks, dev)

        losses = None
        t0 = time.perf_counter()
        for i in range(n_warm):
            losses = epoch_fn(params, data, his[i], generator)
        _sync(dev)
        warmup_s = time.perf_counter() - t0
        last = {"loss": float(losses[-1])}

        def window_fn(rep):
            first = n_warm + rep * n_chunks
            for i in range(first, first + n_chunks):
                losses = epoch_fn(params, data, his[i], generator)
            _sync(dev)
            last["loss"] = float(losses[-1])

        times = _timed_repeats(window_fn, steps, repeats, max_reps, spread_warn)
        res = _summary(times, batch, chunk, spread_warn)
        step_time = res["step_time_ms"] / 1e3
        # entries of the dense learned graph pushed through the graph conv per
        # step: the kernel runs orders 1..3 (T0 is identically zero), two stacks;
        # counted so on the sparse path too, as the JAX bench counts it
        res["executed_cheb_orders"] = 3
        res["edges_per_s"] = batch * 3 * n_nodes * n_nodes * 2 / step_time
        res["edges_per_s_raw4"] = batch * 4 * n_nodes * n_nodes * 2 / step_time
        res["loss"] = last["loss"]
        res["sparse_k"] = sparse_k
        res["warmup_s"] = warmup_s  # the warm chunks, the first with its capture
        res["spectral_bwd"] = "reread" if cuda_spectral.SAVE_ACTS_BWD else "recompute"
        res["mfu"] = mfu_fn(cfg, batch, step_time, card_info(dev)["device"])
        res.update(card_info(dev))
        return res


def measure_eval(batch=32, steps=128, warmup=None, n_nodes=140, window=12, horizon=3,
                 multi=5, seed=0, chunk_steps=None, repeats=3, max_extra_repeats=2,
                 spread_warn=0.15, device="cuda", chunked=True, compute_dtype="float32",
                 sparse_k=None, gru_hidden=None, gru_segment=0, force_sparse_shard=False):
    """Forward-only throughput through the engine's batched eval program
    (`make_eval_epoch_fn`, what validate and test run), by `measure`'s method,
    at `compute_dtype`. With `chunked` False the same batches go one by one
    through the eager `make_eval_step`, the yardstick `--mode eval` reports a
    ratio to."""
    dev = resolve_device(device)
    with _mesh_of(force_sparse_shard, dev) as mesh:
        cfg = StemGNNConfig(units=n_nodes, window_size=window, horizon=horizon,
                            multi_layer=multi, sparse_k=sparse_k, gru_hidden=gru_hidden,
                            gru_segment=gru_segment, force_sparse_shard=mesh is not None)
        params = init_params(seed, cfg, device=dev)
        if chunked:
            eval_epoch = make_eval_epoch_fn(cfg, dev, compute_dtype, mesh=mesh)
        else:
            eval_step = make_eval_step(cfg, dev, compute_dtype, mesh=mesh)

            def eval_epoch(params, data, hi_matrix):
                for hi in hi_matrix:
                    f = eval_step(params, gather_windows(data, hi, window, horizon)[0])
                return f[None], None

        chunk, n_chunks, steps, n_warm, repeats, max_reps = _plan(
            steps, warmup, chunk_steps, repeats, max_extra_repeats)
        data, his = _inputs(seed, n_nodes, window, horizon, chunk, batch,
                            n_warm + max_reps * n_chunks, dev)

        def run(first, count):
            for i in range(first, first + count):
                fs, _ = eval_epoch(params, data, his[i])
            _sync(dev)
            return float(fs[-1, -1, 0, 0])  # a value read closes the window

        run(0, n_warm)
        times = _timed_repeats(lambda rep: run(n_warm + rep * n_chunks, n_chunks), steps,
                               repeats, max_reps, spread_warn)
        res = _summary(times, batch, chunk, spread_warn)
        res.update(card_info(dev))
        return res


@contextlib.contextmanager
def _mesh_of(force_sparse_shard: bool, dev):
    """A (1, 1) mesh of a process group of this process alone where
    `force_sparse_shard` (the group is ended after the block), else None."""
    if not force_sparse_shard:
        yield None
        return
    with world_of_one(dev):
        yield make_mesh(1, 1)


def _round(res, keys, digits=3):
    return {k: round(res[k], digits) for k in keys}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stemgnn_tpu_torch.bench")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=16,
                    help="warm-up steps (rounded UP to whole chunks)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats; the median is the number of record")
    ap.add_argument("--batch", type=int, default=None,
                    help="windows a step (default 32, or the --config row's)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default=None,
                    help="a row of the JAX suite's LARGE_CONFIGS in place of the ECG "
                         "flagship")
    ap.add_argument("--mode", choices=["train", "eval"], default="train",
                    help="eval: the forward-only eval program, with its ratio to "
                         "the eager per-batch eval loop of the same run as "
                         "vs_baseline")
    ap.add_argument("--spectral-bwd", choices=["reread", "recompute"], default=None,
                    help="train with the spectral cell's saving forward and reread "
                         "backward, or with its recompute backward (default: as "
                         "ops.cuda_spectral.SAVE_ACTS_BWD is set)")
    ap.add_argument("--bf16", action="store_true",
                    help="compute_dtype bfloat16: the graph conv's and spectral "
                         "kernels' bf16 arms (vs_baseline stays against the float32 "
                         "baseline)")
    ap.add_argument("--set-baseline", action="store_true",
                    help="write the measured train value as the frozen baseline "
                         "(float32 only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.bf16 and args.set_baseline:
        ap.error("the baseline is float32: --set-baseline does not take --bf16")
    if args.config and args.set_baseline:
        ap.error("the baseline is the ECG flagship's: --set-baseline does not take --config")
    precision = "bfloat16" if args.bf16 else "float32"
    common = config_kwargs(args.config) if args.config else {"batch": 32}
    if args.batch is not None:
        common["batch"] = args.batch
    common.update(steps=args.steps, warmup=args.warmup, repeats=args.repeats,
                  device=args.device, compute_dtype=precision)

    if args.mode == "eval":
        res = measure_eval(**common)
        ref = measure_eval(chunked=False, **common)
        print(json.dumps({
            "metric": "eval_windows_per_sec",
            "value": round(res["windows_per_s"], 2),
            "unit": "windows/s",
            "vs_baseline": round(res["windows_per_s"] / ref["windows_per_s"], 4),
            "extras": {
                **_round(res, ("step_time_ms", "step_time_ms_min", "step_time_ms_max")),
                "spread": round(res["spread"], 4),
                "repeats": res["repeats"],
                "chunk_steps": res["chunk_steps"],
                "eager_windows_per_s": round(ref["windows_per_s"], 2),
                "eager_spread": round(ref["spread"], 4),
                "device": res["device"],
                "power_limit": res["power_limit"],
                "precision": precision,
                "config": args.config or "ECG",
                "method": "chunked64-median",
                "baseline_method": "same-run eager per-batch eval",
            },
        }))
        return

    saved = cuda_spectral.SAVE_ACTS_BWD
    if args.spectral_bwd is not None:
        cuda_spectral.SAVE_ACTS_BWD = args.spectral_bwd == "reread"
    try:
        res = measure(**common)
    finally:
        cuda_spectral.SAVE_ACTS_BWD = saved

    if args.set_baseline:
        with open(BASELINE_PATH, "w") as f:
            json.dump({
                "windows_per_s": res["windows_per_s"],
                "step_time_ms": res["step_time_ms"],
                "spread": res["spread"],
                "repeats": res["repeats"],
                "batch": common["batch"],
                "device": res["device"],
                "power_limit": res["power_limit"],
                "spectral_bwd": res["spectral_bwd"],
                "method": "chunked64-median",
                "note": "python -m stemgnn_tpu_torch.bench --set-baseline: ECG "
                        "flagship train step, float32, through make_epoch_fn",
            }, f, indent=2)
            f.write("\n")
    baseline = None
    if os.path.exists(BASELINE_PATH) and not args.config:
        with open(BASELINE_PATH) as f:
            baseline = json.load(f)

    mfu = res["mfu"]
    print(json.dumps({
        "metric": "train_windows_per_sec",
        "value": round(res["windows_per_s"], 2),
        "unit": "windows/s",
        "vs_baseline": (round(res["windows_per_s"] / baseline["windows_per_s"], 4)
                        if baseline else None),
        "extras": {
            **_round(res, ("step_time_ms", "step_time_ms_min", "step_time_ms_max")),
            "repeats": res["repeats"],
            "spread": round(res["spread"], 4),
            "chunk_steps": res["chunk_steps"],
            "edges_per_s": round(res["edges_per_s"]),
            "edges_per_s_raw4": round(res["edges_per_s_raw4"]),
            "loss": res["loss"],
            "device": res["device"],
            "power_limit": res["power_limit"],
            "precision": precision,
            "config": args.config or "ECG",
            "sparse_k": res.get("sparse_k"),
            "spectral_bwd": res["spectral_bwd"],
            "method": "chunked64-median",
            "baseline_precision": "float32" if baseline else None,
            "baseline_device": baseline["device"] if baseline else None,
            "baseline_power_limit": baseline["power_limit"] if baseline else None,
            "model_flops_per_step": mfu["model_flops_per_step"],
            "achieved_tflops": round(mfu["achieved_tflops"], 3),
            "mfu_vs_bf16_peak": (round(mfu["mfu_vs_bf16_peak"], 5)
                                 if "mfu_vs_bf16_peak" in mfu else None),
            "mfu_vs_f32_peak": (round(mfu["mfu_vs_f32_peak"], 5)
                                if "mfu_vs_f32_peak" in mfu else None),
        },
    }))


if __name__ == "__main__":
    main()
