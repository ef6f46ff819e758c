#!/usr/bin/env python3
"""Drive stemgnn_tpu_torch's serving path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. device: CUDA present; the card's name and power limit from nvidia-smi;
     TF32 off for every f32 comparison.
  2. build: nvcc of every kernel source in stemgnn_tpu_torch/csrc.
  3. kernels: each kernel at the ECG flagship shapes (N=140, W=12,
     multi_layer=5, batch 32), on inputs that the model's own plain path
     computes from the first test batch, held against its plain PyTorch
     version on the card; device times from CUDA events around replays of
     a captured CUDA graph of many calls, the least time the card could
     take (bytes or f32 operations at published H100 SXM peaks), and a
     one-call PyTorch yardstick where one exists.
  4. main path: ECG_data through the port's entry points on the card
     (split, train-split norm stats, init_params(0), checkpoint.save,
     engine.test), with the launch counters set to 0 just before and read
     just after; then the test-split forecasts against the port's CPU plain
     path, and eval windows/s.
  5. a `kernels` JSON line, then the result line.

It imports nothing of JAX or of stemgnn_tpu.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# ECG flagship: python main.py defaults on dataset/ECG_data.csv
BATCH, WINDOW, MULTI, HORIZON = 32, 12, 5, 3


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(params, mcfg, x):
    """(name, source, replaces, kernel call, plain call, library call or None,
    atol, rtol, bytes, flops) at the main path's shapes. The inputs are what
    the plain path computes from the batch x [B, W, N]."""
    import torch

    from stemgnn_tpu_torch.ops import cuda_attention, cuda_graph, cuda_gru
    from stemgnn_tpu_torch.ops import cuda_spectral, torch_impl

    b, w, n = x.shape
    h, k = n, 4
    wm = w * mcfg.multi_layer
    d0, d1 = k * w, k * wm
    rows = b * n
    gru = params["gru"]

    with torch.inference_mode():
        enc = torch_impl.gru_over_nodes(gru, x).transpose(1, 2)
        key = (enc @ params["weight_key"])[..., 0].contiguous()
        query = (enc @ params["weight_query"])[..., 0].contiguous()
        att = torch_impl.attention_from_kq(key, query, mcfg.leaky_rate)
        mul_L, _ = torch_impl.laplacian_from_attention(att)
        mul_L = mul_L.contiguous()
        feat = x.permute(0, 2, 1).contiguous()
        gfted = torch_impl.cheb_graph_conv(mul_L, feat).contiguous()
        glu = params["blocks"][0]["glu"]

    cudnn_gru = torch.nn.GRU(w, h).to(x.device).eval()
    with torch.no_grad():
        cudnn_gru.weight_ih_l0.copy_(gru["w_ih"])
        cudnn_gru.weight_hh_l0.copy_(gru["w_hh"])
        cudnn_gru.bias_ih_l0.copy_(gru["b_ih"])
        cudnn_gru.bias_hh_l0.copy_(gru["b_hh"])
    xs = x.permute(2, 0, 1).contiguous()  # [N, B, W], cuDNN's sequence-major input
    xt = feat.permute(1, 0, 2).reshape(n, b * w).contiguous()  # [N, B*W]
    lk = mul_L[1:].contiguous()

    glu_w = sum(p[s]["w"].numel() + p[s]["b"].numel() for p in glu
                for s in ("left", "right"))
    return [
        ("gru_fwd", "stemgnn_tpu_torch/csrc/gru.cu",
         "stemgnn_tpu/ops/pallas_gru.py:103",
         lambda: cuda_gru.gru_over_nodes(gru, x),
         lambda: cuda_gru.gru_over_nodes_plain(gru, x),
         lambda: cudnn_gru(xs)[0],
         # 140 dependent steps: sums reorder against cuBLAS in each step
         1e-4, 0.0,
         4 * (x.numel() + sum(t.numel() for t in gru.values()) + b * n * h),
         2 * n * b * w * 3 * h + 2 * n * b * h * 3 * h),
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
         # six GLUs, the inverse DFT and the fold, the two DFTs counted per
         # order block: their off-diagonal blocks are zeros
         2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm)
         + 8 * k * w * w * d1),
    ]


def run() -> int:
    import numpy as np
    import torch

    # --- 1. device ---
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
    from stemgnn_tpu_torch import ops
    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.data import (
        WindowDataset, compute_norm_stats, ensure_dataset, load_csv, split_by_ratio)
    from stemgnn_tpu_torch.models import init_params
    from stemgnn_tpu_torch.ops import _build
    from stemgnn_tpu_torch.train import checkpoint as ckpt
    from stemgnn_tpu_torch.train import engine

    # --- 2. build ---
    out_dir, secs = _build.build_all()
    print(f"[2 build] {len(list(_build.CSRC.glob('*.cu')))} sources -> {out_dir} "
          f"in {secs:.1f} s")

    # --- data and params of the main path ---
    cfg = TrainConfig(dataset="ECG_data", train=False, batch_size=BATCH,
                      window_size=WINDOW, horizon=HORIZON, multi_layer=MULTI,
                      device="cuda", data_dir=os.path.join(HERE, "dataset"),
                      output_dir=os.path.join(HERE, "output", "chip_smoke"))
    data = load_csv(ensure_dataset(cfg.dataset, cfg.data_dir))
    train_data, _, test_data = split_by_ratio(
        data, cfg.train_length, cfg.valid_length, cfg.test_length)
    mcfg = cfg.model_config(data.shape[1])
    stats = compute_norm_stats(train_data, cfg.norm_method)
    test_set = WindowDataset(test_data, cfg.window_size, cfg.horizon,
                             cfg.norm_method, stats)
    params = init_params(cfg.seed, mcfg, device=dev)

    # --- 3. kernels against their plain versions ---
    hi = torch.from_numpy(test_set.epoch_batches(BATCH, shuffle=False)[0]).long()
    x, _ = engine.gather_windows(torch.from_numpy(test_set.data).to(dev),
                                 hi.to(dev), cfg.window_size, cfg.horizon)
    results = {}
    for (name, source, replaces, kern, plain, lib, atol, rtol, nbytes,
         flops) in kernel_cases(params, mcfg, x):
        with torch.inference_mode():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got - want).abs().max().item()
            ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain)
            lib_ms = cuda_ms(lib) if lib is not None else None
            one_call_ms = call_ms(kern)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"[3 kernel] {name}: max_abs_err {err:.3e} (atol {atol:g}, "
              f"rtol {rtol:g}) {'ok' if ok else 'FAIL'}; kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}, "
              f"bound {bound_ms:.5f} ms ({bound_by}, {flops:.4e} op, "
              f"{nbytes:.4e} B); one eager call with its host work "
              f"{one_call_ms:.5f} ms")
        if not ok or not math.isfinite(err):
            return _fail(f"{name} disagrees with its plain version: {err}")
        results[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms)

    # --- 4. main path ---
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
    launches = ops.launches()
    print(f"[4 main path] engine.test: {len(test_set)} windows in {n_batches} "
          f"batches, {test_s:.3f} s; launches {launches}")
    want = {"gru_fwd": n_batches, "attention_kq_fwd": n_batches,
            "cheb_graph_conv_fwd": 2 * n_batches, "spectral_fwd": 2 * n_batches}
    if launches != want:
        return _fail(f"launch counts {launches}, expected {want}")
    for k in ("mae", "mape", "rmse"):
        if not math.isfinite(float(metrics[k])):
            return _fail(f"test {k} is {metrics[k]}")
    for f in ("target.csv", "predict.csv", "predict_abs_error.csv", "predict_ape.csv"):
        if not os.path.exists(os.path.join(test_dir, f)):
            return _fail(f"{f} not written")

    step = engine.make_eval_step(mcfg, dev)
    fc_gpu, tg_gpu = engine.inference_batched(step, params, test_set, BATCH, dev)
    params_cpu = ckpt.load(train_dir, device="cpu")[0]
    fc_cpu, tg_cpu = engine.inference_batched(
        engine.make_eval_step(mcfg, "cpu"), params_cpu, test_set, BATCH, "cpu")
    shape = (len(test_set), cfg.horizon, mcfg.units)
    if fc_gpu.shape != shape or not np.isfinite(fc_gpu).all():
        return _fail(f"forecasts {fc_gpu.shape}, expected {shape} and finite")
    fc_err = float(abs(fc_gpu - fc_cpu).max())
    print(f"[4 main path] test forecasts, card vs CPU plain path: max_abs_err "
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
    print(f"[4 main path] eval {wps:.1f} windows/s (median of 3 passes over the "
          f"test split, batch {BATCH}, after one warm pass)")

    # --- 5. summary ---
    for name, n in launches.items():
        results[name]["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
