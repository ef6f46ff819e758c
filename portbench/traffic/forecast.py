"""Forecasting traffic: the port's batched forecast over a whole series, as
`validate`, `test` and `--train False` run it.

Parameters (`traffic/<name>.json`, kind "forecast"): `series_rows` of each
seeded series; `pool_series`, the series drawn in set-up (each normalized
by the program's `WindowDataset`), which the calls cycle through;
`warm_calls`; `trace_calls`, the stretch a traced run profiles;
`checked_calls`, how many of the window's calls the check compares, drawn
from the seed.

A call is `inference_batched(make_eval_step(...), params, dataset, batch,
eval_epoch_fn=make_eval_epoch_fn(...))`: every window of the series, the
full batches as one CUDA graph and the short last batch eagerly, the
forecasts copied back and converted to float64. One client calls in a
closed loop; a call's latency runs from the call to its forecasts in host
memory.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import inputs
from portbench.reference import stemgnn as ref
from portbench.traffic.train import model_config


def given_inputs(cell) -> SimpleNamespace:
    """What the benchmark hands both sides: the raw series and the weights."""
    cfg, tr, seed = cell.cfg, cell.traffic, cell.seed
    raws = [inputs.series(cfg, tr["series_rows"], seed, i) for i in range(tr["pool_series"])]
    return SimpleNamespace(raws=raws, weights=inputs.weights(cfg, seed, cell.device))


def setup(cell):
    from stemgnn_tpu_torch.data.pipeline import WindowDataset
    from stemgnn_tpu_torch.models.convert import unflatten_params
    from stemgnn_tpu_torch.train.engine import make_eval_epoch_fn, make_eval_step

    cfg, tr, dev, seed = cell.cfg, cell.traffic, cell.device, cell.seed
    w, h = cfg["window_size"], cfg["horizon"]
    given = given_inputs(cell)
    cell.mark("inputs made")
    raws = given.raws
    mcfg = model_config(cfg)
    datasets = [WindowDataset(raw, w, h, normalize_method=cfg["norm_method"])
                for raw in raws]
    st = SimpleNamespace(
        cell=cell, given=given, mcfg=mcfg, datasets=datasets,
        params=unflatten_params({k: v.clone() for k, v in given.weights.items()}),
        eval_step=make_eval_step(mcfg, dev, cfg["compute_dtype"]),
        eval_epoch_fn=make_eval_epoch_fn(mcfg, dev, cfg["compute_dtype"]),
        next=0, sample=[], rng=np.random.default_rng(inputs.sub_seed(seed, inputs.SAMPLE)))
    cell.mark("program built")
    for i in range(tr["warm_calls"]):
        call(st)
        cell.mark(f"warm call {i + 1}")
    return st


def call(st):
    """One forecast of the next series: (series index, forecasts)."""
    from stemgnn_tpu_torch.train.engine import inference_batched

    i = st.next % len(st.datasets)
    st.next += 1
    with torch.profiler.record_function("portbench.forecast.call"):
        f, _ = inference_batched(st.eval_step, st.params, st.datasets[i],
                                 st.cell.cfg["batch_size"], st.cell.device,
                                 eval_epoch_fn=st.eval_epoch_fn)
    return i, f


def window(st, seconds: float, profile=None):
    """Call for `seconds`; with `profile`, the first `trace_calls` calls are
    traced. Keeps a sample of `checked_calls` calls, drawn from the seed."""
    tr = st.cell.traffic
    k = tr["checked_calls"]
    latencies, done, failed = [], 0, 0

    def one():
        nonlocal done, failed
        t = time.perf_counter()
        i, f = call(st)
        latencies.append(time.perf_counter() - t)
        if not np.isfinite(f.sum()):
            failed += 1
        n = len(latencies) - 1
        if n < k:
            st.sample.append((i, f))
        else:
            j = int(st.rng.integers(0, n + 1))
            if j < k:
                st.sample[j] = (i, f)
        done += f.shape[0]

    def stretch():
        for _ in range(tr["trace_calls"]):
            one()

    st.stretch, st.trace = stretch, None
    t0 = time.perf_counter()
    if profile is not None:
        st.trace = profile(stretch)
    while time.perf_counter() - t0 < seconds:
        one()
    elapsed = time.perf_counter() - t0
    print(f"portbench: forecast_p95_ms over {len(latencies)} calls", file=sys.stderr)
    return {"attempted": len(latencies), "failed": failed, "seconds": elapsed,
            "forecast_windows_per_s": done / elapsed,
            "forecast_p95_ms": 1e3 * float(np.percentile(latencies, 95))}


def _batches(rows: int, w: int, h: int, b: int) -> list:
    """Sizes of the batches of a call over a series of `rows` rows."""
    n = rows - h + 1 - w
    return [b] * (n // b) + ([n % b] if n % b else [])


def stretch_units(st, trace) -> None:
    """Fill in what one unit of the traced stretch is: a forecast batch."""
    cfg, tr = st.cell.cfg, st.cell.traffic
    per_call = _batches(tr["series_rows"], cfg["window_size"], cfg["horizon"],
                        cfg["batch_size"])
    trace.batches = per_call * tr["trace_calls"]
    trace.units = len(trace.batches)


def step_kernels(st, kernels_of_graph):
    """The kernels of the traced stretch's calls, by the nodes of CUDA graphs
    that capture one forecast of a full batch and one of the short batch
    (the program's `make_eval_step`), multiplied out; None where a graph
    cannot be read."""
    from collections import Counter

    from stemgnn_tpu_torch.train.engine import gather_windows

    from portbench.trace import base_name

    cfg, tr = st.cell.cfg, st.cell.traffic
    ds = st.datasets[0]
    data = torch.from_numpy(ds.data).to(st.cell.device)
    ends = torch.from_numpy(ds.x_end_idx.astype(np.int64)).to(st.cell.device)
    total = Counter()
    sizes = Counter(_batches(tr["series_rows"], cfg["window_size"], cfg["horizon"],
                             cfg["batch_size"]))
    for b, count in sizes.items():
        x, _ = gather_windows(data, ends[:b], cfg["window_size"], cfg["horizon"])
        st.eval_step(st.params, x)
        torch.cuda.synchronize()
        names = kernels_of_graph(lambda: st.eval_step(st.params, x))
        if names is None:
            return None
        for name, n in Counter(map(base_name, names)).items():
            total[name] += n * count * tr["trace_calls"]
    return total


def free(st) -> SimpleNamespace:
    """Drop the program's state; return what the check needs."""
    kept = SimpleNamespace(given=st.given, judged=st.sample)
    st.__dict__.clear()
    return kept


def reference(cell, kept, fault=None):
    """The plain reference's forecasts {series index: [windows, horizon, N]}
    of the series the checked calls forecast. `fault`:
    `reference.stemgnn.forecast`."""
    cfg, dev, given = cell.cfg, cell.device, kept.given
    w, h, b = cfg["window_size"], cfg["horizon"], cfg["batch_size"]
    model = ref.StemGNN(cfg, given.weights, dev)
    out = {}
    for i in sorted({i for i, _ in kept.judged}):
        raw = given.raws[i]
        data = torch.from_numpy(ref.normalize(raw)).to(dev)
        ends = np.arange(w, raw.shape[0] - h + 1)
        batches = [torch.from_numpy(ends[j:j + b]) for j in range(0, len(ends), b)]
        out[i] = ref.forecast(model, data, batches, fault)
    return out


def compare(given, judged, truth) -> dict:
    """forecast_gap: over the checked calls' forecasts, the largest
    |forecast - reference| against the largest |reference| of that series."""
    gap = 0.0
    for i, f in judged:
        r = truth[i]
        if f.shape != r.shape or not np.isfinite(f).all():
            return {"forecast_gap": float("inf")}
        gap = max(gap, float(np.abs(f - r).max() / np.abs(r).max()))
    return {"forecast_gap": gap}
