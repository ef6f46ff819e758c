"""The benchmark's run of one cell, driven by data.

Everything that belongs to one cell, configuration, traffic mix, traffic
kind, per-layer metric or kernel family is a file of its own, found by the
name `BENCHMARK.json` gives it:

- the cell: `portbench/workloads/<cell>.json` (its config, its traffic and
  the limits of its check);
- its configuration: the file `BENCHMARK.json` names (`configs/<name>.json`);
- its traffic mix: `portbench/traffic/<traffic>.json`, which names its kind;
- the kind's driver: `portbench/traffic/<kind>.py`;
- each per-layer metric's reader: `portbench/metrics/<metric>.py`, or for
  a metric `<family>.<kind>` with no file of its own, `metrics/<family>.py`;
- each kernel family: `portbench/kernels/<family>.py`.

A run: set-up (the driver's, from process start to the first timed step:
`setup_s`), the window (the driver's; with a trace, a profiled stretch of
it, whose kernels are held to the nodes of a CUDA graph of the same step),
the peak device memory, then the program's state freed and the plain
reference run on the same inputs, the comparison, and one JSON line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import flops, graphnodes, trace as tracing
from portbench.reference.stemgnn import precision

ROOT = Path(__file__).resolve().parents[1]
# top-level modules the process that prints a result may not hold
FENCED = ("jax", "jaxlib", "flax", "stemgnn_tpu")


def load_module(path: Path):
    """The module in the file `path` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + re.sub(r"\W", "_", str(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The reader of per-layer metric `name`: `metrics/<name>.py`, else that
    of its family, the part of the name before the first dot."""
    metrics = root / "portbench" / "metrics"
    own = metrics / f"{name}.py"
    return load_module(own if own.exists() else metrics / f"{name.split('.')[0]}.py")


def families(root: Path = ROOT) -> dict:
    """{name: module} of every kernel family file."""
    return {p.stem: load_module(p) for p in sorted((root / "portbench" / "kernels").glob("*.py"))
            if p.stem != "__init__"}


def cell_of(name: str, seed: int, device, root: Path = ROOT) -> SimpleNamespace:
    """Everything a run of cell `name` reads, from `root`'s BENCHMARK.json and
    the files it names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    own = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    if (own["config"], own["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"portbench: workloads/{name}.json names {own['config']}, "
                         f"{own['traffic']}; BENCHMARK.json {entry['config']}, "
                         f"{entry['traffic']}")
    traffic = json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(
        name=name, seed=seed, device=torch.device(device), chips=entry["chips"],
        cfg=json.loads((root / config["file"]).read_text()), traffic=traffic,
        limits=own["limits"],
        driver=load_module(root / "portbench" / "traffic" / f"{traffic['kind']}.py"),
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
        readers={m["name"]: reader(m["name"], root) for m in mine(bench["per_layer"])},
        families=families(root), mark=lambda label: None)


def card_lines(device) -> None:
    """The card's name, power limit and draw, SM clock and temperature, by
    nvidia-smi, and the peak device memory so far, on standard error."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        line = smi.stdout.strip() or f"not measured ({smi.stderr.strip()[:200]})"
    except (OSError, subprocess.SubprocessError) as exc:
        line = f"not measured ({exc})"
    print(f"portbench: card (name, power limit, draw, SM clock, max SM clock, "
          f"temperature): {line}", file=sys.stderr)
    print(f"portbench: set-up peak device memory {torch.cuda.max_memory_allocated(device)} "
          "bytes", file=sys.stderr)


def check_kernels(cell, st, trace) -> tracing.Trace:
    """Hold the port's kernels in the traced stretch to those of CUDA graphs
    of the same steps (`graphnodes.kernels_of_graph`); where the profiler
    lost events, profile the stretch again; raise if it loses them again."""
    patterns = [fam.KERNELS for fam in cell.families.values()]
    expected = cell.driver.step_kernels(st, graphnodes.kernels_of_graph)
    if expected is None:
        raise RuntimeError("the kernels of a CUDA graph of a step cannot be read")
    expected = Counter({k: v for k, v in expected.items()
                        if any(re.fullmatch(p, k) for p in patterns)})
    for attempt in range(2):
        got = trace.count(patterns)
        if got == expected:
            return trace
        print(f"portbench: the profile names {dict(got)} of the port's kernels; CUDA graphs "
              f"of the same steps {dict(expected)}", file=sys.stderr)
        if attempt == 0:
            trace = tracing.profile(st.stretch)
            cell.driver.stretch_units(st, trace)
    raise RuntimeError("the profiler lost kernels of the traced stretch twice")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Path = ROOT, t_start: float | None = None) -> dict:
    """Run cell `name` and return its result line (a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell_of(name, seed, device, root)
    cell.mark = lambda label: print(f"portbench: set-up: {label} at "
                                    f"{time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    cell.mark("the cell's files read")
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)
    st = cell.driver.setup(cell)
    if on_card:
        card_lines(cell.device)
    setup_s = time.perf_counter() - t_start
    counts = cell.driver.window(st, seconds, tracing.profile if trace else None)
    memory_peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    metrics, dev = {}, {}
    if trace:
        traced = st.trace
        cell.driver.stretch_units(st, traced)
        traced = check_kernels(cell, st, traced)
        ctx = SimpleNamespace(trace=traced, cfg=cell.cfg, families=cell.families,
                              training=cell.traffic["kind"] == "train",
                              peak=flops.peak_flop_per_s(cell.cfg))
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": traced.busy_s(), "window_s": traced.window_s}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else counts[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kept = cell.driver.free(st)
    del st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with precision(tf32=False):
        truth = cell.driver.reference(cell, kept)
    numbers = cell.driver.compare(kept.given, kept.judged, truth)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = (counts["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))

    result = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": memory_peak, **dev}}
    if trace:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def fenced_modules() -> list:
    """The top-level names among FENCED that this process has imported."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FENCED))


def emit(result: dict) -> int:
    """Print the checks on standard error and the result line last on
    standard output; refuse (exit 3, no result) where a fenced module was
    imported."""
    found = fenced_modules()
    if found:
        print(f"portbench: the process imported {found}; no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"portbench: check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
