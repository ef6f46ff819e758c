"""A copy of the benchmark's files in a temporary root with two tiny cells
added (`tiny.train`, `tiny.forecast`: 10 nodes, batch 4), as a later change
adds a cell: new files and new entries in BENCHMARK.json, nothing edited."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the tiny cells' limits: the CPU's plain paths agree with the reference to
# about 1e-7 at this size (float32 sums in another order)
LIMITS = {"tiny.train": {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5,
                         "gru_grad_gap": 1e-4, "gru_change_gap": 1e-4,
                         "attention_grad_gap": 1e-4, "attention_change_gap": 1e-4},
          "tiny.forecast": {"forecast_gap": 1e-5}}


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "ecg.json").read_text())
    cfg.update(name="tiny", units=10, batch_size=4, reduced=["units", "batch_size"])
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny-train.json").write_text(json.dumps(
        {"kind": "train", "series_rows": 120, "chunk_steps": 4, "pool_dispatches": 3,
         "warm_dispatches": 1, "trace_dispatches": 1, "single_steps": 3,
         "followed_chunk_steps": 2}))
    (pb / "traffic" / "tiny-forecast.json").write_text(json.dumps(
        {"kind": "forecast", "series_rows": 40, "pool_series": 2, "warm_calls": 1,
         "trace_calls": 1, "checked_calls": 3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test's", "why": "a test's",
                             "file": "portbench/configs/tiny.json", "reduced": ["units"]})
    for kind, traffic in (("train", "tiny-train"), ("forecast", "tiny-forecast")):
        name = f"tiny.{kind}"
        (pb / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": traffic, "limits": LIMITS[name]}))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "a test's"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) for w in m["workloads"]):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
