"""Checks that need an NVIDIA card (marker `cuda`; they skip without one):

- the control of every cell, at the cell's own size: the reference computed
  with TF32 products put in the program's place fails the cell's check;
- a traced run of the tiny cells: the profile's kernels held to CUDA graphs
  of the same steps, every per-layer metric read, shares within 100%.

    python3 -m pytest portbench/tests -m cuda
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.reference.stemgnn import precision
from portbench.tests.tiny import make_root

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name):
    cell = harness.cell_of(name, 2**31 + 101, card)
    given = cell.driver.given_inputs(cell)
    kept = SimpleNamespace(given=given, judged=[(i, None) for i in
                                                range(len(getattr(given, "raws", [])))])
    with precision(tf32=False):
        truth = cell.driver.reference(cell, kept)
    with precision(tf32=True):
        placed = cell.driver.reference(cell, kept)
    if isinstance(placed, dict):
        placed = sorted(placed.items())
    numbers = cell.driver.compare(given, placed, truth)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny.train", "tiny.forecast"])
def test_a_traced_run(card, tmp_path, name):
    res = harness.run_cell(name, 2**31 + 7, 1.0, True, device=card,
                           root=make_root(tmp_path))
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    for metric, v in res["metrics"].items():
        if metric.endswith(("_roofline.train", "_roofline.forecast")) or "mfu" in metric:
            assert 0 < v["value"] <= 100, metric
