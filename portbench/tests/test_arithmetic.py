"""The benchmark's copied arithmetic, pinned: FLOPs of a step, the spectral
entries' bytes and operations, and shares that never pass 100% for kernels
that run at their bound."""

import json
from pathlib import Path

import pytest

from portbench import flops
from portbench.kernels import gru, spectral
from portbench.trace import Trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_step_flops():
    assert flops.train_step_flops(config("ecg"), 32) / 1e9 == pytest.approx(32.01, abs=0.005)
    # the JAX suite's synthetic-1k row: the ECG widths at 1,024 nodes, batch 8
    s1k = dict(config("ecg"), units=1024)
    assert flops.train_step_flops(s1k, 8) / 1e9 == pytest.approx(228.9, abs=0.05)
    assert sum(flops.forward_flops(config("ecg"), 32).values()) / 1e9 == pytest.approx(10.67, abs=0.005)


def test_spectral_work_at_ecg():
    work = spectral.entry_work(32 * 140, 12, 5, bf16=False)
    assert work["fwd"][1] / 1e9 == pytest.approx(4.80, abs=0.005)
    # inputs, GLU weights and biases, output: 4 x (215,040 + 506,880 + 2,880 + 1,075,200)
    assert work["fwd"][0] == 7_200_000
    # plus the 12 saved arrays, [4,480, 240] each, f32
    assert work["fwd_save"][0] == 7_200_000 + 51_609_600
    assert work["bwd_reread"] == (61_708_800, 9_343_549_440)
    assert work["bwd"][0] == 10_099_200


def test_peaks():
    assert flops.peak_flop_per_s(config("ecg")) == 495e12
    assert flops.peak_flop_per_s({"compute_dtype": "bfloat16"}) == 989e12
    assert flops.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("units,batch", [(140, 32), (1026, 32)])
@pytest.mark.parametrize("training", [True, False])
def test_shares_at_the_bound_are_100(units, batch, training):
    """A stretch whose family kernels ran for exactly their bound reads
    100%, and no more; `step_mfu` of a step that ran at the peak reads 100%."""
    from portbench.harness import reader

    cfg = dict(config("ecg"), units=units)
    peak = flops.peak_flop_per_s(cfg)
    kind = "train" if training else "forecast"
    for fam, kernel in ((spectral, "spectral_chain_kernel"), (gru, "gru_fwd_grid_kernel")):
        least_us = fam.bound_s(cfg, [batch] * 3, training, peak) * 1e6
        trace = Trace(ops=[(kernel, 0.0, least_us)], kernels=[(kernel, 0.0, least_us)],
                      units=3, batches=[batch] * 3)
        ctx = type("Ctx", (), dict(trace=trace, cfg=cfg, peak=peak, training=training,
                                   families={"spectral": spectral, "gru": gru}))
        share = reader(f"{fam.__name__.split('.')[-1]}_roofline.{kind}").read(ctx)
        assert share == pytest.approx(100.0, rel=1e-12)
        assert share <= 100.0 + 1e-9
    work = (flops.train_step_flops(cfg, batch) if training
            else sum(flops.forward_flops(cfg, batch).values()))
    span_us = 3 * work / peak * 1e6
    trace = Trace(ops=[("k", 0.0, span_us)], kernels=[("k", 0.0, span_us)], units=3,
                  batches=[batch] * 3)
    ctx = type("Ctx", (), dict(trace=trace, cfg=cfg, peak=peak, training=training,
                               families={}))
    mfu = reader(f"step_mfu.{kind}").read(ctx)
    assert mfu == pytest.approx(100.0, rel=1e-12)
