"""A whole run of the harness on the CPU at a tiny size (the look for a card
skipped): a cell added as data is found by name, the program's plain CPU
paths agree with the reference, and each fault a cell can have, planted in
the program under the timed path, turns `correct` false."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, name, seed=2**31 + 11):
    return harness.run_cell(name, seed, 0.5, False, device="cpu", root=root)


@pytest.mark.parametrize("name", ["tiny.train", "tiny.forecast"])
def test_a_new_cell_is_found_by_name(root, name):
    res = run(root, name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    kind = name.split(".")[1]
    want = {"setup_s"} | ({"train_windows_per_s"} if kind == "train" else
                          {"forecast_windows_per_s", "forecast_p95_ms"})
    assert set(res["metrics"]) == want


def test_reference_holds_the_ports_chunk(root):
    """The port's CPU path (the loop of eager steps) against the reference,
    entry by entry: the losses of the single steps and of the first chunk's
    followed steps, each leaf's first gradient norm as RMSprop got it, the
    parameters after the single steps."""
    cell = harness.cell_of("tiny.train", 5, "cpu", root)
    st = cell.driver.setup(cell)
    kept = cell.driver.free(st)
    truth = cell.driver.reference(cell, kept)
    assert len(truth.losses) == 3 + 2
    np.testing.assert_allclose(kept.judged.losses, truth.losses, rtol=1e-5)
    for k, p in truth.after.items():
        torch.testing.assert_close(kept.judged.after[k], p, rtol=1e-5, atol=1e-6)
        assert kept.judged.grads[k] == pytest.approx(truth.grads[k], rel=1e-4, abs=1e-12)
    still = {k for k in truth.after if torch.equal(truth.after[k], kept.given.weights[k])}
    # the one layer the loss does not reach
    assert still == {"blocks/1/backcast_short_cut/w", "blocks/1/backcast_short_cut/b"}
    assert {k for k, g in truth.grads.items() if g == 0} == still


def test_reference_holds_the_ports_forecasts(root):
    cell = harness.cell_of("tiny.forecast", 6, "cpu", root)
    st = cell.driver.setup(cell)
    cell.driver.window(st, 0.2)
    kept = cell.driver.free(st)
    truth = cell.driver.reference(cell, kept)
    assert kept.judged
    for i, f in kept.judged:
        np.testing.assert_allclose(f, truth[i], rtol=1e-5, atol=1e-6)


def _half(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from stemgnn_tpu_torch.train import engine

    whole = engine.gather_windows

    def half(data, hi, w, h):
        return whole(data, hi[: max(1, len(hi) // 2)], w, h)

    monkeypatch.setattr(engine, "gather_windows", half)


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer moves nothing."""
    monkeypatch.setattr(torch.optim.RMSprop, "step", lambda self, *a, **k: None)


def _altered_train(monkeypatch):
    """A loss altered where it is produced: each call's first, by 1%."""
    from stemgnn_tpu_torch.train import engine

    make = engine.make_epoch_fn

    def altered(*args, **kwargs):
        fn = make(*args, **kwargs)

        def epoch_fn(*a, **k):
            losses = fn(*a, **k).clone()
            losses[0] *= 1.01
            return losses
        return epoch_fn

    monkeypatch.setattr(engine, "make_epoch_fn", altered)


def _gru_backward(monkeypatch):
    """The GRU's backward returns zeros: its leaves get no gradient."""
    from stemgnn_tpu_torch.ops import cuda_gru

    monkeypatch.setattr(cuda_gru, "gru_scan_bwd",
                        lambda saved, g, a_all: g.new_zeros((saved.shape[0], saved.shape[2],
                                                             3 * saved.shape[3])))


def _attention_backward(monkeypatch):
    """The attention's backward returns zeros: the key, the query and the GRU
    that feeds them get no gradient."""
    from stemgnn_tpu_torch.ops import cuda_attention

    def zeros(ctx, g):
        key, query, _ = ctx.saved_tensors
        return torch.zeros_like(key), torch.zeros_like(query), None, None, None

    monkeypatch.setattr(cuda_attention._AttentionKQ, "backward", staticmethod(zeros))


def _altered_forecast(monkeypatch):
    """An answer altered where it is produced: one forecast by 1% of the
    largest."""
    from stemgnn_tpu_torch.train import engine

    whole = engine.inference_batched

    def altered(*args, **kwargs):
        f, y = whole(*args, **kwargs)
        f = f.copy()
        f[0, 0, 0] += 0.01 * np.abs(f).max()
        return f, y

    monkeypatch.setattr(engine, "inference_batched", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny.train", _unchanged), ("tiny.train", _half), ("tiny.train", _altered_train),
    ("tiny.train", _gru_backward), ("tiny.train", _attention_backward),
    ("tiny.forecast", _half), ("tiny.forecast", _altered_forecast)],
    ids=["train-unchanged", "train-half", "train-altered", "train-gru-backward",
         "train-attention-backward", "forecast-half", "forecast-altered"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    res = run(root, name)
    assert res["correct"] is False, res["checks"]
