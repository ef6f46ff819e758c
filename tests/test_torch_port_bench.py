"""The port's bench path on the CPU: the FLOP model, the chunked epoch and
eval programs, the chunked engine, the asynchronous checkpointer, the
sanitizer and profile modes and the bench itself, against the JAX package
where it has a counterpart.

On the CPU a chunk is the loop of eager steps (on the card it is a captured
CUDA graph, which chip_smoke.py holds bitwise against the eager steps)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.train import optim as jax_optim
from stemgnn_tpu.utils import flops as jax_flops
from stemgnn_tpu_torch import bench
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch.models.convert import (
    flatten_params,
    params_from_jax,
    unflatten_params,
)
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.train import optim as port_optim
from stemgnn_tpu_torch.utils import flops

torch.set_num_threads(1)

N, B, W, M = 10, 4, 12, 2
CFG = StemGNNConfig(units=N, window_size=W, horizon=3, multi_layer=M)
JCFG = JaxConfig(units=N, window_size=W, horizon=3, multi_layer=M)
TINY = dict(dataset="tiny", window_size=8, horizon=3, epoch=2, batch_size=16,
            multi_layer=2, validate_freq=1, lr=1e-3, device="cpu")


# --- (c) utils/flops.py ---


@pytest.mark.parametrize("kw,batch", [
    (dict(units=140, window_size=12, horizon=3, multi_layer=5), 32),
    (dict(units=358, window_size=12, horizon=12, multi_layer=5), 16),
    (dict(units=20, window_size=8, horizon=2, multi_layer=2, stack_cnt=2), 3),
], ids=["ecg_flagship", "pems03_width", "tiny"])
def test_flops_equal_the_jax_models(kw, batch):
    got = flops.forward_flops(StemGNNConfig(**kw), batch)
    want = jax_flops.forward_flops(JaxConfig(**kw), batch)
    assert got == want
    assert flops.train_step_flops(StemGNNConfig(**kw), batch) == \
        jax_flops.train_step_flops(JaxConfig(**kw), batch) == 3.0 * sum(want.values())


def test_mfu_fields_and_h100_peaks():
    cfg = StemGNNConfig(units=140, window_size=12, horizon=3, multi_layer=5)
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == {"bf16": 989.0, "f32": 67.0}
    assert flops.peak_tflops("cpu") is None and flops.peak_tflops("TPU v5 lite") is None
    out = flops.mfu(cfg, 32, 12e-3, "NVIDIA H100 80GB HBM3")
    assert out["model_flops_per_step"] == flops.train_step_flops(cfg, 32)
    np.testing.assert_allclose(out["achieved_tflops"],
                               out["model_flops_per_step"] / 12e-3 / 1e12)
    assert 0.0 < out["mfu_vs_bf16_peak"] < out["mfu_vs_f32_peak"] < 1.0
    np.testing.assert_allclose(out["mfu_vs_f32_peak"], out["achieved_tflops"] / 67.0)
    cpu = flops.mfu(cfg, 32, 1.0, "cpu")
    assert set(cpu) == {"model_flops_per_step", "achieved_tflops"}


# --- (d) make_epoch_fn ---


def _leaves(np_tree):
    flat = flatten_params(params_from_jax(np_tree, "cpu"))
    return {k: v.requires_grad_(True) for k, v in flat.items()}


@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
def test_chunk_is_bitwise_the_eager_steps(name):
    rng = np.random.default_rng(70)
    data = torch.from_numpy(rng.standard_normal((80, N)).astype(np.float32))
    hi_matrix = torch.from_numpy(rng.integers(W, 80 - 3, size=(5, B)))
    runs = {}
    for mode in ("eager", "chunk"):
        flat = {k: v.requires_grad_(True)
                for k, v in flatten_params(init_params(0, CFG, device="cpu")).items()}
        tree = unflatten_params(flat)
        opt = port_optim.make_optimizer(name, flat.values(), 1e-3)
        gen = torch.Generator().manual_seed(3)
        if mode == "eager":
            step = port_engine.make_train_step(CFG, opt, flat.values())
            losses = torch.stack([step(tree, data, hi, gen) for hi in hi_matrix])
        else:
            epoch_fn = port_engine.make_epoch_fn(CFG, opt, flat.values())
            losses = torch.cat([epoch_fn(tree, data, hi_matrix[:3], gen),
                                epoch_fn(tree, data, hi_matrix[3:], gen)])
        runs[mode] = (losses, flat)
    assert runs["chunk"][0].shape == (5,)
    assert torch.equal(runs["eager"][0], runs["chunk"][0])
    for k, v in runs["eager"][1].items():
        assert torch.equal(v, runs["chunk"][1][k]), k


def test_epoch_fn_refuses_other_params_and_missing_dropout_source():
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_params(init_params(0, CFG, device="cpu")).items()}
    opt = port_optim.make_optimizer("RMSProp", flat.values(), 1e-3)
    epoch_fn = port_engine.make_epoch_fn(CFG, opt, flat.values())
    data = torch.zeros((40, N))
    hi = torch.full((2, B), W)
    with pytest.raises(ValueError, match="not the tensors"):
        epoch_fn(init_params(0, CFG, device="cpu"), data, hi, torch.Generator())
    with pytest.raises(ValueError, match="dropout"):
        epoch_fn(unflatten_params(flat), data, hi)


def test_epoch_fn_losses_match_jax_epoch_fn_at_f64():
    """Converted parameters, the masks the JAX forward draws from its keys
    handed to the port, three RMSProp steps as one chunk on each side: f64,
    atol 1e-8 (an RMSProp step can magnify the gradients' 1e-10 agreement, as
    in the three-step trajectory test)."""
    rng = np.random.default_rng(71)
    n_steps, t_len, lr = 3, 60, 1e-3
    data = rng.standard_normal((t_len, N))
    his = rng.integers(W, t_len - 3, size=(n_steps, B))
    with jax.enable_x64():
        keys = jax.random.split(jax.random.PRNGKey(8), n_steps)
        masks = np.stack([np.asarray(jax.random.bernoulli(
            k, 1.0 - JCFG.dropout_rate, (B, N, N))) for k in keys])
        np_tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                               torch_stream_init(0, JCFG))
        jparams = jax.tree.map(jnp.asarray, np_tree)
        opt = jax_optim.make_optimizer("RMSProp", lr)
        jepoch = jax_engine.make_epoch_fn(JCFG, opt, use_pallas=False)
        jparams, _, want = jepoch(jparams, opt.init(jparams), jnp.asarray(data),
                                  jnp.asarray(his), keys)
        want = np.asarray(want)
        want_params = flatten_params(jax.tree.map(np.asarray, jparams))
    flat = _leaves(np_tree)
    topt = port_optim.make_optimizer("RMSProp", flat.values(), lr)
    epoch_fn = port_engine.make_epoch_fn(CFG, topt, flat.values())
    got = epoch_fn(unflatten_params(flat), torch.from_numpy(data), torch.from_numpy(his),
                   dropout_masks=torch.from_numpy(masks.copy()))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)
    for k, w_ in want_params.items():
        np.testing.assert_allclose(flat[k].detach().numpy(), w_, rtol=0, atol=1e-8,
                                   err_msg=k)


def test_eval_epoch_fn_is_the_eval_step_per_batch():
    rng = np.random.default_rng(72)
    params = init_params(0, CFG, device="cpu")
    data = torch.from_numpy(rng.standard_normal((50, N)).astype(np.float32))
    hi_matrix = torch.from_numpy(rng.integers(W, 47, size=(3, B)))
    fs, ys = port_engine.make_eval_epoch_fn(CFG, "cpu")(params, data, hi_matrix)
    assert fs.shape == ys.shape == (3, B, 3, N)
    step = port_engine.make_eval_step(CFG, "cpu")
    for i, hi in enumerate(hi_matrix):
        x, y = port_engine.gather_windows(data, hi, W, 3)
        assert torch.equal(fs[i], step(params, x)) and torch.equal(ys[i], y)


# --- (e) the engine with chunks, (f) the checkpointer, the modes ---


@pytest.fixture(scope="module")
def tiny_splits():
    data = jax_data.synthesize("tiny", T=220, N=6, seed=0)
    return jax_data.split_by_ratio(data, 7, 2, 1)


def _assert_same_checkpoint(a_dir, b_dir, epoch):
    a = ckpt.load(a_dir, epoch=epoch, device="cpu")
    b = ckpt.load(b_dir, epoch=epoch, device="cpu")
    for (k, u), v in zip(flatten_params(a[0]).items(), flatten_params(b[0]).values()):
        assert torch.equal(u, v), k
    assert a[1]["state"].keys() == b[1]["state"].keys()
    for i, st in a[1]["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b[1]["state"][i][key]))
    assert a[2] == b[2]


@pytest.mark.parametrize("chunk_sizes,want_calls", [((64, 16, 4), 4), ((3, 2), 6)],
                         ids=["engine_sizes", "small_sizes"])
def test_chunked_epochs_give_the_per_batch_loops_checkpoint(
        tiny_splits, tmp_path, monkeypatch, chunk_sizes, want_calls):
    """Two epochs of 9 full batches and a short one (dropout on): through
    chunks (greedy over the sizes, the rest eager) and through the per-batch
    loop (no chunk size at all). Same losses, same checkpoints, bit for bit."""
    train, valid, _ = tiny_splits
    cfg = TrainConfig(**dict(TINY, dropout_rate=0.5))
    calls = []
    make = port_engine.make_epoch_fn

    def counting_make(*args):
        epoch_fn = make(*args)

        def wrapped(params, data, hi_matrix, generator):
            calls.append(len(hi_matrix))
            return epoch_fn(params, data, hi_matrix, generator)
        return wrapped

    monkeypatch.setattr(port_engine, "make_epoch_fn", counting_make)
    loop_dir, chunk_dir = str(tmp_path / "loop"), str(tmp_path / "chunks")
    monkeypatch.setattr(port_engine, "CHUNK_SIZES", ())
    port_engine.train(train, valid, cfg, loop_dir)
    assert calls == []
    monkeypatch.setattr(port_engine, "CHUNK_SIZES", chunk_sizes)
    port_engine.train(train, valid, cfg, chunk_dir)
    assert len(calls) == want_calls and set(calls) <= set(chunk_sizes)
    for epoch in (0, 1):
        _assert_same_checkpoint(loop_dir, chunk_dir, epoch)

    def losses(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    for a, b in zip(losses(loop_dir), losses(chunk_dir)):
        if a["event"] == "epoch":
            assert a["loss"] == b["loss"]
        else:
            a.pop("ts"), b.pop("ts")
            assert a == b


def test_async_checkpoint_equals_the_synchronous_one(tiny_splits, tmp_path):
    train, valid, _ = tiny_splits
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    port_engine.train(train, valid, TrainConfig(**dict(TINY, ckpt_async=False)), sync_dir)
    port_engine.train(train, valid, TrainConfig(**dict(TINY, ckpt_async=True)), async_dir)
    for epoch in (0, 1, None):
        _assert_same_checkpoint(sync_dir, async_dir, epoch)


def test_async_checkpointer_snapshots_at_submit_and_surfaces_worker_errors(tmp_path):
    params = init_params(0, CFG, device="cpu")
    flat = flatten_params(params)
    opt = port_optim.make_optimizer("RMSProp", [v.requires_grad_(True)
                                                for v in flat.values()], 1e-3)
    for p in flat.values():
        p.grad = torch.ones_like(p)
    opt.step()
    want = {k: v.detach().clone() for k, v in flat.items()}
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    ckpt.save(sync_dir, params, opt.state_dict(), epoch=3, meta={"epoch": 3})
    saver = ckpt.AsyncCheckpointer(max_pending=1)
    try:
        saver.submit(async_dir, params, opt.state_dict(), epoch=3, meta={"epoch": 3})
        with torch.no_grad():  # the next step, in place, while the write is queued
            for p in flat.values():
                p.add_(1.0)
        saver.wait()
        _assert_same_checkpoint(sync_dir, async_dir, 3)
        loaded = flatten_params(ckpt.load(async_dir, epoch=3, device="cpu")[0])
        assert all(torch.equal(loaded[k], want[k]) for k in want)

        blocker = tmp_path / "a_file"
        blocker.write_text("not a directory")
        saver.submit(str(blocker / "ckpts"), params, epoch=0)
        with pytest.raises(OSError):
            saver.wait()
        saver.submit(async_dir, params, epoch=4)  # the error was raised once
        saver.wait()
        assert ckpt.latest_epoch(async_dir) == 4
    finally:
        saver.close()
    assert not saver._thread.is_alive()


def test_debug_nans_raises_before_the_optimizer_moves(tiny_splits, tmp_path):
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_params(init_params(0, CFG, device="cpu")).items()}
    opt = port_optim.make_optimizer("RMSProp", flat.values(), 1e-3)
    step = port_engine.make_train_step(CFG, opt, flat.values(), check_finite=True)
    tree = unflatten_params(flat)
    before = {k: v.detach().clone() for k, v in flat.items()}
    data = torch.from_numpy(np.random.default_rng(73).standard_normal(
        (40, N)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(step(tree, data, torch.arange(W, W + B), gen))
    assert not torch.equal(flat["fc2/w"], before["fc2/w"])
    now = {k: v.detach().clone() for k, v in flat.items()}
    data[5, 3] = float("inf")
    with pytest.raises(FloatingPointError, match="not finite"):
        step(tree, data, torch.arange(W, W + B), gen)
    assert all(torch.equal(flat[k], now[k]) for k in flat)
    # the engine's mode: eager steps only, and a finite run goes through
    train, valid, _ = tiny_splits
    out = str(tmp_path / "out")
    port_engine.train(train, valid, TrainConfig(**dict(TINY, epoch=1, debug_nans=True)),
                      out)
    assert ckpt.latest_epoch(out) == 0 and not torch.is_anomaly_enabled()


def test_profile_writes_a_trace_of_the_second_epoch(tiny_splits, tmp_path):
    train, valid, _ = tiny_splits
    out = str(tmp_path / "out")
    port_engine.train(train, valid, TrainConfig(**dict(TINY, profile=True)), out)
    assert os.listdir(os.path.join(out, "profile")) == ["epoch_1.json"]
    with open(os.path.join(out, "profile", "epoch_1.json")) as f:
        assert json.load(f)["traceEvents"]


def test_new_flags_keep_the_jax_names_and_defaults():
    from stemgnn_tpu.config import TrainConfig as JaxTrainConfig

    for name in ("ckpt_async", "profile", "debug_nans"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name), name


# --- (g) the bench ---


def test_measure_on_the_cpu_returns_the_documented_keys():
    res = bench.measure(batch=2, steps=4, n_nodes=N, multi=M, chunk_steps=2, repeats=3,
                        max_extra_repeats=0, device="cpu")
    assert set(res) == {
        "windows_per_s", "step_time_ms", "step_time_ms_min", "step_time_ms_max",
        "repeats", "spread", "chunk_steps", "executed_cheb_orders", "edges_per_s",
        "edges_per_s_raw4", "loss", "sparse_k", "warmup_s", "spectral_bwd", "mfu",
        "device", "power_limit"}
    assert res["repeats"] == 3 and res["chunk_steps"] == 2 and res["sparse_k"] is None
    assert np.isfinite(res["loss"])
    assert res["step_time_ms_min"] <= res["step_time_ms"] <= res["step_time_ms_max"]
    np.testing.assert_allclose(res["windows_per_s"], 2 / (res["step_time_ms"] / 1e3))
    assert res["device"] == "cpu" and res["power_limit"] is None
    assert set(res["mfu"]) == {"model_flops_per_step", "achieved_tflops"}


@pytest.mark.parametrize("chunked", [True, False], ids=["program", "eager_loop"])
def test_measure_eval_on_the_cpu(chunked):
    res = bench.measure_eval(batch=2, steps=4, n_nodes=N, multi=M, chunk_steps=2,
                             repeats=3, max_extra_repeats=0, device="cpu",
                             chunked=chunked)
    assert res["repeats"] == 3 and res["windows_per_s"] > 0 and res["device"] == "cpu"


def test_extra_repeats_run_only_while_the_spread_is_wide():
    got = bench._timed_repeats(lambda rep: None, 1, 3, 5, spread_warn=-1.0)
    assert len(got) == 5  # spread always above the limit: all extra repeats
    got = bench._timed_repeats(lambda rep: None, 1, 3, 5, spread_warn=1e9)
    assert len(got) == 3


def test_main_prints_one_json_line_and_keeps_its_own_baseline(monkeypatch, tmp_path,
                                                              capsys):
    canned = {"windows_per_s": 2000.0, "step_time_ms": 16.0, "step_time_ms_min": 15.9,
              "step_time_ms_max": 16.2, "repeats": 3, "spread": 0.01875,
              "chunk_steps": 64, "executed_cheb_orders": 3, "edges_per_s": 1e8,
              "edges_per_s_raw4": 1.3e8, "loss": 0.9, "spectral_bwd": "reread",
              "mfu": flops.mfu(StemGNNConfig(units=140), 32, 16e-3,
                               "NVIDIA H100 80GB HBM3"),
              "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    seen = {}

    def fake_measure(**kw):
        from stemgnn_tpu_torch.ops import cuda_spectral
        seen.update(kw, switch=cuda_spectral.SAVE_ACTS_BWD)
        return dict(canned)

    baseline = tmp_path / "bench_baseline.json"
    monkeypatch.setattr(bench, "measure", fake_measure)
    monkeypatch.setattr(bench, "BASELINE_PATH", str(baseline))
    bench.main(["--steps", "64", "--spectral-bwd", "recompute"])
    line = json.loads(capsys.readouterr().out.strip())
    assert seen["switch"] is False and seen["steps"] == 64 and seen["device"] == "cuda"
    assert line["metric"] == "train_windows_per_sec" and line["value"] == 2000.0
    assert line["vs_baseline"] is None and not baseline.exists()
    for key in ("step_time_ms", "spread", "repeats", "device", "power_limit",
                "model_flops_per_step", "mfu_vs_bf16_peak", "mfu_vs_f32_peak",
                "chunk_steps", "method"):
        assert key in line["extras"], key
    bench.main(["--set-baseline"])
    capsys.readouterr()
    blob = json.loads(baseline.read_text())
    assert blob["device"] == "NVIDIA H100 80GB HBM3" and blob["power_limit"] == "700.00 W"
    canned["windows_per_s"] = 2500.0
    bench.main([])
    line = json.loads(capsys.readouterr().out.strip())
    assert line["vs_baseline"] == 1.25
    assert line["extras"]["baseline_device"] == "NVIDIA H100 80GB HBM3"
