"""The port's optimizers, training engine, resume and CLI against the JAX
package (CPU)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.config import TrainConfig as JaxTrainConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.train import optim as jax_optim
from stemgnn_tpu_torch.__main__ import main as port_main
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig
from stemgnn_tpu_torch.models import forward, init_params
from stemgnn_tpu_torch.models.convert import (
    flatten_params,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.train import optim as port_optim

torch.set_num_threads(1)

N, B, W, M = 10, 4, 12, 2
CFG = StemGNNConfig(units=N, window_size=W, horizon=3, multi_layer=M)
JCFG = JaxConfig(units=N, window_size=W, horizon=3, multi_layer=M)
TINY = dict(dataset="tiny", window_size=8, horizon=3, epoch=2, batch_size=16,
            multi_layer=2, validate_freq=1, lr=1e-3)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), tree)


def _leaf_params(np_tree):
    flat = flatten_params(params_from_jax(np_tree, "cpu"))
    return {k: v.requires_grad_(True) for k, v in flat.items()}


def _jax_moments(name, state):
    """The numpy moments of an optax state from stemgnn_tpu.train.optim."""
    inner = state.inner_state
    if name == "RMSProp":
        return {"nu": jax.tree.map(np.asarray, inner["nu"])}
    adam = inner[0]
    return {"mu": jax.tree.map(np.asarray, adam.mu),
            "nu": jax.tree.map(np.asarray, adam.nu), "count": int(adam.count)}


@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
def test_three_step_trajectory_matches_jax_optimizer_at_f64(name):
    """Both sides start from one state (a JAX step, carried over by the
    converters), take three steps on their own gradients, and must agree in
    parameters and optimizer moments. The dropout masks are drawn as the JAX
    forward draws them from its keys and handed to the port."""
    from stemgnn_tpu_torch.models.convert import unflatten_params

    rng = np.random.default_rng(50)
    xs = rng.standard_normal((4, B, W, N))
    ys = rng.standard_normal((4, B, 3, N))
    lr = 1e-3
    with jax.enable_x64():
        keys = jax.random.split(jax.random.PRNGKey(6), 4)
        masks = np.stack([np.asarray(jax.random.bernoulli(
            k, 1.0 - JCFG.dropout_rate, (B, N, N))) for k in keys])
        jparams = jax.tree.map(jnp.asarray, _cast(torch_stream_init(0, JCFG), np.float64))
        opt = jax_optim.make_optimizer(name, lr)
        state = opt.init(jparams)

        def jstep(p, s, i):
            def loss_fn(p):
                f, _ = jax_stemgnn.forward(p, JCFG, jnp.asarray(xs[i]), training=True,
                                           dropout_rng=keys[i])
                return jnp.mean((f - jnp.asarray(ys[i])) ** 2)

            grads = jax.grad(loss_fn)(p)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s

        jparams, state = jstep(jparams, state, 0)
        start_params = jax.tree.map(np.asarray, jparams)
        start_moments = _jax_moments(name, state)
        for i in (1, 2, 3):
            jparams, state = jstep(jparams, state, i)
        want_params = flatten_params(jax.tree.map(np.asarray, jparams))
        want_moments = _jax_moments(name, state)

    flat = _leaf_params(start_params)
    tree = unflatten_params(flat)
    topt = port_optim.make_optimizer(name, flat.values(), lr)
    opt_state_from_jax(start_moments, topt)
    for i in (1, 2, 3):
        topt.zero_grad(set_to_none=True)
        f, _ = forward(tree, CFG, torch.from_numpy(xs[i]), training=True,
                       dropout_mask=torch.from_numpy(masks[i].copy()))
        torch.mean((f - torch.from_numpy(ys[i])) ** 2).backward()
        for p in flat.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        topt.step()
    # f64: the gradients agree to 1e-10 or better; an RMSProp step divides by
    # sqrt(nu) + 1e-8, which can magnify that by up to lr / 1e-8 on an entry
    # whose gradient is near zero, hence 1e-8 and not 1e-10
    for k, want in want_params.items():
        np.testing.assert_allclose(flat[k].detach().numpy(), want, rtol=0, atol=1e-8,
                                   err_msg=k)
    got_moments = opt_state_to_jax(topt, tree)
    for key in want_moments:
        if key == "count":
            assert got_moments["count"] == want_moments["count"] == 4
            continue
        for k, want in flatten_params(want_moments[key]).items():
            np.testing.assert_allclose(flatten_params(got_moments[key])[k], want,
                                       rtol=0, atol=1e-10, err_msg=f"{key} {k}")


@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
def test_optimizer_state_converter_round_trip(name):
    np_tree = torch_stream_init(0, JCFG)
    flat = _leaf_params(np_tree)
    opt = port_optim.make_optimizer(name, flat.values(), 1e-3)
    rng = np.random.default_rng(51)
    for _ in range(2):
        for p in flat.values():
            p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        opt.step()
    tree = params_to_jax(params_from_jax(np_tree, "cpu"))
    moments = opt_state_to_jax(opt, tree)
    assert set(moments) == ({"nu", "count"} if name == "RMSProp"
                            else {"mu", "nu", "count"})
    assert moments["count"] == 2
    assert jax.tree.structure(moments["nu"]) == jax.tree.structure(np_tree)

    flat2 = _leaf_params(np_tree)
    opt2 = port_optim.make_optimizer(name, flat2.values(), 1e-3)
    opt_state_from_jax(moments, opt2)
    for p, p2 in zip(flat.values(), flat2.values()):
        assert set(opt.state[p]) == set(opt2.state[p2])
        for key, v in opt.state[p].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(opt2.state[p2][key])), key
    back = opt_state_to_jax(opt2, tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(moments)):
        np.testing.assert_array_equal(a, b)


def test_decayed_lr_matches_jax():
    for epoch in range(12):
        assert port_optim.decayed_lr(1e-4, epoch, 5, 0.5) == jax_optim.decayed_lr(
            1e-4, epoch, 5, 0.5)


# --- engine.train, resume, CLI on tiny data ---


@pytest.fixture(scope="module")
def tiny_data():
    return jax_data.synthesize("tiny", T=220, N=6, seed=0)


def _events(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_two_epochs_matches_jax_engine(tiny_data, tmp_path):
    """Same init draw, same batch order, no dropout: the two engines' epoch
    losses and validation metrics agree."""
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jmetrics, jstat = jax_engine.train(
        train, valid, JaxTrainConfig(dropout_rate=0.0, ckpt_async=False, **TINY), jout)
    pmetrics, pstat = port_engine.train(
        train, valid, TrainConfig(dropout_rate=0.0, device="cpu", **TINY), pout)
    assert pstat == jstat
    je, pe = _events(jout), _events(pout)
    assert [e["event"] for e in pe] == [e["event"] for e in je] == [
        "epoch", "validate", "epoch", "validate"]
    # f32 on both sides, a few dozen optimizer steps apart in summation order
    for a, b in zip(pe, je):
        if a["event"] == "epoch":
            assert a["epoch"] == b["epoch"] and a["lr"] == b["lr"]
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        else:
            for k in ("mae", "rmse", "mape", "mae_node"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert set(pmetrics) == set(jmetrics)
    np.testing.assert_allclose(pmetrics["mae"], jmetrics["mae"], rtol=1e-4)
    for name in ("norm_stat.json", "0_stemgnn.ckpt", "1_stemgnn.ckpt", "_stemgnn.ckpt"):
        assert os.path.exists(os.path.join(pout, name)), name
    params, opt_state, meta = ckpt.load(pout, epoch=1, device="cpu")
    assert meta["epoch"] == 1 and meta["rng_seed"] == 0
    n_leaves = len(flatten_params(params))
    assert sorted(opt_state["state"]) == list(range(n_leaves))
    # the unused stack-1 shortcut has optimizer state too, all zeros
    idx = list(flatten_params(params)).index("blocks/1/backcast_short_cut/w")
    assert not opt_state["state"][idx]["square_avg"].any()


@pytest.mark.parametrize("optimizer", ["RMSProp", "Adam"])
def test_resume_is_bitwise_the_uninterrupted_run(tiny_data, tmp_path, optimizer):
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    base = dict(TINY, device="cpu", dropout_rate=0.5, optimizer=optimizer)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    port_engine.train(train, valid, TrainConfig(**base), full)
    port_engine.train(train, valid, TrainConfig(**dict(base, epoch=1)), part)
    port_engine.train(train, valid, TrainConfig(**dict(base, resume=True)), part)
    a = ckpt.load(full, epoch=1, device="cpu")
    b = ckpt.load(part, epoch=1, device="cpu")
    for (k, u), v in zip(flatten_params(a[0]).items(), flatten_params(b[0]).values()):
        assert torch.equal(u, v), k
    for i, st in a[1]["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b[1]["state"][i][key]))
    # the meta of an epoch holds the best MAE from before that epoch's
    # validation (as in the JAX engine), so the resumed run's lags by one
    # validation; the rest of the bookkeeping is the same
    for key in ("epoch", "non_decrease_count", "rng_seed"):
        assert a[2][key] == b[2][key], key
    fe, pe = _events(full), _events(part)
    assert [e["loss"] for e in fe if e["event"] == "epoch"] == [
        e["loss"] for e in pe if e["event"] == "epoch"]
    # dropout was on: a rerun with another dropout seed differs
    other = str(tmp_path / "other")
    port_engine.train(train, valid, TrainConfig(**dict(base, dropout_seed=9)), other)
    assert _events(other)[0]["loss"] != fe[0]["loss"]


def test_ckpt_every_and_early_stop(tiny_data, tmp_path):
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    out = str(tmp_path / "out")
    cfg = TrainConfig(**dict(TINY, device="cpu", epoch=3, ckpt_every=2, lr=0.0,
                             early_stop=True, early_stop_step=1, log_jsonl=False))
    port_engine.train(train, valid, cfg, out)
    # lr 0: validation MAE cannot improve after epoch 0, so epoch 1 stops the
    # run; epoch 1 is on the cadence, epoch 0 is not
    assert ckpt.latest_epoch(out) == 1
    assert not os.path.exists(os.path.join(out, "0_stemgnn.ckpt"))
    assert not os.path.exists(os.path.join(out, "metrics.jsonl"))


def test_train_step_gives_the_unused_shortcut_zero_grads():
    params = init_params(0, CFG, device="cpu")
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(params).items()}
    opt = port_optim.make_optimizer("RMSProp", flat.values(), 1e-3)
    step = port_engine.make_train_step(CFG, opt, flat.values())
    data = torch.from_numpy(np.random.default_rng(52).standard_normal(
        (60, N)).astype(np.float32))
    before = flat["blocks/1/backcast_short_cut/w"].detach().clone()
    gen = torch.Generator().manual_seed(port_engine.epoch_generator_seed(0, 0))
    loss = step(params, data, torch.arange(W, W + B), gen)
    assert loss.ndim == 0 and torch.isfinite(loss) and not loss.requires_grad
    assert all(p.grad is not None for p in flat.values())
    assert torch.equal(flat["blocks/1/backcast_short_cut/w"].detach(), before)
    assert not torch.equal(flat["fc2/w"].detach(), params_from_jax(
        torch_stream_init(0, JCFG), "cpu")["fc2"]["w"])
    assert port_engine.epoch_generator_seed(0, 1) != port_engine.epoch_generator_seed(1, 0)


def test_cli_train_on_cpu_writes_the_artifacts(tiny_data, tmp_path, capsys):
    data_dir, out_dir = tmp_path / "dataset", tmp_path / "output"
    data_dir.mkdir()
    header = ",".join(str(i) for i in range(tiny_data.shape[1]))
    np.savetxt(data_dir / "tiny.csv", tiny_data, delimiter=",", header=header,
               comments="")
    port_main(["--dataset", "tiny", "--train", "True", "--device", "cpu", "--epoch", "1",
               "--window_size", "8", "--multi_layer", "2", "--batch_size", "16",
               "--data_dir", str(data_dir), "--output_dir", str(out_dir)])
    out = capsys.readouterr().out
    for line in ("Total Trainable Params:", "| end of epoch   0 |",
                 "------ validate on data: VALIDATE ------", "NORM: MAPE", "RAW : MAPE",
                 "Training took", "Performance on test set:", "done"):
        assert line in out, line
    train_dir, test_dir = out_dir / "tiny" / "train", out_dir / "tiny" / "test"
    for name in ("norm_stat.json", "0_stemgnn.ckpt", "_stemgnn.ckpt", "metrics.jsonl"):
        assert (train_dir / name).exists(), name
    for name in ("target.csv", "predict.csv", "predict_abs_error.csv", "predict_ape.csv"):
        assert (test_dir / name).exists(), name
    assert np.all(np.isfinite(np.loadtxt(test_dir / "predict.csv", delimiter=",")))
