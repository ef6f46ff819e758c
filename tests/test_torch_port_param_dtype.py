"""`--param_dtype bfloat16` in the port against the JAX package (CPU): the
cast after init, one train step's loss, gradients and optimizer state, with
each gradient's and each moment's dtype the JAX package's Pallas path gives
(its kernels' custom_vjp return f32 gradients to bf16 parameters: 50 leaves
of the model), three RMSProp and three Adam steps against the JAX engine's
trajectory, `--resume`, the conversions and checkpoints of bf16 and
mixed-dtype trees, the flag and serving from a bf16 checkpoint.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py runs them, at N = 64 nodes: below
`pallas_min_nodes` (64) the JAX package takes its jnp path, whose gradients
are all bf16 (the port has no such threshold: its kernels' leaves get f32
gradients at any N)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.config import TrainConfig as JaxTrainConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.train import optim as jax_optim
from stemgnn_tpu_torch.__main__ import main as port_main
from stemgnn_tpu_torch.config import TrainConfig, add_cli_args, config_from_args
from stemgnn_tpu_torch.models import stemgnn as port_stemgnn
from stemgnn_tpu_torch.models.convert import (
    flatten_params,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.train import optim as port_optim

torch.set_num_threads(1)

N, B, W, M = 64, 4, 12, 2
BF16 = "bfloat16"
LR = 1e-3
JCFG = JaxConfig(units=N, window_size=W, horizon=3, multi_layer=M)
TCFG = TrainConfig(window_size=W, horizon=3, multi_layer=M, param_dtype=BF16, device="cpu")
MCFG = TCFG.model_config(N)


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _np(a):
    """A JAX array as numpy f32 (bf16 exactly)."""
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bits(t):
    """A tensor's values as numpy f32 (bf16 exactly)."""
    return t.detach().float().numpy()


def _jax_params():
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), torch_stream_init(0, JCFG))


def _data(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((40, N)).astype(np.float32)


def _ulps(got, want):
    """|got - want| in bf16 ulps of |want| (the spacing of bf16 at want's
    exponent), elementwise: got and want hold bf16 values."""
    want = np.asarray(want, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.abs(np.asarray(got, np.float32) - want) / 2.0 ** (exp - 7)


def test_initial_params_are_the_init_cast_to_bf16():
    """engine.initial_params at param_dtype "bfloat16": every leaf bf16 and
    bitwise `jnp.astype(bfloat16)` of the port's f32 init (round to nearest,
    ties to even, the JAX engine's cast); and bitwise the JAX package's
    torch_stream_init cast, on every leaf whose f32 init is bitwise its (all
    but the xavier_normal block weight, up to 4 f32 ulps apart: ROADMAP C)."""
    flat = port_engine.initial_params(TCFG, MCFG, "cpu")
    f32 = port_engine.initial_params(TrainConfig(window_size=W, horizon=3, multi_layer=M,
                                                 device="cpu"), MCFG, "cpu")
    jax_f32 = flatten_params(torch_stream_init(0, JCFG))
    assert all(p.dtype == torch.bfloat16 and p.requires_grad for p in flat.values())
    same_f32 = 0
    for k, p in flat.items():
        assert np.array_equal(_bits(p), _np(jnp.asarray(_bits(f32[k])).astype(jnp.bfloat16))), k
        if np.array_equal(_bits(f32[k]), jax_f32[k]):
            same_f32 += 1
            assert np.array_equal(_bits(p), _np(jnp.asarray(jax_f32[k]).astype(jnp.bfloat16))), k
    assert same_f32 >= len(flat) - 2


def _jax_step_grads(params, x, y, key, precision):
    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, JCFG, jnp.asarray(x), training=True, dropout_rng=key,
                                   use_pallas=True, precision=precision)
        return jnp.mean((f - jnp.asarray(y)) ** 2)

    with jax.default_matmul_precision(precision):
        return jax.value_and_grad(loss_fn)(params)


def _jax_update(opt):
    """The JAX engine's optimizer update and `optax.apply_updates`, as its
    jitted train step runs them (one program: XLA on the CPU computes the
    bf16 arithmetic in f32 and rounds where a value leaves it)."""
    @jax.jit
    def update(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return update


def _port_step(np_params, data, hi, mask, name, compute_dtype):
    """One port train step over the bf16 parameters: (loss, the gradients the
    optimizer was handed by name, the optimizer, the flat parameters)."""
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(
        params_from_jax(np_params, "cpu")).items()}
    opt = port_optim.make_optimizer(name, flat.values(), LR)
    handed = []
    real_step = opt.step
    opt.step = lambda grads: (handed.append([g.clone() for g in grads]), real_step(grads))
    step = port_engine.make_train_step(MCFG, opt, flat.values(), compute_dtype=compute_dtype)
    loss = step(unflatten_params(flat), torch.from_numpy(data), torch.from_numpy(hi),
                dropout_mask=torch.from_numpy(mask.copy()))
    return float(loss), dict(zip(flat, handed[0])), opt, flat


# f32 gradients at compute_dtype float32: f32 sums in another order than XLA's
# (measured within 2e-6 of each gradient's largest entry); at bfloat16 the bf16
# spectral backward's tolerance of test_torch_port_bf16.py (measured 1.3e-3)
GRAD_TOL = {"float32": 1e-5, BF16: 3e-3}


@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
def test_one_step_gradient_and_moment_dtypes_match_jax(interpret, compute_dtype):
    """One RMSProp step at param_dtype "bfloat16" against jax.value_and_grad
    of the JAX model on the Pallas path and its optimizer's update: the loss
    within 1e-5; every gradient of the JAX package's dtype (f32 for the 48 GLU
    tensors and gru/w_hh, gru/b_hh, the leaves `kernel_grad_leaf` names;
    bf16 for the rest), each within GRAD_TOL of its largest entry (bf16
    gradients: plus one bf16 ulp, the same f32 value on either side of a
    rounding); every RMSProp `nu` of the JAX package's dtype; the parameters
    bf16 and held by `_hold_step`."""
    data = _data(90)
    hi = np.array([14, 20, 26, 33])
    key = jax.random.PRNGKey(3)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - JCFG.dropout_rate, (B, N, N)))
    params = _jax_params()
    x = np.stack([data[h - W:h] for h in hi])
    y = np.stack([data[h:h + 3] for h in hi])
    jloss, jgrads = _jax_step_grads(params, x, y, key, compute_dtype)
    jopt = jax_optim.make_optimizer("RMSProp", LR)
    jnew, jstate = _jax_update(jopt)(jgrads, jopt.init(params), params)
    jparams = flatten_params(jax.tree.map(_np, jnew))
    jgrads = flatten_params(jgrads)
    jnu = flatten_params(jstate.inner_state["nu"])
    loss, grads, opt, flat = _port_step(jax.tree.map(np.asarray, params), data, hi, mask,
                                        "RMSProp", compute_dtype)
    assert abs(loss - float(jloss)) < 1e-5
    kernel_leaves = [k for k, g in jgrads.items() if g.dtype == jnp.float32]
    assert len(kernel_leaves) == 50
    assert kernel_leaves == [k for k in flat if port_stemgnn.kernel_grad_leaf(k)]
    for k, g in grads.items():
        want = jgrads[k]
        assert str(g.dtype).split(".")[-1] == str(want.dtype), k
        tol = GRAD_TOL[compute_dtype] * float(np.abs(_np(want)).max())
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * np.abs(_np(want))
        err = np.abs(_bits(g) - _np(want))
        assert np.all(err <= tol), (k, err.max())
        nu = opt.state[flat[k]]["square_avg"]
        assert str(nu.dtype).split(".")[-1] == str(jnu[k].dtype), k
        assert flat[k].dtype == torch.bfloat16
        _hold_step(k, _bits(flat[k]), jparams[k], _np(flatten_params(params)[k]),
                   np.abs(_np(want)) <= 2 * tol)


# An RMSProp step moves a parameter by up to lr / sqrt(1 - alpha) whatever its
# gradient's size (alpha rounded to bf16: 0.98828125), an Adam step by up to lr
STEP_BOUND = {"RMSProp": LR / np.sqrt(1 - 0.98828125), "Adam": LR}


def _hold_step(name, got, want, before, noise, opt_name="RMSProp", steps=1):
    """bf16 parameters after `steps` steps against JAX's: each within 2^-7 a
    step of |before| + |JAX's after|, which bounds the update too: one bf16 ulp
    of the parameter and of the update (JAX computes the update in bf16,
    rounding each op where the step is not one fusion, and the port in f32;
    the update can be larger than the parameter); but where its gradient is
    within the gradients' tolerance of 0 (`noise`), a step moves it by up to
    STEP_BOUND either way on either side, so there within twice that a step
    more."""
    tol = steps * 2.0 ** -7 * (np.abs(before) + np.abs(want))
    d = np.abs(got - want)
    far = d > tol
    assert np.all(~far | (noise & (d <= tol + 2 * steps * STEP_BOUND[opt_name]))), (
        name, float((d / np.maximum(tol, 1e-30)).max()), int(far.sum()),
        int((far & ~noise).sum()))


def _jax_moments(name, state):
    inner = state.inner_state
    if name == "RMSProp":
        return {"nu": inner["nu"]}
    return {"mu": inner[0].mu, "nu": inner[0].nu, "count": int(inner[0].count)}


_MOMENT_KEYS = {"RMSProp": {"nu": "square_avg"}, "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"}}


@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
def test_three_steps_follow_the_jax_engine(interpret, name):
    """Three train steps of the port's engine at param_dtype "bfloat16" from
    the JAX package's bf16 parameters against three of the JAX engine's
    jitted train step (`make_train_step`, Pallas path, the same dropout
    keys): every parameter bf16 and every moment of the JAX package's dtype
    after each step; after three, each parameter within the `_hold_step` rule
    (three bf16 ulps of |before| + |after|) but for at most 1% of a leaf's
    entries, which stay within 6 STEP_BOUND (measured: one entry of the 50
    leaves of both optimizers past the rule, at 0.11 STEP_BOUND); the losses
    within 1e-4 (measured 1e-6); each moment within 2^-6 of its value plus
    1e-3 of its leaf's largest entry, two bf16 ulps and the f32 gradients'
    sum order (measured: a third of that at most)."""
    params = _jax_params()
    data = _data(91)
    his = [np.array([14, 20, 26, 33]) + i for i in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    jopt = jax_optim.make_optimizer(name, LR)
    jstep = jax_engine.make_train_step(JCFG, jopt, True, "float32")
    jparams, jstate = jax.tree.map(jnp.copy, params), jopt.init(params)
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(
        params_from_jax(jax.tree.map(np.asarray, params), "cpu")).items()}
    opt = port_optim.make_optimizer(name, flat.values(), LR)
    step = port_engine.make_train_step(MCFG, opt, flat.values())
    tree, tdata = unflatten_params(flat), torch.from_numpy(data)
    for hi, key in zip(his, keys):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(data), jnp.asarray(hi), key)
        mask = np.asarray(jax.random.bernoulli(key, 1.0 - JCFG.dropout_rate, (B, N, N)))
        loss = step(tree, tdata, torch.from_numpy(hi), dropout_mask=torch.from_numpy(mask.copy()))
        assert abs(float(loss) - float(jloss)) < 1e-4
        moments = _jax_moments(name, jstate)
        for jkey, tkey in _MOMENT_KEYS[name].items():
            for k, want in flatten_params(moments[jkey]).items():
                got = opt.state[flat[k]][tkey]
                assert str(got.dtype).split(".")[-1] == str(want.dtype), (k, jkey)
    before = flatten_params(jax.tree.map(_np, params))
    want = flatten_params(jax.tree.map(_np, jparams))
    for k, p in flat.items():
        assert p.dtype == torch.bfloat16
        got = _bits(p)
        tol = 3 * 2.0 ** -7 * (np.abs(before[k]) + np.abs(want[k]))
        d = np.abs(got - want[k])
        far = d > tol
        assert far.mean() <= 0.01 and np.all(d <= tol + 6 * STEP_BOUND[name]), k
    for jkey, tkey in _MOMENT_KEYS[name].items():
        for k, w in flatten_params(moments[jkey]).items():
            w = _np(w)
            got = _bits(opt.state[flat[k]][tkey])
            err = np.abs(got - w)
            assert np.all(err <= 2.0 ** -6 * np.abs(w) + 1e-3 * np.abs(w).max()), (k, jkey)


@pytest.fixture(scope="module")
def tiny_data():
    return jax_data.synthesize("tiny", T=220, N=6, seed=0)


TINY = dict(dataset="tiny", window_size=8, horizon=3, epoch=2, batch_size=16,
            multi_layer=2, validate_freq=1, lr=1e-3, device="cpu", param_dtype=BF16)


@pytest.mark.parametrize("optimizer", ["RMSProp", "Adam"])
def test_resume_is_bitwise_at_param_dtype_bf16(tiny_data, tmp_path, optimizer):
    """engine.train at param_dtype "bfloat16" for two epochs against one epoch
    and a `--resume` epoch: the checkpoints' bf16 parameters and mixed-dtype
    moments bit for bit, each of its dtype (the resumed optimizer keeps the
    f32 moments of the kernels' leaves f32, where torch's would cast them to
    bf16 and take another path)."""
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    base = dict(TINY, dropout_rate=0.5, optimizer=optimizer)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    port_engine.train(train, valid, TrainConfig(**base), full)
    port_engine.train(train, valid, TrainConfig(**dict(base, epoch=1)), part)
    port_engine.train(train, valid, TrainConfig(**dict(base, resume=True)), part)
    a = ckpt.load(full, epoch=1, device="cpu")
    b = ckpt.load(part, epoch=1, device="cpu")
    for (k, u), v in zip(flatten_params(a[0]).items(), flatten_params(b[0]).values()):
        assert u.dtype == v.dtype == torch.bfloat16 and torch.equal(u, v), k
    dtypes = set()
    for i, st in a[1]["state"].items():
        for key, v in st.items():
            w = b[1]["state"][i][key]
            assert v.dtype == w.dtype and torch.equal(v, w), (i, key)
            dtypes.add(v.dtype)
    assert {torch.bfloat16, torch.float32} <= dtypes


def _mixed_tree(like, seed):
    """A tree shaped and ordered like `like` (the JAX package's numpy arrays):
    bf16 leaves, and f32 where a kernel's gradient is f32."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(like)
    return unflatten_params({
        k: (rng.standard_normal(v.shape).astype(np.float32) if port_stemgnn.kernel_grad_leaf(k)
            else np.asarray(jnp.asarray(rng.standard_normal(v.shape), jnp.bfloat16)))
        for k, v in flat.items()})


@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
def test_conversions_and_checkpoints_keep_bf16_and_mixed_trees(tmp_path, name):
    """params_from_jax / params_to_jax of JAX's bf16 parameters, and
    opt_state_from_jax / opt_state_to_jax of mixed-dtype moments (bf16 and
    f32 leaf by leaf, as the JAX package's optimizer holds them after a
    step), round trip bit for bit and dtype for dtype through the port's
    leafwise optimizer; so do checkpoint.save and checkpoint.load with that
    optimizer's state_dict, loaded back by load_state_dict."""
    jparams = jax.tree.map(np.asarray, _jax_params())
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(
        params_from_jax(jparams, "cpu")).items()}
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    back = flatten_params(params_to_jax(unflatten_params(flat)))
    for k, v in flatten_params(jparams).items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k].view(np.int16),
                                                           v.view(np.int16)), k
    state = {key: _mixed_tree(jparams, i) for i, key in enumerate(_MOMENT_KEYS[name])}
    if name == "Adam":
        state["count"] = 3
    opt = port_optim.make_optimizer(name, flat.values(), LR)
    opt_state_from_jax(state, opt)
    out = opt_state_to_jax(opt, unflatten_params(flat))
    for key in _MOMENT_KEYS[name]:
        got, want = flatten_params(out[key]), flatten_params(state[key])
        for k, v in want.items():
            assert got[k].dtype == v.dtype, (key, k)
            assert np.array_equal(got[k].view(np.uint8), v.view(np.uint8)), (key, k)
    ckpt.save(str(tmp_path), unflatten_params(flat), opt.state_dict(), epoch=0)
    loaded, opt_state, _ = ckpt.load(str(tmp_path), epoch=0, device="cpu")
    loaded = flatten_params(loaded)
    assert all(loaded[k].dtype == torch.bfloat16 and torch.equal(loaded[k], v)
               for k, v in flat.items())
    opt2 = port_optim.make_optimizer(name, flat.values(), LR)
    opt2.load_state_dict({"state": opt_state["state"],
                          "param_groups": opt2.state_dict()["param_groups"]})
    for p in flat.values():
        for key, v in opt.state[p].items():
            assert opt2.state[p][key].dtype == v.dtype and torch.equal(opt2.state[p][key], v)


def test_param_dtype_flag_trains_and_serves_from_a_bf16_checkpoint(tiny_data, tmp_path,
                                                                   capsys):
    """`--param_dtype` parses to TrainConfig with the JAX package's name,
    default and values, and refuses others; `python -m stemgnn_tpu_torch
    --param_dtype bfloat16` trains an epoch, writes bf16 checkpoints and
    forecasts; `--train False` then forecasts from the bf16 checkpoint
    (engine.test), finite and equal to the training run's test line."""
    assert TrainConfig().param_dtype == JaxTrainConfig().param_dtype == "float32"
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    assert config_from_args(parser.parse_args(["--param_dtype", BF16])).param_dtype == BF16
    with pytest.raises(ValueError):
        TrainConfig(param_dtype="float16")
    data_dir, out_dir = tmp_path / "dataset", tmp_path / "output"
    data_dir.mkdir()
    header = ",".join(str(i) for i in range(tiny_data.shape[1]))
    np.savetxt(data_dir / "tiny.csv", tiny_data, delimiter=",", header=header, comments="")
    args = ["--dataset", "tiny", "--device", "cpu", "--epoch", "1", "--window_size", "8",
            "--multi_layer", "2", "--batch_size", "16", "--param_dtype", BF16,
            "--data_dir", str(data_dir), "--output_dir", str(out_dir)]
    port_main(args + ["--train", "True"])
    trained = capsys.readouterr().out
    params, opt_state, _ = ckpt.load(str(out_dir / "tiny" / "train"), device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in flatten_params(params).values())
    assert {v.dtype for st in opt_state["state"].values() for k, v in st.items()
            if k != "step"} == {torch.bfloat16, torch.float32}
    port_main(args + ["--train", "False"])
    served = capsys.readouterr().out
    line = [ln for ln in trained.splitlines() if ln.startswith("Performance on test set:")]
    assert line and line == [ln for ln in served.splitlines()
                             if ln.startswith("Performance on test set:")]
    assert "nan" not in line[0]
