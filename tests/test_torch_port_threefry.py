"""`--init_stream threefry` in the port against the JAX package (CPU): the
numpy Threefry-2x32 and `jax.random` bit paths of utils/threefry.py against
jax.random, `init_params_threefry` against the JAX package's threefry init,
the flag and the engine."""

import argparse
import hashlib
import json
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src import prng as jax_prng

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.config import TrainConfig as JaxTrainConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig, add_cli_args, config_from_args
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.models.initializers import init_params_threefry
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.utils import threefry

torch.set_num_threads(1)

SEEDS = [0, 1, 3, 2**31 - 1]
# (), (1,), odd sizes, and the model's shapes at the ECG flagship
SHAPES = [(), (1,), (7,), (3, 5), (140, 1), (420, 140), (1, 4, 1, 60, 60)]
FLAGSHIP = dict(units=140, window_size=12, horizon=3, multi_layer=5)
MODELS = {"ecg": FLAGSHIP,
          "covid": dict(units=25, window_size=28, horizon=28, multi_layer=5),
          "stretch": dict(units=300, window_size=12, horizon=3, multi_layer=2, sparse_k=8,
                          gru_hidden=32, gru_segment=100)}
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_fixtures",
                       "threefry_ecg_seed0.json")


def test_threefry_known_answer():
    """Salmon et al.'s known answer, which jax's threefry_2x32 gives too."""
    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    x = (np.array([0x243F6A88], np.uint32), np.array([0x85A308D3], np.uint32))
    got = [int(v[0]) for v in threefry.threefry_2x32(key, *x)]
    assert got == [0xC4923A9C, 0x483DF7A0]
    want = jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(np.concatenate(x)))
    assert got == [int(v) for v in np.asarray(want)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_are_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    mine = threefry.prng_key(seed)
    assert np.array_equal(np.asarray(key), mine)
    for n in (1, 2, 3, 4, 10, 12):
        assert np.array_equal(np.asarray(jax.random.split(key, n)), threefry.split(mine, n))
    sub, mine_sub = jax.random.split(key)[1], threefry.split(mine)[1]
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(sub, shape, jnp.uint32))
        got = threefry.random_bits(mine_sub, shape)
        assert got.shape == shape and np.array_equal(got, want), shape


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_normal_are_jax_random_bitwise(seed):
    """uniform at the bounds the model draws with, and normal: every entry
    bitwise jax.random's on the CPU (normal's ulp bound is 0: XLA's f32 log
    and log1p and its fused multiply-adds are written out)."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    mine = threefry.split(threefry.prng_key(seed))[1]
    bounds = [(0.0, 1.0), (-1 / np.sqrt(140), 1 / np.sqrt(140)),
              (-1.414 * np.sqrt(6 / 141), 1.414 * np.sqrt(6 / 141)), (0.5, 2.0)]
    for shape in SHAPES:
        for lo, hi in bounds:
            want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
            got = threefry.uniform(mine, shape, lo, hi)
            assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), (shape, lo)
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = threefry.normal(mine, shape)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), shape


def test_xla_log1p_and_erf_inv_over_their_range():
    """The f32 log1p, log and erf_inv XLA computes on the CPU, bitwise, on
    inputs across their range (subnormals, 0, -1, inf and NaN included)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 400_000), rng.uniform(-1, 10, 100_000),
                        10.0 ** rng.uniform(-40, 30, 100_000),
                        -(10.0 ** rng.uniform(-30, 0, 50_000)),
                        [0, -0.0, -1, np.inf, -2, np.nan, 1e-40, -1e-40]]).astype(np.float32)
    with np.errstate(all="ignore"):
        for mine, xla in ((threefry.log1p_xla, jnp.log1p),
                          (threefry.log_xla, jnp.log), (threefry.erf_inv, lax.erf_inv)):
            got, want = mine(x), np.asarray(jax.jit(xla)(x))
            same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
            assert same.all(), (mine.__name__, x[~same][:5], got[~same][:5], want[~same][:5])


def _round_f32(q: Fraction) -> np.float32:
    """The f32 nearest the rational q, ties to even."""
    f = np.float32(float(q))
    cands = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.float32(c).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """threefry.fma against the exact a * b + c rounded to f32, on random
    operands and on sums that fall just beside a halfway point of f32 (where
    a sum rounded to f64 first and then to f32 would round twice)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-2, 2, 3000).astype(np.float32)
    b = (rng.uniform(-2, 2, 3000) * 10.0 ** rng.integers(-8, 8, 3000)).astype(np.float32)
    c = rng.uniform(-2, 2, 3000).astype(np.float32)
    # c = 1 + 2^-23 (odd), a * b = 2^-24 (half an f32 ulp) -/+ 2^-60: the
    # exact sum lies within 2^-60 of a tie, which f64 rounds onto the tie
    a = np.concatenate([a, np.float32([2.0**-24 - 2.0**-47, 2.0**-24 + 2.0**-47, 2.0**-24])])
    b = np.concatenate([b, np.float32([1 + 2.0**-13, 1 - 2.0**-13, 1.0])])
    c = np.concatenate([c, np.float32([1 + 2.0**-23] * 3)])
    got = threefry.fma(a, b, c)
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert got.tobytes() == np.array(want, np.float32).tobytes()


def _jax_init(seed, model):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]  # stemgnn_tpu/train/engine.py:436-437
    return flatten_params(jax.tree.map(np.asarray, jax_stemgnn.init_params(key, JaxConfig(**model))))


@pytest.mark.parametrize("model,seed", [("ecg", 0), ("ecg", 3), ("covid", 0), ("stretch", 1)])
def test_init_params_threefry_is_the_jax_draw_bitwise(model, seed):
    """Every leaf bitwise, f32, the two xavier_normal block weights
    included, at the ECG flagship, the COVID-19 shape and a stretch model
    with gru_hidden; the tree in the port's init order."""
    cfg = StemGNNConfig(**MODELS[model])
    got = flatten_params(init_params_threefry(seed, cfg, device="cpu"))
    want = _jax_init(seed, MODELS[model])
    assert list(got) == list(flatten_params(init_params(seed, cfg, device="cpu")))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.numpy().tobytes() == want[k].tobytes(), k
        assert tuple(v.shape) == want[k].shape, k


def test_init_params_threefry_matches_the_committed_fixture():
    """The leaves' sha256 in tests/torch_port_fixtures (what chip_smoke.py
    holds the card's host to) are this draw's."""
    with open(FIXTURE) as f:
        fixture = json.load(f)
    got = flatten_params(init_params_threefry(fixture["seed"], StemGNNConfig(**fixture["model"]),
                                              device="cpu"))
    assert set(got) == set(fixture["leaves"])
    for k, v in got.items():
        leaf = fixture["leaves"][k]
        assert list(v.shape) == leaf["shape"] and str(v.numpy().dtype) == leaf["dtype"]
        assert hashlib.sha256(v.numpy().tobytes()).hexdigest() == leaf["sha256"], k


def test_flag_default_values_and_error(tiny_data, tmp_path):
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    assert TrainConfig().init_stream == JaxTrainConfig().init_stream == "torch"
    for value in ("torch", "threefry"):
        assert config_from_args(parser.parse_args(["--init_stream", value])).init_stream == value
    assert config_from_args(parser.parse_args([])).init_stream == "torch"
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    with pytest.raises(ValueError) as jax_err:
        jax_engine.train(train, valid, JaxTrainConfig(init_stream="bogus", **TINY),
                         str(tmp_path / "jax"))
    with pytest.raises(ValueError) as port_err:
        port_engine.train(train, valid, TrainConfig(init_stream="bogus", device="cpu", **TINY),
                          str(tmp_path / "port"))
    assert str(port_err.value) == str(jax_err.value)
    assert "init_stream must be 'torch' or 'threefry', got 'bogus'" in str(port_err.value)


@pytest.fixture(scope="module")
def tiny_data():
    return jax_data.synthesize("tiny", T=220, N=6, seed=0)


TINY = dict(dataset="tiny", window_size=8, horizon=3, epoch=1, batch_size=16,
            multi_layer=2, validate_freq=1, lr=1e-3)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_initial_params_of_the_engine(param_dtype):
    """engine.initial_params at init_stream threefry: the JAX draw, cast to
    param_dtype as the JAX engine casts it."""
    cfg = TrainConfig(init_stream="threefry", seed=3, param_dtype=param_dtype, device="cpu",
                      window_size=12, multi_layer=2)
    flat = port_engine.initial_params(cfg, cfg.model_config(10), "cpu")
    want = _jax_init(3, dict(units=10, window_size=12, horizon=3, multi_layer=2))
    for k, v in flat.items():
        w = np.asarray(jnp.asarray(want[k]).astype(param_dtype))
        assert v.requires_grad and str(v.dtype).split(".")[-1] == param_dtype
        bits = v.detach().view(torch.int16) if param_dtype == "bfloat16" else v.detach()
        assert bits.numpy().tobytes() == w.tobytes(), k


def test_train_from_the_jax_draw_matches_the_jax_engine(tiny_data, tmp_path):
    """engine.train at init_stream threefry against the JAX engine's: the
    same draw (no dropout), so the two engines' epoch losses and validation
    metrics agree as the torch stream's do (tests/test_torch_port_train.py)."""
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jmetrics, _ = jax_engine.train(train, valid, JaxTrainConfig(
        init_stream="threefry", dropout_rate=0.0, ckpt_async=False, **TINY), jout)
    pmetrics, _ = port_engine.train(train, valid, TrainConfig(
        init_stream="threefry", dropout_rate=0.0, device="cpu", **TINY), pout)
    events = []
    for out in (pout, jout):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events.append([json.loads(line) for line in f])
    assert [e["event"] for e in events[0]] == [e["event"] for e in events[1]]
    for a, b in zip(*events):
        if a["event"] == "epoch":
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        else:
            for k in ("mae", "rmse", "mape"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pmetrics["mae"], jmetrics["mae"], rtol=1e-4)
