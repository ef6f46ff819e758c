"""The JAX package's bytes in tests/torch_port_fixtures, which chip_smoke.py
reads on a host without JAX: written again here by make_fixtures.py they are
the committed bytes, and the port's CPU plain path serves them to the JAX
package's stored forecasts."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import checkpoint as jax_ckpt
from stemgnn_tpu.train.optim import make_optimizer
from stemgnn_tpu_torch.config import TrainConfig
from stemgnn_tpu_torch.data import WindowDataset, split_by_ratio, synthesize
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from tests.torch_port_fixtures import flax_bytes, make_fixtures

torch.set_num_threads(1)

FILES = ["rmsprop_f32/train/_stemgnn.ckpt", "rmsprop_f32/train/norm_stat.json",
         "rmsprop_f32/forecasts.npy", "adam_bf16/train/_stemgnn.ckpt",
         "adam_bf16/train/norm_stat.json", "adam_bf16/forecasts.npy",
         "threefry_ecg_seed0.json", "fixtures.json"]


def test_fixtures_are_the_jax_package_bytes(tmp_path):
    make_fixtures.write_all(str(tmp_path))
    written = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                     for d, _, fs in os.walk(tmp_path) for f in fs)
    assert written == sorted(FILES)
    for name in FILES:
        with open(tmp_path / name, "rb") as f, \
                open(os.path.join(make_fixtures.HERE, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("case", list(make_fixtures.CASES))
def test_port_serves_the_fixtures_on_the_cpu(case):
    """The port's CPU plain path on the fixture's checkpoint: the JAX
    package's test-split forecasts within 1e-5 (normalized values), from
    the series the port synthesizes itself."""
    s = make_fixtures.SERIES
    data = synthesize(s["name"], T=s["T"], N=s["N"], seed=s["seed"])
    _, _, test = split_by_ratio(data, 7, 2, 1)
    cfg = TrainConfig(**{k: v for k, v in make_fixtures.CONFIG.items()},
                      **make_fixtures.CASES[case], device="cpu")
    train_dir = os.path.join(make_fixtures.HERE, case, "train")
    params, opt_state, meta = ckpt.load(train_dir, device="cpu")
    assert meta["epoch"] == 0 and opt_state is not None
    stat = ckpt.load_norm_stat(train_dir)
    test_set = WindowDataset(test, cfg.window_size, cfg.horizon, cfg.norm_method, stat)
    mcfg = cfg.model_config(s["N"])
    forecasts, _ = port_engine.inference_batched(port_engine.make_eval_step(mcfg, "cpu"),
                                                 params, test_set, cfg.batch_size, "cpu")
    want = np.load(os.path.join(make_fixtures.HERE, case, "forecasts.npy"))
    assert forecasts.shape == want.shape
    np.testing.assert_allclose(forecasts, want, rtol=0, atol=1e-5)


def test_flax_bytes_are_the_jax_package_checkpoint(tmp_path):
    """tests/torch_port_fixtures/flax_bytes.py writes, at the ECG flagship's
    width, the bytes of the JAX package's checkpoint.save of the same
    parameters and RMSProp state; the port reads them back bitwise."""
    params = torch_stream_init(0, JaxConfig(units=140, window_size=12, horizon=3, multi_layer=5))
    rng = np.random.default_rng(4)
    nu = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32), params)
    meta = {"epoch": 3, "best_validate_mae": 0.5, "non_decrease_count": 0, "rng_seed": 0}
    params_j = jax.tree.map(jnp.asarray, params)
    state = make_optimizer("RMSProp", 1e-4).init(params_j)
    # as the engine's state after a step: jax.tree rebuilds each dict sorted
    state = jax.tree.map(jnp.asarray, state._replace(count=jnp.asarray(9, jnp.int32),
                                                     inner_state={"nu": nu}))
    path = jax_ckpt.save(str(tmp_path), params_j, state, epoch=3, meta=meta)
    got = flax_bytes.checkpoint_bytes(flax_bytes.jax_layout(params),
                                      flax_bytes.rmsprop_state(nu, 9, 1e-4), meta)
    with open(path, "rb") as f:
        assert got == f.read()
    p, o, m = ckpt.load(str(tmp_path), epoch=3, device="cpu")
    assert m == meta
    flat_nu = flatten_params(nu)
    for i, (k, v) in enumerate(flatten_params(p).items()):
        assert np.array_equal(v.numpy(), flatten_params(params)[k]), k
        assert np.array_equal(o["state"][i]["square_avg"].numpy(), flat_nu[k]), k
        assert o["state"][i]["step"].item() == 9
