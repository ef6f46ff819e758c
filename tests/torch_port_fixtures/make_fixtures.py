"""Write the JAX package's bytes that the port reads in chip_smoke.py, whose
host has no JAX, and in the CPU tests:

  rmsprop_f32/     the JAX engine's output after one epoch of engine.train on
                   the seeded series SERIES (RMSProp, f32): train/norm_stat.json
                   and train/_stemgnn.ckpt, the best checkpoint (byte for byte
                   the epoch checkpoint 0_stemgnn.ckpt, which is left out), and
                   forecasts.npy, the JAX package's forecasts of the test split
                   at precision "float32" from that checkpoint (normalized, f32,
                   [windows, horizon, N]).
  adam_bf16/       the same at param_dtype bfloat16 with Adam: the JAX package's
                   jitted train step over the first epoch's batches (its
                   engine.train stops at bf16 parameters in this JAX: the scan's
                   carried learning rate turns bf16), then its checkpoint.save.
  fixtures.json    SERIES, CONFIG and CASES below, for a reader without JAX.
  threefry_ecg_seed0.json
                   shape, dtype and sha256 of every leaf of the JAX package's
                   threefry init (--init_stream threefry) at the ECG flagship
                   (N = 140, window 12, horizon 3, multi_layer 5), seed 0.

Run from the root of the repository (rewrites the committed files; the CPU
tests write them again into a temporary directory and hold them to these):

    python -m tests.torch_port_fixtures.make_fixtures [OUT_DIR]
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from stemgnn_tpu import data as jax_data  # noqa: E402
from stemgnn_tpu.config import StemGNNConfig, TrainConfig  # noqa: E402
from stemgnn_tpu.models import stemgnn  # noqa: E402
from stemgnn_tpu.models.initializers import torch_stream_init  # noqa: E402
from stemgnn_tpu.train import checkpoint as ckpt  # noqa: E402
from stemgnn_tpu.train import engine  # noqa: E402
from stemgnn_tpu.train.optim import make_optimizer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# a seeded series at a shape whose spectral D1 = 4 * 12 * 2 = 96 (as at
# synthetic-100k-seggru): 420 train, 120 valid and 60 test rows
SERIES = dict(name="jax_fixture", T=600, N=16, seed=17)
CONFIG = dict(window_size=12, horizon=3, multi_layer=2, batch_size=32, epoch=1, lr=1e-3,
              ckpt_async=False)
ECG = dict(units=140, window_size=12, horizon=3, multi_layer=5)
CASES = {"rmsprop_f32": dict(optimizer="RMSProp", param_dtype="float32"),
         "adam_bf16": dict(optimizer="Adam", param_dtype="bfloat16")}


def series():
    """The seeded series and its train, valid and test splits."""
    data = jax_data.synthesize(SERIES["name"], T=SERIES["T"], N=SERIES["N"],
                               seed=SERIES["seed"])
    return data, jax_data.split_by_ratio(data, 7, 2, 1)


def _train_bf16(cfg, train_data, train_dir):
    """One epoch of the JAX package's jitted train step over the engine's
    first-epoch batches (its shuffle; a dropout key per step folded from the
    seed), then checkpoint.save as the engine saves the best checkpoint."""
    mcfg = cfg.model_config(train_data.shape[1])
    stat = jax_data.compute_norm_stats(train_data, cfg.norm_method)
    ckpt.save_norm_stat(train_dir, stat)
    train_set = jax_data.WindowDataset(train_data, cfg.window_size, cfg.horizon,
                                       cfg.norm_method, stat)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          torch_stream_init(cfg.seed, mcfg))
    opt = make_optimizer(cfg.optimizer, cfg.lr)
    opt_state = opt.init(params)
    step = engine.make_train_step(mcfg, opt, cfg.use_pallas, "float32")
    key = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(cfg.seed))[0], 0)
    data = jnp.asarray(train_set.data)
    for i, hi in enumerate(train_set.epoch_batches(
            cfg.batch_size, shuffle=True, rng=np.random.default_rng([cfg.seed, 0]))):
        params, opt_state, _ = step(params, opt_state, data, jnp.asarray(hi),
                                    jax.random.fold_in(key, i))
    meta = {"epoch": 0, "best_validate_mae": float("inf"), "non_decrease_count": 0,
            "rng_seed": cfg.seed}
    ckpt.save(train_dir, params, opt_state, meta=meta)


def write_case(out_dir: str, name: str) -> None:
    """One JAX-trained output directory (module docstring)."""
    case_dir = os.path.join(out_dir, name)
    shutil.rmtree(case_dir, ignore_errors=True)
    train_dir = os.path.join(case_dir, "train")
    _, (train_data, valid_data, test_data) = series()
    cfg = TrainConfig(dataset=SERIES["name"], **CONFIG, **CASES[name])
    if cfg.param_dtype == "float32":
        engine.train(train_data, valid_data, cfg, train_dir)
        with open(os.path.join(train_dir, "0_stemgnn.ckpt"), "rb") as f, \
                open(os.path.join(train_dir, "_stemgnn.ckpt"), "rb") as g:
            assert f.read() == g.read(), "the best checkpoint is not the epoch's"
    else:
        _train_bf16(cfg, train_data, train_dir)
    for f in os.listdir(train_dir):
        if f not in ("norm_stat.json", "_stemgnn.ckpt"):
            os.remove(os.path.join(train_dir, f))
    mcfg = cfg.model_config(test_data.shape[1])
    params = ckpt.load(train_dir, stemgnn.init_params(jax.random.PRNGKey(0), mcfg))[0]
    stat = ckpt.load_norm_stat(train_dir)
    test_set = jax_data.WindowDataset(test_data, cfg.window_size, cfg.horizon,
                                      cfg.norm_method, stat)
    forecasts, _ = engine.inference_batched(
        engine.make_eval_epoch_fn(mcfg, cfg.use_pallas, "float32"),
        engine.make_eval_step(mcfg, cfg.use_pallas, "float32"), params, test_set,
        cfg.batch_size)
    np.save(os.path.join(case_dir, "forecasts.npy"), np.asarray(forecasts, np.float32))


def threefry_leaves(seed: int, model: dict) -> dict:
    """{name: {shape, dtype, sha256}} of the JAX package's threefry init."""
    mcfg = StemGNNConfig(**model)
    params = stemgnn.init_params(jax.random.split(jax.random.PRNGKey(seed))[1], mcfg)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    out = {}
    for path, leaf in leaves:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        a = np.ascontiguousarray(np.asarray(leaf))
        out[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return dict(sorted(out.items()))


def write_threefry(out_dir: str) -> None:
    with open(os.path.join(out_dir, "threefry_ecg_seed0.json"), "w") as f:
        json.dump({"model": ECG, "seed": 0, "leaves": threefry_leaves(0, ECG)}, f, indent=1)
        f.write("\n")


def write_all(out_dir: str = HERE) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fixtures.json"), "w") as f:
        json.dump({"series": SERIES, "config": CONFIG, "cases": CASES}, f, indent=1)
        f.write("\n")
    for name in CASES:
        write_case(out_dir, name)
    write_threefry(out_dir)


if __name__ == "__main__":
    write_all(sys.argv[1] if len(sys.argv) > 1 else HERE)
