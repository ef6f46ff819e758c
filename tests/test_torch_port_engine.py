"""The port's data pipeline, eval engine and CLI against the JAX package
(CPU), and the port's device and import rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu_torch import data as port_data
from stemgnn_tpu_torch.__main__ import main as port_main
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig
from stemgnn_tpu_torch.models import init_params, params_from_jax
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, M, BS = 8, 3, 2, 16
CSVS = ("target.csv", "predict.csv", "predict_abs_error.csv", "predict_ape.csv")


@pytest.fixture(scope="module")
def tiny_data():
    return jax_data.synthesize("tiny", T=220, N=6, seed=0)


@pytest.mark.parametrize("method", ["z_score", "min_max", ""])
def test_pipeline_outputs_identical(tiny_data, method):
    raw = tiny_data.copy()
    raw[[3, 4, 50], 2] = np.nan  # exercises the ffill/bfill
    js = jax_data.split_by_ratio(raw, 7, 2, 1)
    ps = port_data.split_by_ratio(raw, 7, 2, 1)
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(a, b)
    jstat = jax_data.compute_norm_stats(js[0], method)
    pstat = port_data.compute_norm_stats(ps[0], method)
    assert (jstat is None) == (pstat is None)
    for k in jstat or {}:
        np.testing.assert_array_equal(jstat[k], pstat[k])  # NaN == NaN here
    jds = jax_data.WindowDataset(js[1], W, H, method, jstat)
    pds = port_data.WindowDataset(ps[1], W, H, method, pstat)
    np.testing.assert_array_equal(jds.data, pds.data)
    np.testing.assert_array_equal(jds.x_end_idx, pds.x_end_idx)
    for shuffle in (False, True):
        jb = jds.epoch_batches(BS, shuffle, np.random.default_rng([0, 1]))
        pb = pds.epoch_batches(BS, shuffle, np.random.default_rng([0, 1]))
        assert len(jb) == len(pb)
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(a, b)
    if method:
        np.testing.assert_array_equal(
            jax_data.de_normalized(jds.data, method, jstat),
            port_data.de_normalized(pds.data, method, pstat))


def test_ensure_dataset_bytes_identical(tmp_path):
    jp = jax_data.ensure_dataset("COVID-19", str(tmp_path / "jax"))
    pp = port_data.ensure_dataset("COVID-19", str(tmp_path / "port"))
    with open(jp, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("device", [None, "cpu"], ids=["splice", "batched"])
def test_validate_matches_jax(tiny_data, tmp_path, device):
    train, valid, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    stat = jax_data.compute_norm_stats(train, "z_score")
    n = tiny_data.shape[1]
    jcfg = JaxConfig(units=n, window_size=W, horizon=H, multi_layer=M)
    pcfg = StemGNNConfig(units=n, window_size=W, horizon=H, multi_layer=M)
    np_params = torch_stream_init(0, jcfg)
    jds = jax_data.WindowDataset(valid, W, H, "z_score", stat)
    pds = port_data.WindowDataset(valid, W, H, "z_score", stat)
    assert len(pds) % BS != 0  # the short last batch runs at its true size
    want = jax_engine.validate(
        jax_engine.make_eval_step(jcfg, False, "float32"),
        jax.tree.map(jnp.asarray, np_params), jds, "z_score", stat, n, W, H, BS,
        result_file=str(tmp_path / "jax"))
    got = port_engine.validate(
        port_engine.make_eval_step(pcfg, "cpu"), params_from_jax(np_params, "cpu"),
        pds, "z_score", stat, n, W, H, BS, result_file=str(tmp_path / "port"),
        device=device)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for name in CSVS:
        a = np.loadtxt(tmp_path / "jax" / name, delimiter=",")
        b = np.loadtxt(tmp_path / "port" / name, delimiter=",")
        np.testing.assert_allclose(b, a, rtol=1e-5)


def test_cli_eval_on_cpu(tiny_data, tmp_path, capsys):
    data_dir, out_dir = tmp_path / "dataset", tmp_path / "output"
    data_dir.mkdir()
    header = ",".join(str(i) for i in range(tiny_data.shape[1]))
    np.savetxt(data_dir / "tiny.csv", tiny_data, delimiter=",", header=header,
               comments="")
    train, _, test = port_data.split_by_ratio(
        port_data.load_csv(str(data_dir / "tiny.csv")), 7, 2, 1)
    train_dir = out_dir / "tiny" / "train"
    cfg = StemGNNConfig(units=6, window_size=W, horizon=H, multi_layer=M)
    ckpt.save(str(train_dir), init_params(0, cfg, device="cpu"))
    ckpt.save_norm_stat(str(train_dir), port_data.compute_norm_stats(train, "z_score"))
    port_main(["--dataset", "tiny", "--train", "False", "--device", "cpu",
               "--window_size", str(W), "--multi_layer", str(M),
               "--data_dir", str(data_dir), "--output_dir", str(out_dir)])
    out = capsys.readouterr().out
    assert "NORM: MAPE" in out and "Performance on test set:" in out
    pred = np.loadtxt(out_dir / "tiny" / "test" / "predict.csv", delimiter=",")
    assert pred.shape == (len(test) - W - H + 1, 6)
    assert np.all(np.isfinite(pred))


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA rule cannot be shown")
    cfg = StemGNNConfig(units=6, window_size=W, horizon=H, multi_layer=M)
    params = init_params(0, cfg, device="cpu")
    ckpt.save(str(tmp_path), params)
    for call in (
        lambda: init_params(0, cfg),
        lambda: params_from_jax({"w": np.zeros(2)}),
        lambda: port_engine.make_eval_step(cfg),
        lambda: ckpt.load(str(tmp_path)),
        lambda: port_engine.test(np.zeros((40, 6)), TrainConfig(), str(tmp_path),
                                 str(tmp_path / "test")),
        lambda: port_engine.train(np.ones((40, 6)), np.ones((40, 6)), TrainConfig(),
                                  str(tmp_path / "train")),
    ):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stemgnn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'stemgnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'stemgnn_tpu')]\n"
        "parallel = [f'stemgnn_tpu_torch.parallel.{m}' for m in\n"
        "            ('mesh', 'sparse_shard', 'dense_shard', 'ring', 'train', 'dryrun')]\n"
        "assert all(m in sys.modules for m in parallel), parallel\n"
        "print(len([m for m in sys.modules if m.startswith('stemgnn_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module was imported
