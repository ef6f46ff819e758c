"""The launch across hosts (CPU, gloo): two torchrun groups of two processes,
`--nnodes 2 --node_rank 0|1`, each with its own working directory and its
dataset missing, against one group of four; and the dataset's synthesis on a
host without the lead (ROADMAP C.10)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stemgnn_tpu_torch import __main__ as port_cli
from stemgnn_tpu_torch.config import TrainConfig
from stemgnn_tpu_torch.data import synthetic
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ECG_data (synthesized where missing: 5000 x 140) at small widths on a
# (2, 2) mesh: the batch over 'data', the dense path's rows over 'graph'; a
# tenth of the series for training and a tenth for validation
FLAGS = ["--dataset", "ECG_data", "--window_size", "8", "--horizon", "3", "--multi_layer", "2",
         "--batch_size", "16", "--epoch", "1", "--train_length", "1", "--valid_length", "1",
         "--test_length", "8", "--evaluate", "False", "--ckpt_async", "False",
         "--data_axis", "2", "--graph_axis", "2", "--device", "cpu"]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(cwd, nnodes: int, node_rank: int, nproc: int, port: int, hash_seed: int):
    """One host's torchrun group. `hash_seed` salts Python's hash in its
    processes (PYTHONHASHSEED), from which a dataset synthesized with no
    seed of its own takes one: each host salts it otherwise."""
    cwd.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONHASHSEED=str(hash_seed),
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    env.pop("LOCAL_RANK", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nnodes),
           "--node_rank", str(node_rank), "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(port),
           "-m", "stemgnn_tpu_torch", *FLAGS]
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _metrics(path):
    """metrics.jsonl without its clock readings."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k != "ts" and "time" not in k and "per_s" not in k} for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    port2, port1 = _free_port(), _free_port()
    procs = [_torchrun(root / "node0", 2, 0, 2, port2, hash_seed=1),
             _torchrun(root / "node1", 2, 1, 2, port2, hash_seed=2)]
    outs = _wait(procs)
    procs = [_torchrun(root / "one", 1, 0, 4, port1, hash_seed=1)]
    outs += _wait(procs)
    return root, outs


def test_two_hosts_each_synthesize_the_dataset(runs):
    """Each host writes the dataset into its own directory, the same bytes:
    the global lead's seed, though node 1 salts its hash otherwise."""
    root, _ = runs
    paths = [root / n / "dataset" / "ECG_data.csv" for n in ("node0", "node1", "one")]
    data = [p.read_bytes() for p in paths]
    assert data[0] == data[1] == data[2]
    assert _files(root / "node1" / "dataset") == ["ECG_data.csv"]  # no temporary file left


def test_only_the_global_lead_writes_files(runs):
    root, outs = runs
    assert _files(root / "node1" / "output") == []
    written = _files(root / "node0" / "output")
    assert written == _files(root / "one" / "output")
    assert {f"ECG_data/train/{f}" for f in ("0_stemgnn.ckpt", "_stemgnn.ckpt",
                                            "metrics.jsonl", "norm_stat.json")} <= set(written)
    assert "mesh: data=2 graph=2 devices=4" in outs[0] and "mesh: data=2 graph=2" in outs[1]


def test_two_hosts_train_bitwise_as_one(runs):
    """RANK != LOCAL_RANK on node 1; the checkpoints (parameters, moments,
    meta), norm stats and metrics bitwise those of one host's four ranks."""
    root, _ = runs
    two, one = (root / n / "output" / "ECG_data" / "train" for n in ("node0", "one"))
    for epoch in (0, None):
        a, b = (ckpt.load(str(d), epoch=epoch, device="cpu") for d in (two, one))
        assert a[2] == b[2]
        for (k, u), v in zip(flatten_params(a[0]).items(), flatten_params(b[0]).values()):
            assert torch.equal(u, v), k
        for i, st in a[1]["state"].items():
            for key, v in st.items():
                assert torch.equal(v, b[1]["state"][i][key]), (i, key)
    assert (two / "norm_stat.json").read_bytes() == (one / "norm_stat.json").read_bytes()
    assert _metrics(two / "metrics.jsonl") == _metrics(one / "metrics.jsonl")


# --- C.10: the dataset on a host without the lead ---


def test_ensure_dataset_moves_a_whole_file_into_place(tmp_path, monkeypatch):
    """While the CSV is written, its final path does not exist: a reader sees
    the whole file or none. The bytes are those of a plain np.savetxt."""
    real = np.savetxt
    seen = []

    def savetxt(fname, *args, **kwargs):
        real(fname, *args, **kwargs)
        seen.append(os.path.exists(tmp_path / "COVID-19.csv"))

    monkeypatch.setattr(np, "savetxt", savetxt)
    path = synthetic.ensure_dataset("COVID-19", str(tmp_path))
    monkeypatch.undo()
    assert seen == [False]
    assert os.listdir(tmp_path) == ["COVID-19.csv"]
    data = synthetic.synthesize("COVID-19")
    real(tmp_path / "plain.csv", data, delimiter=",",
         header=",".join(str(i) for i in range(data.shape[1])), comments="")
    assert (tmp_path / "plain.csv").read_bytes() == open(path, "rb").read()
    assert oct(os.stat(path).st_mode & 0o777) == "0o644"


@pytest.mark.parametrize("env,synthesizes", [
    ({"RANK": "2", "LOCAL_RANK": "0", "WORLD_SIZE": "4"}, True),
    ({"RANK": "3", "LOCAL_RANK": "1", "WORLD_SIZE": "4"}, False),
    ({"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "4"}, True),
    ({}, True),  # no LOCAL_RANK: the global lead
], ids=["node1-local0", "node1-local1", "node0-local0", "single"])
def test_dataset_file_from_the_local_ranks_of_a_host(tmp_path, monkeypatch, env,
                                                     synthesizes):
    """`dataset_file`, as `_run` calls it, on two local ranks of the second
    host (global ranks 2 and 3): its LOCAL_RANK 0 synthesizes the missing
    dataset before the barrier, the other reads it after."""
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    events = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(env))
    monkeypatch.setattr(dist, "get_rank", lambda: int(env.get("RANK", 0)))
    monkeypatch.setattr(dist, "barrier", lambda: events.append("barrier"))

    def broadcast(box, src):  # the global lead's seed reaches this rank
        assert src == 0
        events.append("seed")
        box[0] = 12345

    monkeypatch.setattr(dist, "broadcast_object_list", broadcast)
    real = port_cli.ensure_dataset

    def ensure(name, data_dir, seed):
        events.append(("ensure", os.path.exists(os.path.join(data_dir, f"{name}.csv"))))
        assert seed == (12345 if env else None)
        return real(name, data_dir, seed)

    monkeypatch.setattr(port_cli, "ensure_dataset", ensure)
    cfg = TrainConfig(dataset="COVID-19", data_dir=str(tmp_path), device="cpu")
    path = port_cli.dataset_file(cfg)
    assert os.path.exists(path)
    if not env:
        assert events == [("ensure", False)]
    elif synthesizes:
        assert events == ["seed", ("ensure", False), "barrier"]
        want = synthetic.synthesize("COVID-19", seed=12345)
        np.testing.assert_allclose(port_cli.load_csv(path), want, rtol=1e-12)
    else:
        assert events == ["seed", "barrier", ("ensure", False)]
