"""The port reads the JAX package's checkpoints (CPU): `checkpoint.load` on
files the JAX package's `checkpoint.save` and `engine.train` wrote, every
parameter and moment bitwise with its dtype; the msgpack reader
(`train/flax_msgpack.py`) against msgpack's and flax's own; `--train False`
and `--resume True` on a directory the JAX engine trained."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.config import TrainConfig as JaxTrainConfig
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.train import checkpoint as jax_ckpt
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.train import optim as jax_optim
from stemgnn_tpu_torch import __main__ as port_cli
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import init_params
from stemgnn_tpu_torch.models import stemgnn as port_stemgnn
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.train import flax_msgpack

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(units=140, window_size=12, horizon=3, multi_layer=5)
SMALL = dict(units=6, window_size=8, horizon=3, multi_layer=2)
MOMENTS = {"RMSProp": {"nu": "square_avg"}, "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"}}


def _bits(a):
    """A leaf's bytes and dtype name: a numpy array (ml_dtypes' bfloat16
    included) or a tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        dt = str(a.dtype).split(".")[-1]
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes(), dt
    a = np.asarray(a)
    return a.tobytes(), str(a.dtype)


def _assert_same(got, want, what):
    assert _bits(got) == _bits(want), what


def _jax_state(name, cfg, dtype, seed):
    """The JAX package's parameters at `dtype` and an optax state of its
    optimizer with random moments: f32 and bf16 leaves mixed at bf16 (f32
    where the JAX package's kernels return an f32 gradient), count 7."""
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), torch_stream_init(seed, cfg))
    opt = jax_optim.make_optimizer(name, 1e-3)
    state = opt.init(params)
    rng = np.random.default_rng(seed)

    def moment(tree):
        flat = flatten_params(jax.tree.map(np.asarray, tree))
        out = {k: jnp.asarray(np.abs(rng.standard_normal(v.shape)),
                              jnp.float32 if dtype == jnp.float32
                              or port_stemgnn.kernel_grad_leaf(k) else jnp.bfloat16)
               for k, v in flat.items()}
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                            [out[k] for k in flatten_params(
                                                jax.tree.map(np.asarray, tree))])

    count = jnp.asarray(7, jnp.int32)
    if name == "RMSProp":
        inner = {"nu": moment(state.inner_state["nu"])}
    else:
        adam = state.inner_state[0]
        inner = (adam._replace(count=count, mu=moment(adam.mu), nu=moment(adam.nu)),
                 state.inner_state[1])
    return params, state._replace(count=count, inner_state=inner)


def _jax_moments(name, state):
    inner = state.inner_state
    if name == "RMSProp":
        return {"nu": inner["nu"]}
    return {"mu": inner[0].mu, "nu": inner[0].nu}


def _assert_reads(path_dir, params, state, name, meta, epoch=None):
    """The port's `load` of the JAX file: every parameter and moment
    bitwise, of its dtype, in the port's leaf order; step the JAX count."""
    got, opt_state, got_meta = ckpt.load(path_dir, epoch=epoch, device="cpu")
    assert got_meta == meta
    want = flatten_params(jax.tree.map(np.asarray, params))
    got = flatten_params(got)
    assert set(got) == set(want)
    for k, v in got.items():
        _assert_same(v, want[k], k)
    names = list(got)
    for jkey, tkey in MOMENTS[name].items():
        flat = flatten_params(jax.tree.map(np.asarray, _jax_moments(name, state)[jkey]))
        for i, k in enumerate(names):
            _assert_same(opt_state["state"][i][tkey], flat[k], (k, jkey))
    count = int(state.count if name == "RMSProp" else state.inner_state[0].count)
    assert all(st["step"].item() == count for st in opt_state["state"].values())


@pytest.mark.parametrize("model", [FLAGSHIP, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("name", ["RMSProp", "Adam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_reads_jax_checkpoint_save(tmp_path, model, name, dtype):
    cfg = JaxConfig(**model)
    params, state = _jax_state(name, cfg, jnp.dtype(dtype), seed=3)
    meta = {"epoch": 4, "best_validate_mae": 0.75, "non_decrease_count": 1, "rng_seed": 0}
    jax_ckpt.save(str(tmp_path), params, state, epoch=4, meta=meta)
    _assert_reads(str(tmp_path), params, state, name, meta, epoch=4)
    # the port's leaf order is its init's, whatever order the JAX file keeps
    names = list(flatten_params(init_params(0, StemGNNConfig(**model), "cpu")))
    assert list(flatten_params(ckpt.load(str(tmp_path), epoch=4, device="cpu")[0])) == names


@pytest.fixture(scope="module")
def tiny_data():
    return jax_data.synthesize("tiny", T=220, N=6, seed=0)


TINY = dict(dataset="tiny", window_size=8, horizon=3, batch_size=16, multi_layer=2,
            lr=1e-3, ckpt_async=False)


@pytest.fixture(scope="module", params=["RMSProp", "Adam"])
def jax_run(request, tiny_data, tmp_path_factory):
    """Two epochs of the JAX engine on the tiny series (its per-epoch and best
    checkpoints, norm_stat.json) and its test metrics and CSVs."""
    name = request.param
    root = tmp_path_factory.mktemp(f"jax_{name}")
    data_dir, train_dir = root / "dataset", root / "output" / "tiny" / "train"
    _write_dataset(str(data_dir), tiny_data)
    train, valid, test = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    cfg = JaxTrainConfig(epoch=2, optimizer=name, **TINY)
    jax_engine.train(train, valid, cfg, str(train_dir))
    metrics = jax_engine.test(test, cfg, str(train_dir), str(root / "jax_test"))
    return dict(name=name, root=root, cfg=cfg, metrics=metrics)


def _copy_run(run, tmp_path, drop=()):
    """A copy of the JAX run's dataset and output directories in tmp_path,
    without the train directory's files `drop`."""
    for d in ("dataset", "output"):
        shutil.copytree(run["root"] / d, tmp_path / d)
    for f in drop:
        os.remove(tmp_path / "output" / "tiny" / "train" / f)
    return str(tmp_path / "dataset"), str(tmp_path / "output")


def test_load_reads_jax_engine_train(jax_run):
    """engine.train's per-epoch and best checkpoints, read by the port and by
    the JAX package's own `checkpoint.load`: the same leaves, bitwise."""
    name, cfg = jax_run["name"], jax_run["cfg"]
    train_dir = str(jax_run["root"] / "output" / "tiny" / "train")
    mcfg = cfg.model_config(6)
    template = jax.tree.map(jnp.asarray, torch_stream_init(0, mcfg))
    opt_template = jax_optim.make_optimizer(name, cfg.lr).init(template)
    for epoch in (0, 1, None):
        params, state, meta = jax_ckpt.load(train_dir, template, opt_template, epoch=epoch)
        _assert_reads(train_dir, params, state, name, meta, epoch=epoch)
    assert ckpt.latest_epoch(train_dir) == 1


def _jax_blob(tmp_path, dtype="float32", name="Adam"):
    params, state = _jax_state(name, JaxConfig(**SMALL), jnp.dtype(dtype), seed=1)
    return serialization.to_bytes({"params": params, "opt_state": state})


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        assert _bits(got)[0] == np.asarray(want).tobytes(), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want, path
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_matches_msgpack_and_flax(tmp_path, dtype):
    """unpackb against msgpack.unpackb with flax's extension hook, and
    msgpack_restore against flax's, on a checkpoint's bytes."""
    blob = _jax_blob(tmp_path, dtype)
    want = msgpack.unpackb(blob, ext_hook=serialization._msgpack_ext_unpack, raw=False)
    _assert_tree_equal(flax_msgpack.unpackb(blob), want)
    _assert_tree_equal(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_decoder_covers_every_msgpack_type():
    """Every type and width of the msgpack spec, and flax's three extension
    types, against msgpack.unpackb."""
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -2.5, 1e300, float("inf"), float("nan")],
        "consts": [None, True, False],
        "strs": ["", "é" * 3, "a" * 31, "a" * 32, "b" * 255, "c" * 256, "d" * 70000],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                 {str(i): i for i in range(70000)}],
        "nested": {"a": {"b": [{"c": []}, {}]}},
    }
    blob = msgpack.packb(obj, use_bin_type=True)
    _assert_tree_equal(flax_msgpack.unpackb(blob), msgpack.unpackb(blob, raw=False))
    single = msgpack.packb([1.5, -0.25], use_single_float=True)
    assert single[1] == 0xCA and flax_msgpack.unpackb(single) == [1.5, -0.25]
    # flax's ext types 1 (ndarray, of every width of ext and fixext), 2, 3
    tree = {"c": complex(1.5, -2.0), "s": np.float32(3.25), "i": np.int64(-7),
            "h": jnp.asarray(1.0, jnp.bfloat16),
            "a": [(np.arange(n) % 3).astype(dt) for n in (0, 1, 3, 100, 40000)
                  for dt in (np.float32, np.float64, np.int32, np.uint8, np.bool_)],
            "bf": np.asarray(jnp.arange(-3, 3, dtype=jnp.bfloat16)).reshape(2, 3)}
    blob = serialization.msgpack_serialize(tree)
    want = msgpack.unpackb(blob, ext_hook=serialization._msgpack_ext_unpack, raw=False)
    _assert_tree_equal(flax_msgpack.unpackb(blob), want)
    # fixext 4, 8 and 16 and ext 8 carrying flax's types; an unknown code at
    # every ext width raises, naming it
    for data in (msgpack.packb([255, 1]), msgpack.packb([-1, 2**32 - 1]),
                 msgpack.packb([2.5, 1])):
        blob = msgpack.packb(msgpack.ExtType(2, data))
        assert flax_msgpack.unpackb(blob) == complex(*msgpack.unpackb(data))
    arr = msgpack.packb(((8,), "u1", bytes(range(8))), use_bin_type=True)
    assert len(arr) == 16 and msgpack.packb(msgpack.ExtType(1, arr))[0] == 0xD8
    got = flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, arr)))
    assert got.dtype == np.uint8 and got.tolist() == list(range(8))
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):
        with pytest.raises(ValueError, match="extension type 42"):
            flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(42, b"x" * n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays_are_reassembled(monkeypatch, dtype):
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes (patched
    small), reassembled as flax does, in integer order of the chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 32)
    big = jnp.arange(24 * 11, dtype=jnp.dtype(dtype)).reshape(24, 11)
    tree = {"gru": {"w_hh": big, "b": jnp.ones(3)}, "deep": {"x": {"y": big[:20]}}}
    blob = serialization.to_bytes(tree)
    raw = flax_msgpack.unpackb(blob)
    assert raw["gru"]["w_hh"][flax_msgpack.CHUNKED] is True
    assert len(raw["gru"]["w_hh"]["chunks"]) > 10  # "10" sorts before "2"
    _assert_tree_equal(flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))
    got = flax_msgpack.msgpack_restore(blob)["gru"]["w_hh"]
    assert _bits(got)[0] == np.asarray(big).tobytes()


def test_as_lists_orders_by_integer():
    tree = {str(i): {"w": i} for i in range(12)}
    tree["0"] = {"0": "a", "1": "b"}
    got = flax_msgpack.as_lists({"blocks": tree, "empty": {}, "named": {"0": 1, "x": 2}})
    assert [b["w"] for b in got["blocks"][1:]] == list(range(1, 12))
    assert got["blocks"][0] == ["a", "b"]
    assert got["empty"] == {} and got["named"] == {"0": 1, "x": 2}


def test_bad_bytes_raise_and_name_the_fault(tmp_path):
    blob = _jax_blob(tmp_path)
    for cut in (1, 7, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.msgpack_restore(blob[:cut])
    with pytest.raises(ValueError, match="bytes after the object"):
        flax_msgpack.unpackb(blob + b"\x00")
    with pytest.raises(ValueError, match="extension type 42"):
        flax_msgpack.unpackb(msgpack.packb({"a": msgpack.ExtType(42, b"xyz")}))
    with pytest.raises(ValueError, match="0xc1"):
        flax_msgpack.unpackb(b"\x91\xc1")
    # a checkpoint file cut short, in its header or its msgpack
    params, state = _jax_state("RMSProp", JaxConfig(**SMALL), jnp.float32, 2)
    path = jax_ckpt.save(str(tmp_path), params, state, meta={"epoch": 0})
    with open(path, "rb") as f:
        raw = f.read()
    for cut, match in ((4, "neither"), (12, "header"), (len(raw) - 9, "truncated")):
        with open(path, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(ValueError, match=match):
            ckpt.load(str(tmp_path), device="cpu")


def test_reader_needs_no_msgpack_flax_or_ml_dtypes(tmp_path):
    """A process where msgpack, ml_dtypes, flax and jax cannot be imported
    reads a bf16 Adam checkpoint to the same bits."""
    params, state = _jax_state("Adam", JaxConfig(**SMALL), jnp.bfloat16, 5)
    meta = {"epoch": 2, "best_validate_mae": float("inf"), "non_decrease_count": 0,
            "rng_seed": 0}
    jax_ckpt.save(str(tmp_path), params, state, meta=meta)
    out = tmp_path / "read.pt"
    code = (
        "import sys\n"
        "for m in ('msgpack', 'ml_dtypes', 'flax', 'jax', 'jaxlib'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from stemgnn_tpu_torch.train import checkpoint\n"
        f"torch.save(checkpoint.load({str(tmp_path)!r}, device='cpu'), {str(out)!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('msgpack', 'ml_dtypes', 'flax', 'jax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = torch.load(out, weights_only=True)
    want = ckpt.load(str(tmp_path), device="cpu")
    for (k, a), b in zip(flatten_params(got[0]).items(), flatten_params(want[0]).values()):
        _assert_same(a, b, k)
    for i, st in want[1]["state"].items():
        for key, v in st.items():
            _assert_same(got[1]["state"][i][key], v, (i, key))
    assert got[2] == want[2] == meta
    _assert_reads(str(tmp_path), params, state, "Adam", meta)


def _write_dataset(data_dir, data):
    os.makedirs(data_dir, exist_ok=True)
    header = ",".join(str(i) for i in range(data.shape[1]))
    np.savetxt(os.path.join(data_dir, "tiny.csv"), data, delimiter=",", header=header,
               comments="")


FLAGS = ["--dataset", "tiny", "--window_size", "8", "--horizon", "3", "--batch_size",
         "16", "--multi_layer", "2", "--lr", "1e-3", "--device", "cpu"]


def test_cli_serves_a_jax_trained_directory(jax_run, tmp_path, monkeypatch):
    """`python -m stemgnn_tpu_torch --train False --device cpu` on the output
    directory of the JAX engine: the JAX engine's test metrics within rtol
    1e-5, and its forecast CSVs."""
    data_dir, out_dir = _copy_run(jax_run, tmp_path)
    got = {}

    def spy(*a, **kw):
        got.update(port_engine.test(*a, **kw))
        return got

    monkeypatch.setattr(port_cli, "test", spy)
    port_cli.main(FLAGS + ["--train", "False", "--data_dir", data_dir, "--output_dir", out_dir,
                           "--optimizer", jax_run["name"]])
    for k in ("mae", "rmse", "mape"):
        np.testing.assert_allclose(got[k], jax_run["metrics"][k], rtol=1e-5)
    for f in ("predict.csv", "target.csv"):
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(out_dir, "tiny", "test", f), delimiter=","),
            np.loadtxt(jax_run["root"] / "jax_test" / f, delimiter=","), rtol=1e-5)


def test_cli_resumes_from_a_jax_epoch_checkpoint(jax_run, tiny_data, tmp_path, monkeypatch):
    """`--resume True --device cpu` on a directory the JAX engine trained for
    one epoch (the run's epoch-0 checkpoint alone): the engine starts its
    second epoch from the JAX checkpoint's parameters and moments, bitwise,
    and trains on, writing its own checkpoints beside the JAX package's."""
    name = jax_run["name"]
    data_dir, out_dir = _copy_run(jax_run, tmp_path, drop=("1_stemgnn.ckpt",))
    train_dir = os.path.join(out_dir, "tiny", "train")
    template = jax.tree.map(jnp.asarray, torch_stream_init(0, jax_run["cfg"].model_config(6)))
    params, state, _ = jax_ckpt.load(
        train_dir, template, jax_optim.make_optimizer(name, 1e-3).init(template), epoch=0)
    entry = {}
    original = port_engine._train_epochs

    def spy(cfg, mcfg, flat, opt, *rest):
        entry["flat"] = {k: v.detach().clone() for k, v in flat.items()}
        entry["state"] = {i: {k: v.clone() for k, v in opt.state[p].items()}
                          for i, p in enumerate(flat.values())}
        entry["start"] = rest[7]
        return original(cfg, mcfg, flat, opt, *rest)

    monkeypatch.setattr(port_engine, "_train_epochs", spy)
    port_cli.main(FLAGS + ["--epoch", "2", "--resume", "True", "--evaluate", "False",
                           "--optimizer", name, "--data_dir", data_dir, "--output_dir", out_dir])
    assert entry["start"] == 1
    want = flatten_params(jax.tree.map(np.asarray, params))
    for k, v in entry["flat"].items():
        _assert_same(v, want[k], k)
    count = int(state.count if name == "RMSProp" else state.inner_state[0].count)
    for jkey, tkey in MOMENTS[name].items():
        flat = flatten_params(jax.tree.map(np.asarray, _jax_moments(name, state)[jkey]))
        for i, k in enumerate(entry["flat"]):
            _assert_same(entry["state"][i][tkey], flat[k], (k, jkey))
            assert entry["state"][i]["step"].item() == count
    # the second epoch, in the port's own format
    p1, s1, meta = ckpt.load(train_dir, epoch=1, device="cpu")
    assert meta["epoch"] == 1
    with open(os.path.join(train_dir, "1_stemgnn.ckpt"), "rb") as f:
        assert f.read(4) == b"PK\x03\x04"
    train, _, _ = jax_data.split_by_ratio(tiny_data, 7, 2, 1)
    steps = len(jax_data.WindowDataset(train, 8, 3, "z_score",
                                       jax_data.compute_norm_stats(train, "z_score"))
                .epoch_batches(16, shuffle=False))
    assert all(st["step"].item() == count + steps for st in s1["state"].values())
    assert all(torch.isfinite(v).all() for v in flatten_params(p1).values())
    assert any(not torch.equal(v, entry["flat"][k]) for k, v in flatten_params(p1).items())


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "stemgnn_tpu")


def test_port_imports_none_of_jax_flax_msgpack_ml_dtypes():
    """Every module of stemgnn_tpu_torch, and chip_smoke.py, imported in a
    fresh process: none of FORBIDDEN is loaded; and no source file of the
    package names one in an import statement."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stemgnn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'stemgnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'stemgnn_tpu_torch.train.flax_msgpack' in sys.modules\n"
        "assert 'stemgnn_tpu_torch.utils.threefry' in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(REPO, "stemgnn_tpu_torch"))
               for f in fs if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path
