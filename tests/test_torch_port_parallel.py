"""The port's multi-device training (`stemgnn_tpu_torch/parallel/`) on the CPU:
three groups of 4, 2 and 1 gloo processes (`parallel.dryrun.run_ranks`:
file:// rendezvous in a temporary directory, one thread a process, killed
after GROUP_TIMEOUT seconds), each rank computing the cases of
`tests/torch_parallel_cases.py` on the meshes its world holds ((1, 4), (2, 2)
and (4, 1) on 4 ranks; (1, 2) and (2, 1) on 2), held against the port's
single process and the JAX package's sharded functions on the 8-device CPU
mesh of tests/conftest.py.

Tolerances: f64 within 1e-10 of the largest entry (the ranks' sums add in
another order than one process's); f32 at the JAX package's own rtol 1e-4,
atol 5e-4 (tests/test_sparse_shard.py). The top-k index set is exact."""

import argparse
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.parallel import mesh as jax_mesh
from stemgnn_tpu.parallel import sparse_shard as jax_ss
from stemgnn_tpu.parallel.train import make_sharded_train_step as jax_sharded_step
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from stemgnn_tpu_torch import bench
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig, add_cli_args, config_from_args
from stemgnn_tpu_torch.models import stemgnn as port_stemgnn
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.ops import sparse as port_sparse
from stemgnn_tpu_torch.parallel import mesh as port_mesh
from stemgnn_tpu_torch.parallel.dryrun import run_ranks
from tests import torch_parallel_cases as cases

torch.set_num_threads(1)

GROUP_TIMEOUT = 120.0
ALPHA = 0.2
# the stretch step: 48 nodes, window 8, multi 2, batch 4, top-8 graph; a GRU
# of 8 units over segments of 6 nodes (whole segments in every node block at
# graph 2 and 4), over segments of 10 (not: the rank runs every segment and
# keeps its block), and the hidden = N GRU
N, W, M, B, K = 48, 8, 2, 4, 8
STRETCH = {
    "seg_aligned": dict(units=N, window_size=W, horizon=3, multi_layer=M, sparse_k=K,
                        gru_hidden=8, gru_segment=6),
    "seg_ragged": dict(units=N, window_size=W, horizon=3, multi_layer=M, sparse_k=K,
                       gru_hidden=8, gru_segment=10),
    "dense_gru": dict(units=N, window_size=W, horizon=3, multi_layer=M, sparse_k=K),
}
# the dense data-parallel step: tests/test_parallel.py's model
DENSE = dict(units=12, window_size=8, horizon=3, multi_layer=2)


def _group(world, calls: dict) -> dict:
    """{name: [each rank's result]} of the named (function of
    tests/torch_parallel_cases.py, args) `calls`, all in one group of `world`
    ranks."""
    per_rank = run_ranks(world, cases.bundle, (list(calls.values()),),
                         timeout=GROUP_TIMEOUT)
    return {name: [r[i] for r in per_rank] for i, name in enumerate(calls)}


def _close(got, want, dtype, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4, err_msg=what)


def _join(blocks, axis=0):
    return np.concatenate(blocks, axis=axis)


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


# --- inputs ---

GRAPH_N, GRAPH_K = 16, 5  # tests/test_sparse_shard.py's: k > N / 4
CHEB_N, CHEB_K, CHEB_W, CHEB_B = 16, 6, 8, 4
GRAPH_MESH = {2: (2, 2), 4: (1, 4)}  # graph axis -> the 4-rank mesh that has it
STEP_MESHES = [(1, 2), (1, 4), (2, 2)]
# the stretch steps also held to the JAX package's sharded step (each is one
# compile of its forward and gradient on the CPU mesh)
JAX_STEPS = [("seg_aligned", (1, 2)), ("seg_aligned", (1, 4)), ("seg_aligned", (2, 2)),
             ("seg_ragged", (1, 4)), ("dense_gru", (2, 2))]
DP_CASES = {"2x1": ((2, 1), 8), "4x1": ((4, 1), 8),
            "2x1_replicated": ((2, 1), 3), "4x1_replicated": ((4, 1), 6)}
TRAIN_KW = dict(dataset="tiny", window_size=8, horizon=3, epoch=1, batch_size=16,
                multi_layer=2, validate_freq=1, lr=1e-3, device="cpu")


def _kq(seed, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(dtype), rng.standard_normal(n).astype(dtype)


def _graph_mask():
    return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(3), 0.5, (GRAPH_N, GRAPH_K)))


def _cheb_inputs(dtype):
    key, query = _kq(1, CHEB_N, dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((CHEB_B, CHEB_N, CHEB_W)).astype(dtype)
    gout = rng.standard_normal((CHEB_B, 4, CHEB_N, CHEB_W)).astype(dtype)
    return key, query, x, gout


def _np_tree(cfg_kw):
    return torch_stream_init(0, JaxConfig(**cfg_kw, pallas_min_nodes=0))


def _f64_flat(cfg_kw):
    return {k: np.asarray(v, np.float64) for k, v in flatten_params(_np_tree(cfg_kw)).items()}


def _step_inputs(cfg_kw, batch, seed):
    """A seeded f64 series [40, N], window ends [batch] and the step's dropout
    mask as the JAX package draws it from PRNGKey(seed): [N, k] on the
    stretch path, [batch, N, N] on the dense one."""
    rng = np.random.default_rng(seed)
    n = cfg_kw["units"]
    data = rng.standard_normal((40, n))
    hi = rng.integers(cfg_kw["window_size"], 37, size=batch)
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64():
        shape = (n, cfg_kw["sparse_k"]) if "sparse_k" in cfg_kw else (batch, n, n)
        mask = np.asarray(jax.random.bernoulli(key, 0.5, shape))
    return data, hi, key, mask


def _stretch_call(variant, shape):
    kw = STRETCH[variant]
    data, hi, _, mask = _step_inputs(kw, B, 70)
    return ("train_step", (shape, dict(kw, force_sparse_shard=True), _f64_flat(kw), data, hi,
                           mask))


def _dense_call(case):
    shape, batch = DP_CASES[case]
    data, hi, _, mask = _step_inputs(DENSE, batch, 71)
    return ("train_step", (shape, DENSE, _f64_flat(DENSE), data, hi, mask,
                           batch % shape[0] == 0))


EVAL_KW = dict(STRETCH["seg_aligned"], force_sparse_shard=True)


def _eval_inputs():
    rng = np.random.default_rng(72)
    return _f64_flat(EVAL_KW), rng.standard_normal((40, N)), rng.integers(W, 37, size=(3, B))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every case of the file in three groups: 4 ranks, 2 ranks and 1 rank."""
    four = {("graph", g, d): ("sharded_graph", (GRAPH_MESH[g], *_kq(0, GRAPH_N), ALPHA,
                                                GRAPH_K, *((_graph_mask(), 0.5) if d else ())))
            for g in (2, 4) for d in (False, True)}
    four.update({("cheb", g, dt): ("sharded_cheb", (GRAPH_MESH[g], *_cheb_inputs(dt), ALPHA,
                                                    CHEB_K))
                 for g in (2, 4) for dt in (np.float64, np.float32)})
    two = {}
    for shape in STEP_MESHES:
        for variant in STRETCH:
            (four if shape[0] * shape[1] == 4 else two)[("step", variant, shape)] = \
                _stretch_call(variant, shape)
    for case, (shape, _) in DP_CASES.items():
        (four if shape[0] == 4 else two)[("dense", case)] = _dense_call(case)
    four["eval"] = ("eval_forecasts", ((2, 2), EVAL_KW, *_eval_inputs()))
    two["places"] = ("mesh_places", ())
    out = str(tmp_path_factory.mktemp("engine"))
    two["engine"] = ("engine_train", (dict(TRAIN_KW, data_axis=2), *_tiny_splits(),
                                      os.path.join(out, "mesh")))
    kw = dict(EVAL_KW, dropout_rate=0.0)
    x = np.random.default_rng(73).standard_normal((B, W, N)).astype(np.float32)
    flat = {k: np.asarray(v) for k, v in flatten_params(_np_tree(STRETCH["seg_aligned"])).items()}
    res = _group(4, four)
    res.update(_group(2, two))
    res.update(_group(1, {"spy": ("forced_shard_spy", (kw, flat, x))}))
    res["engine_single"] = cases.engine_train(TRAIN_KW, *_tiny_splits(),
                                              os.path.join(out, "single"))
    return res


def _tiny_splits():
    from stemgnn_tpu import data as jax_data

    data = jax_data.synthesize("tiny", T=220, N=6, seed=0)
    return jax_data.split_by_ratio(data, 7, 2, 1)[:2]


# --- the mesh ---


def test_auto_mesh_shape_is_the_jax_function():
    for n in range(1, 9):
        assert port_mesh.auto_mesh_shape(n) == jax_mesh.auto_mesh_shape(n), n


def test_make_mesh_needs_a_group_and_a_world_of_its_size(groups):
    with pytest.raises(RuntimeError, match="initialised process group"):
        port_mesh.make_mesh(1, 2)
    for rank, (errors, places) in enumerate(groups["places"]):
        assert errors == ["mesh 2x2 needs 4 devices, have 2", "mesh 1x1 covers 1 of 2 ranks"]
        # (2, 1): data index = rank, rows 8 a rank; (1, 2): graph index = rank
        assert places == (rank, 0, 0, rank, (8 * rank, 8 * rank + 8),
                          (8 * rank, 8 * rank + 8))


# --- the sharded graph and its Chebyshev conv ---


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("graph", [2, 4])
def test_sharded_graph_matches_jax(groups, graph, dropout):
    """idx exact on every rank; the row blocks of c, degree and inv_sqrt joined
    within rtol 1e-6 of JAX's build_sharded_graph on a (1, graph) mesh (with
    dropout: its global [N, k] mask, which the port is handed and slices), and
    of the port's single-device build."""
    key, query = _kq(0, GRAPH_N)
    rate = 0.5 if dropout else 0.0
    jmesh = jax_mesh.make_mesh(1, graph)
    jg = jax.jit(lambda kv, qv: jax_ss.build_sharded_graph(
        jmesh, kv, qv, ALPHA, GRAPH_K, dropout_rng=jax.random.PRNGKey(3) if dropout else None,
        dropout_rate=rate))(jnp.asarray(key), jnp.asarray(query))
    single = port_sparse.topk_latent_graph(torch.from_numpy(key), torch.from_numpy(query),
                                           ALPHA, GRAPH_K,
                                           dropout_mask=torch.from_numpy(_graph_mask()),
                                           dropout_rate=rate)
    ranks = groups["graph", graph, dropout]
    blocks = ranks[:graph]  # a (2, 2) mesh holds the graph axis twice
    for j, r in enumerate(ranks):
        np.testing.assert_array_equal(r["idx"], np.asarray(jg.idx))
        for name in ("c", "degree", "inv_sqrt"):
            np.testing.assert_array_equal(r[name], blocks[j % graph][name])
    for name in ("c", "degree", "inv_sqrt"):
        got = _join([b[name] for b in blocks])
        np.testing.assert_allclose(got, np.asarray(getattr(jg, name)), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(got, getattr(single, name).numpy(), rtol=1e-6, err_msg=name)
    assert set(single.idx.tolist()) == set(ranks[0]["idx"].tolist())


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("graph", [2, 4])
def test_sharded_cheb_conv_and_grads_match_jax(groups, graph, dtype):
    """sharded_sparse_cheb_conv and the gradients of a weighted sum of it with
    respect to key, query and x, joined over the graph axis, against JAX's
    sharded path (jax.grad through shard_map) and the port's single process."""
    key, query, x, gout = _cheb_inputs(dtype)
    with _x64(dtype):
        jmesh = jax_mesh.make_mesh(1, graph)

        @jax.jit
        def jloss(kv, qv, xv):
            g = jax_ss.build_sharded_graph(jmesh, kv, qv, ALPHA, CHEB_K)
            out = jax_ss.sharded_sparse_cheb_conv(jmesh, g, xv)
            return jnp.sum(out * gout), out

        (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(key), jnp.asarray(query), jnp.asarray(x))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (key, query, x)]
    g = port_sparse.topk_latent_graph(leaves[0], leaves[1], ALPHA, CHEB_K)
    out = port_sparse.sparse_cheb_conv(g, leaves[2])
    torch.sum(out * torch.from_numpy(gout)).backward()
    blocks = groups["cheb", graph, dtype][:graph]
    got = {"out": _join([b["out"] for b in blocks], axis=2),
           "key": _join([b["key"] for b in blocks]),
           "query": _join([b["query"] for b in blocks]),
           "x": _join([b["x"] for b in blocks], axis=1)}
    assert got["out"].dtype == dtype
    for name, want_jax, want_port in zip(
            ("out", "key", "query", "x"), (jout, *jgrads),
            (out.detach(), *(leaf.grad for leaf in leaves))):
        _close(got[name], np.asarray(want_jax), dtype, f"{name} against JAX")
        _close(got[name], want_port.numpy(), dtype, f"{name} against one process")


# --- the whole train step ---


def _jax_grads(cfg_kw, data, hi, key, mesh_shape):
    """The loss and gradients of the JAX package's sharded train step's loss
    (stemgnn_tpu/parallel/train.py: the forward on the mesh, MSE) at f64."""
    jcfg = JaxConfig(**cfg_kw, force_sparse_shard=True)
    jmesh = jax_mesh.make_mesh(*mesh_shape)
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _np_tree(cfg_kw))
    x, y = jax_engine.gather_windows(jnp.asarray(data), jnp.asarray(hi),
                                     cfg_kw["window_size"], cfg_kw["horizon"])

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, x, training=True, dropout_rng=key, mesh=jmesh)
        return jnp.mean((f - y) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(tree)
    return float(loss), flatten_params(jax.tree.map(np.asarray, grads))


def _assert_steps_agree(ranks, single, what):
    for r in ranks[1:]:  # every rank holds the same loss, gradients, parameters
        assert r["loss"] == ranks[0]["loss"], what
        for k in single["grads"]:
            np.testing.assert_array_equal(r["grads"][k], ranks[0]["grads"][k])
            np.testing.assert_array_equal(r["params"][k], ranks[0]["params"][k])
    got = ranks[0]
    assert abs(got["loss"] - single["loss"]) <= 1e-10 * max(1.0, abs(single["loss"])), what
    for k, want in single["grads"].items():
        _close(got["grads"][k], want, np.float64, f"{what}: d {k}")
        _close(got["params"][k], single["params"][k], np.float64, f"{what}: {k}")


@pytest.mark.parametrize("variant", list(STRETCH))
@pytest.mark.parametrize("shape", STEP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stretch_train_step_matches_one_process(groups, shape, variant):
    """The stretch model's node-sharded train step (f64, dropout on C, the
    global [N, k] mask handed to every rank): the loss, every gradient and
    every parameter after one RMSProp step equal on every rank and within
    1e-10 of the port's single process."""
    name, args = _stretch_call(variant, None)
    single = cases.train_step(None, STRETCH[variant], *args[2:])
    _assert_steps_agree(groups["step", variant, shape], single, f"{variant} on {shape}")


@pytest.mark.parametrize("variant,shape", JAX_STEPS,
                         ids=[f"{v}-{s[0]}x{s[1]}" for v, s in JAX_STEPS])
def test_stretch_train_step_matches_jax(groups, variant, shape):
    """The same step's loss and every gradient within 1e-10 of the JAX
    package's sharded step's (value_and_grad of its forward on the same mesh
    with force_sparse_shard, its dropout key drawing the mask the port is
    handed)."""
    data, hi, key, _ = _step_inputs(STRETCH[variant], B, 70)
    with jax.enable_x64():
        jloss, jgrads = _jax_grads(STRETCH[variant], data, hi, key, shape)
    got = groups["step", variant, shape][0]
    assert abs(got["loss"] - jloss) <= 1e-10 * max(1.0, abs(jloss))
    for k, want in jgrads.items():
        _close(got["grads"][k], want, np.float64, f"d {k}")


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dense_dp_step_matches_one_process(groups, case):
    """The dense model's data-parallel train step (f64, dropout on the global
    [B, N, N] attention, each rank its rows; a batch the mesh does not divide
    replicated): loss, gradients and parameters after one RMSProp step equal
    on every rank and within 1e-10 of the port's single process."""
    shape, batch = DP_CASES[case]
    data, hi, _, mask = _step_inputs(DENSE, batch, 71)
    single = cases.train_step(None, DENSE, _f64_flat(DENSE), data, hi, mask)
    _assert_steps_agree(groups["dense", case], single, case)


@pytest.mark.parametrize("case", ["2x1", "4x1", "4x1_replicated"])
def test_dense_dp_step_matches_jax(groups, case):
    """The same step's loss and parameters after one RMSProp step within
    1e-10 of the JAX package's make_sharded_train_step (an indivisible batch:
    its engine step with shard_batch=False) on the same mesh."""
    shape, batch = DP_CASES[case]
    data, hi, key, _ = _step_inputs(DENSE, batch, 71)
    with jax.enable_x64():
        jcfg, jmesh = JaxConfig(**DENSE), jax_mesh.make_mesh(*shape)
        opt = jax_make_optimizer("RMSProp", 1e-3)
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _np_tree(DENSE))
        if batch % shape[0] == 0:
            step = jax_sharded_step(jcfg, opt, jmesh)
        else:
            step = jax_engine.make_train_step(jcfg, opt, False, mesh=jmesh, shard_batch=False)
        jparams, _, jloss = step(tree, opt.init(tree), jnp.asarray(data),
                                 jnp.asarray(hi, jnp.int32), key)
        jparams = flatten_params(jax.tree.map(np.asarray, jparams))
    got = groups["dense", case][0]
    assert abs(got["loss"] - float(jloss)) <= 1e-10 * max(1.0, abs(float(jloss)))
    for k, want in jparams.items():
        _close(got["params"][k], want, np.float64, k)


# --- eval, the engine, the dispatch, the refusals ---


def test_sharded_eval_gathers_the_whole_forecast(groups):
    """The engine's eval step (batch replicated) and eval program (each batch
    sharded over 'data') on a (2, 2) mesh of the stretch model: every rank
    holds the whole forecast, within 1e-10 of one process's (f64)."""
    single = cases.eval_forecasts(None, EVAL_KW, *_eval_inputs())
    for r in groups["eval"]:
        for name in ("step", "epoch"):
            assert r[name].shape == single[name].shape
            _close(r[name], single[name], np.float64, name)


def test_engine_train_on_a_data_mesh(groups):
    """engine.train for one epoch on a (2, 1) mesh of 2 ranks: the validation
    metrics equal on both ranks and within 1e-5 of one process's run (f32);
    rank 0 writes norm_stat.json, the checkpoints, the CSVs and
    metrics.jsonl, rank 1 writes nothing."""
    ranks, single = groups["engine"], groups["engine_single"]
    for name in ("mae", "rmse", "mape"):
        assert ranks[0][name] == ranks[1][name], name
        np.testing.assert_allclose(ranks[0][name], single[name], rtol=1e-5, err_msg=name)
    assert ranks[0]["files"] == single["files"]
    assert {"norm_stat.json", "0_stemgnn.ckpt", "metrics.jsonl", "target.csv"} <= {
        os.path.basename(f) for f in single["files"]}
    assert ranks[1]["files"] == []


def test_force_sparse_shard_on_a_world_of_one_routes_through_the_sharded_path(groups):
    """A (1, 1) mesh with force_sparse_shard builds the graph once and runs each
    block's graph conv through parallel/sparse_shard (a spy, as the JAX
    package's test_sparse_shard.py:104); no mesh, neither. The forecast is
    the unsharded one's bits."""
    (res,) = groups["spy"]
    assert res["unsharded_calls"] == {"build": 0, "conv": 0}
    assert res["calls"] == {"build": 1, "conv": 2}
    np.testing.assert_array_equal(res["got"], res["ref"])


def test_use_ring_and_a_dense_graph_axis_are_accepted_and_an_indivisible_ring_raises():
    """--use_ring and a dense model on graph_axis > 1 parse, build and shard
    the dense model's nodes (the refusals that named ROADMAP A.4 are gone);
    --use_ring takes effect only on a mesh whose 'graph' axis is > 1, as the
    JAX engine's (stemgnn_tpu/train/engine.py:476); where 'graph' does not
    divide N every rank runs the whole model, and the ring raises, as the
    JAX package's (stemgnn_tpu/parallel/ring.py:95-97)."""
    from stemgnn_tpu_torch.parallel.ring import ring_attention
    from stemgnn_tpu_torch.train import engine as port_engine

    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    cfg = config_from_args(parser.parse_args(["--use_ring", "True", "--graph_axis", "4"]))
    assert cfg.use_ring and cfg.graph_axis == 4 and cfg.sparse_k == 0
    assert TrainConfig(graph_axis=2).model_config(12).sparse_k is None
    mesh = port_mesh.Mesh(data=1, graph=2, rank=0, data_group=None, graph_group=None,
                          world_group=None)
    assert port_engine._use_ring(cfg, mesh)
    assert not port_engine._use_ring(cfg, None)
    assert not port_engine._use_ring(TrainConfig(use_ring=True, data_axis=2), mesh)
    assert port_stemgnn.node_sharded(StemGNNConfig(units=12), mesh)
    assert not port_stemgnn.node_sharded(StemGNNConfig(units=13), mesh)
    assert not port_stemgnn.node_sharded(StemGNNConfig(units=13, sparse_k=4), mesh)
    with pytest.raises(ValueError, match="N=13 not divisible by graph axis 2"):
        ring_attention(mesh, torch.zeros((1, 13, 13)), torch.zeros((13, 1)),
                       torch.zeros((13, 1)), ALPHA)
    cfg = config_from_args(parser.parse_args(
        ["--data_axis", "2", "--graph_axis", "4", "--sparse_k", "8", "--force_sparse_shard",
         "True"]))
    assert (cfg.data_axis, cfg.graph_axis) == (2, 4)
    assert cfg.model_config(16).force_sparse_shard
    from stemgnn_tpu.config import TrainConfig as JaxTrainConfig

    for name in ("data_axis", "graph_axis", "use_ring"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name)
    assert StemGNNConfig(units=4).force_sparse_shard is JaxConfig(units=4).force_sparse_shard


def test_bench_runs_the_sharded_row_of_the_jax_suite():
    """synthetic-32k-sharded is the JAX suite's row with its 9th field
    (force_sparse_shard) True."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "suite.py"
    spec = importlib.util.spec_from_file_location("jax_suite", path)
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    row = suite.LARGE_CONFIGS["synthetic-32k-sharded"]
    kw = bench.config_kwargs("synthetic-32k-sharded")
    assert (kw["n_nodes"], kw["window"], kw["horizon"], kw["multi"], kw["batch"],
            kw["sparse_k"], kw["gru_hidden"], kw["gru_segment"],
            kw["force_sparse_shard"]) == tuple(row)
    assert not bench.config_kwargs("synthetic-32k-seggru")["force_sparse_shard"]


def test_init_distributed_refuses_nccl_without_a_card():
    """A CUDA device asks for NCCL, which needs a card: on a host without one
    it raises, and nothing falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="NCCL needs a card"):
        port_mesh.init_distributed("cuda", "file:///nonexistent", 0, 1)
    assert not torch.distributed.is_initialized() and port_mesh.is_lead()
