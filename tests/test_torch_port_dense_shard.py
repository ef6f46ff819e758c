"""The dense path's node partition over 'graph' and `--use_ring`
(`stemgnn_tpu_torch/parallel/dense_shard.py`, `parallel/ring.py`), their
row-block kernels' plain versions and plans, and the spectral chain's grid
walk, on the CPU.

Three gloo groups (`parallel.dryrun.run_ranks`): 8 ranks (the ring at graph
8), 4 ranks (meshes (1, 4) and (2, 2); an N that 'graph' does not divide) and
2 ranks (mesh (1, 2); the stretch step's top-k set at N = 2048). Each rank
computes cases of `tests/torch_parallel_cases.py`, held to the port's single
process (f64, within 1e-10 of each array's largest entry) and to the JAX
package's sharded functions on the 8-device CPU mesh of tests/conftest.py
(f64 gradients within 1e-10; f32 forecasts within 1e-5). On one card the
partition never runs (it needs 'graph' > 1, two cards), so these tests are
its standing guard.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.ops import jnp_impl, pallas_attention
from stemgnn_tpu.ops.pallas_graph import cheb_graph_conv_pallas
from stemgnn_tpu.parallel import mesh as jax_mesh
from stemgnn_tpu.parallel.ring import ring_attention as jax_ring_attention
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.ops import _build, cuda_attention, cuda_graph, torch_impl
from stemgnn_tpu_torch.parallel import mesh as port_mesh
from stemgnn_tpu_torch.parallel.dryrun import run_ranks
from stemgnn_tpu_torch.parallel.ring import ring_attention
from tests import torch_parallel_cases as cases
from tests.test_torch_port_attention import H100, emulate_bwd, emulate_fwd

torch.set_num_threads(1)

GROUP_TIMEOUT = 120.0
ALPHA = 0.2
# the dense model: N divisible by 2 and 4 (tests/test_ring.py's sizes)
DENSE = dict(units=16, window_size=8, horizon=3, multi_layer=2)
B = 4
MESHES = [(1, 2), (1, 4), (2, 2)]
RINGS = [False, True]
# an N that 'graph' 4 does not divide: the dense model and the stretch model
# (a top-8 graph, an 8-unit GRU over segments of 6) on every rank whole
ODD = {"dense": dict(units=30, window_size=8, horizon=3, multi_layer=2),
       "stretch": dict(units=30, window_size=8, horizon=3, multi_layer=2, sparse_k=8,
                       gru_hidden=8, gru_segment=6)}
# tests/test_ring.py's ring: B 3, N 32
RING_B, RING_N = 3, 32
# a small stretch step for C.8: its (1, 2) f32 top-k set is one process's
C8 = dict(units=2048, window_size=12, horizon=3, multi_layer=2, sparse_k=32, gru_hidden=32,
          gru_segment=256)


def _np_tree(cfg_kw):
    return torch_stream_init(0, JaxConfig(**cfg_kw, pallas_min_nodes=0))


def _flat(cfg_kw, dtype):
    return {k: np.asarray(v, dtype) for k, v in flatten_params(_np_tree(cfg_kw)).items()}


def _step_inputs(cfg_kw, batch, seed, dtype=np.float64):
    """A seeded series [40, N], window ends [batch], the step's dropout mask
    as the JAX package draws it from PRNGKey(seed) ([N, k] on the stretch
    path, [batch, N, N] on the dense one) and that key."""
    rng = np.random.default_rng(seed)
    n = cfg_kw["units"]
    data = rng.standard_normal((40, n)).astype(dtype)
    hi = rng.integers(cfg_kw["window_size"], 37, size=batch)
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64():
        shape = (n, cfg_kw["sparse_k"]) if "sparse_k" in cfg_kw else (batch, n, n)
        mask = np.asarray(jax.random.bernoulli(key, 0.5, shape))
    return data, hi, mask, key


def _eval_inputs(dtype):
    rng = np.random.default_rng(90)
    return (_flat(DENSE, dtype), rng.standard_normal((40, DENSE["units"])).astype(dtype),
            rng.integers(DENSE["window_size"], 37, size=(2, B)))


def _ring_inputs():
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((RING_B, RING_N, RING_N)).astype(np.float32)
    wk = (rng.standard_normal((RING_N, 1)) * 0.3).astype(np.float32)
    wq = (rng.standard_normal((RING_N, 1)) * 0.3).astype(np.float32)
    gout = rng.standard_normal((RING_B, RING_N, RING_N)).astype(np.float32)
    return enc, wk, wq, gout


def _c8_inputs():
    data, hi, mask, _ = _step_inputs(C8, 2, 91, np.float32)
    return _flat(C8, np.float32), data, hi, mask


def _calls(world):
    """The named (case, args) a group of `world` ranks computes."""
    calls = {}
    for shape in MESHES:
        if shape[0] * shape[1] != world:
            continue
        for ring in RINGS:
            data, hi, mask, _ = _step_inputs(DENSE, B, 92)
            calls["step", shape, ring] = ("train_step", (shape, DENSE, _flat(DENSE, np.float64),
                                                         data, hi, mask, True, 1e-3, ring))
            for dt in (np.float64, np.float32):
                calls["eval", shape, ring, dt] = ("eval_forecasts",
                                                  (shape, DENSE, *_eval_inputs(dt), ring))
        data, hi, mask, _ = _step_inputs(DENSE, B, 92)
        calls["step_rows", shape] = ("train_step", (shape, DENSE, _flat(DENSE, np.float64), data,
                                                    hi, mask, True, 1e-3, False, True))
    if world == 8:
        calls["ring", 8] = ("ring_rows", ((1, 8), *_ring_inputs(), ALPHA))
    if world == 4:
        calls["ring", 4] = ("ring_rows", ((1, 4), *_ring_inputs(), ALPHA))
        calls["ring", 2] = ("ring_rows", ((2, 2), *_ring_inputs(), ALPHA))
        for variant, kw in ODD.items():
            data, hi, mask, _ = _step_inputs(kw, B, 93)
            calls["odd", variant] = ("train_step", ((1, 4), kw, _flat(kw, np.float64), data,
                                                    hi, mask))
        data, hi, mask, _ = _step_inputs(ODD["dense"], B, 93)
        calls["odd_ring"] = ("ring_refusal", ((1, 4), ODD["dense"],
                                              _flat(ODD["dense"], np.float64), data, hi, mask))
    if world == 2:
        calls["c8"] = ("sparse_topk", ((1, 2), C8, *_c8_inputs()))
    return calls


@pytest.fixture(scope="module")
def groups():
    res = {}
    for world in (8, 4, 2):
        calls = _calls(world)
        per_rank = run_ranks(world, cases.bundle, (list(calls.values()),),
                             timeout=GROUP_TIMEOUT)
        res.update({name: [r[i] for r in per_rank] for i, name in enumerate(calls)})
    return res


def _close(got, want, what, dtype=np.float64):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=what)


def _same_on_every_rank(ranks, what):
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"], what
        for k, g in ranks[0]["grads"].items():
            np.testing.assert_array_equal(r["grads"][k], g, err_msg=f"{what}: d {k}")


# --- the plain row-block functions ---


def _kq(seed, b, n, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(dtype), rng.standard_normal((b, n)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,m", [(16, 8), (16, 4), (140, 35)])
def test_plain_rows_match_the_rows_of_jax(n, m, dtype):
    """The plain row-block attention, its backward (dkey of the block and the
    block's share of dquery, which summed over the blocks is the whole
    dquery) and the row-block graph conv against the rows of the JAX
    package's attention_from_kq, its VJP and cheb_graph_conv (f32 at
    precision "float32")."""
    b, w = 3, 8
    key, query = _kq(1, b, n, dtype)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((b, n, n)).astype(dtype)
    mul_L = (rng.standard_normal((4, n, n)) / np.sqrt(n)).astype(dtype)
    mul_L[0] = 0.0
    x = rng.standard_normal((b, n, w)).astype(dtype)
    with jax.enable_x64(dtype == np.float64), jax.default_matmul_precision("float32"):
        att, vjp = jax.vjp(lambda k, q: jnp_impl.attention_from_kq(k, q, ALPHA),
                           jnp.asarray(key), jnp.asarray(query))
        dkey, dquery = vjp(jnp.asarray(g))
        conv = jnp_impl.cheb_graph_conv(jnp.asarray(mul_L), jnp.asarray(x))
    t = torch.from_numpy
    tol = (dict(rtol=0, atol=1e-12) if dtype == np.float64 else dict(rtol=1e-5, atol=1e-6))
    share_sum = np.zeros_like(query)
    for r0 in range(0, n, m):
        blk = slice(r0, r0 + m)
        kb = t(key[:, blk].copy())
        rows = torch_impl.attention_rows(kb, t(query), ALPHA)
        np.testing.assert_allclose(rows.numpy(), np.asarray(att)[:, blk], **tol)
        dk, dq = torch_impl.attention_rows_bwd(kb, t(query), rows, t(g[:, blk].copy()), ALPHA)
        np.testing.assert_allclose(dk.numpy(), np.asarray(dkey)[:, blk], **tol)
        share_sum += dq.numpy()
        conv_rows = torch_impl.cheb_graph_conv_rows(t(mul_L[:, blk].copy()), t(x))
        np.testing.assert_allclose(conv_rows.numpy(), np.asarray(conv)[:, :, blk], **tol)
    np.testing.assert_allclose(share_sum, np.asarray(dquery), **tol)


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("n,m", [(140, 70), (140, 35)])
def test_row_arms_and_their_kernel_order_match_the_pallas_kernels(interpret, n, m):
    """The row-block arms on CPU tensors (their plain versions) and a torch
    emulation of the kernels' sum order on the row-block plans, against the
    rows of the Pallas attention forward, backward and graph conv in interpret
    mode (f32)."""
    b, w = 3, 12
    key, query = _kq(3, b, n, np.float32)
    rng = np.random.default_rng(4)
    g = rng.standard_normal((b, n, n)).astype(np.float32)
    mul_L = (rng.standard_normal((4, n, n)) / np.sqrt(n)).astype(np.float32)
    mul_L[0] = 0.0
    x = rng.standard_normal((b, n, w)).astype(np.float32)
    p = pallas_attention._forward_kq(jnp.asarray(key), jnp.asarray(query), ALPHA)
    dkey, _ = pallas_attention._bwd(ALPHA, (jnp.asarray(key), jnp.asarray(query), p),
                                    jnp.asarray(g))
    conv = np.asarray(cheb_graph_conv_pallas(jnp.asarray(mul_L), jnp.asarray(x)))
    blk = slice(n - m, n)
    t = torch.from_numpy
    kb, q, gb = t(key[:, blk].copy()), t(query), t(g[:, blk].copy())
    fplan = cuda_attention.fwd_plan(b, n, H100[0], m=m)
    bplan = cuda_attention.bwd_plan(b, n, *H100, m=m)
    for rows in (cuda_attention.attention_rows(kb, q, ALPHA), emulate_fwd(kb, q, ALPHA, fplan)):
        np.testing.assert_allclose(rows.numpy(), np.asarray(p)[:, blk], atol=1e-6)
    pb = t(np.asarray(p)[:, blk].copy())
    want_dq = torch_impl.attention_kq_bwd(kb, q, pb, gb, ALPHA)[1]
    for dk, dq in (cuda_attention.attention_rows_bwd(kb, q, pb, gb, ALPHA),
                   emulate_bwd(kb, q, pb, gb, ALPHA, bplan)):
        np.testing.assert_allclose(dk.numpy(), np.asarray(dkey)[:, blk], atol=1e-5)
        np.testing.assert_allclose(dq.numpy(), want_dq.numpy(), atol=1e-5)
    got = cuda_graph.cheb_graph_conv_rows(t(mul_L[:, blk].copy()), t(x))
    np.testing.assert_allclose(got.numpy(), conv[:, :, blk], atol=1e-5)


def test_attention_adjacency_is_the_jax_function():
    enc, wk, wq, _ = _ring_inputs()
    want = jnp_impl.attention_adjacency(jnp.asarray(enc), jnp.asarray(wk), jnp.asarray(wq),
                                        ALPHA)
    got = torch_impl.attention_adjacency(*(torch.from_numpy(a) for a in (enc, wk, wq)), ALPHA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# --- the plans: row blocks and the grid ceiling ---


ROW_PLAN_N = [140, 141, 512, 1024, 2048, 7300, 16384]
MAX_GRID_Y = 65_535  # blocks a grid may have along y, on every card


@pytest.mark.parametrize("n", ROW_PLAN_N)
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_row_block_plans_keep_the_cards_limits(n, parts):
    """At M = N / parts < N (the blocks of a 'graph' axis) up to N = 16,384:
    the forward's warps cover the M rows once, the backward's cluster splits
    the M rows and its slices hold the N columns (or a chunk), within an
    H100's shared memory, the graph conv's tiles cover the M rows and its
    panels fit; at M = N each plan is the square call's."""
    sms, smem = H100
    m = -(-n // parts)
    for b in (1, 8, 32):
        fp = cuda_attention.fwd_plan(b, n, sms, m=m)
        assert fp.bands * fp.rows_per_warp >= m > (fp.bands - 1) * fp.rows_per_warp
        assert fp.blocks * (cuda_attention.FWD_THREADS // 32) >= b * fp.bands
        assert fp.wide == (32 * fp.vec * fp.runs < n)
        for bi in range(b):
            rows = sorted(i for bj, i0, i1 in fp.rows(m, b) if bj == bi for i in range(i0, i1))
            assert rows == list(range(m))
        bp = cuda_attention.bwd_plan(b, n, sms, smem, m=m)
        assert 1 <= bp.cluster <= cuda_attention.MAX_CLUSTER
        assert bp.cluster * bp.rows_per_block >= m > (bp.cluster - 1) * bp.rows_per_block
        assert bp.cluster * bp.slice >= (bp.span if bp.chunked else n)
        assert bp.smem == 4 * (bp.warps * bp.span + (2 if bp.chunked else 1)
                               * bp.cluster * bp.slice) <= smem
        assert bp.threads <= cuda_attention.bwd_max_threads(bp.vec * bp.runs, bp.chunked)
        rows = sorted(i for c in range(bp.cluster) for w in range(bp.warps)
                      for i in bp.warp_rows(m, c, w))
        assert rows == list(range(m))
        assert cuda_attention.fwd_plan(b, n, sms, m=n) == cuda_attention.fwd_plan(b, n, sms)
        assert (cuda_attention.bwd_plan(b, n, sms, smem, m=n)
                == cuda_attention.bwd_plan(b, n, sms, smem))
        if n > 4096:  # the dense Chebyshev stack stops at the card's memory first
            continue
        # the f32 arm's plan, and the bf16 arm's on the tensor cores
        gp = cuda_graph.launch_plan(4, n, b, 12, m=m)
        assert gp.grid[1] * cuda_graph.ROW_TILE >= m > (gp.grid[1] - 1) * cuda_graph.ROW_TILE
        assert gp.grid[1] <= MAX_GRID_Y and gp.smem <= smem
        rows = sorted({i for _, (r0, r1), _ in gp.tiles(m, b) for i in range(r0, r1)})
        assert rows == list(range(m))
        assert (gp._replace(grid=gp.grid[:1] + (-(-n // cuda_graph.ROW_TILE),) + gp.grid[2:])
                == cuda_graph.launch_plan(4, n, b, 12))
        mp = cuda_graph.mma_plan(4, n, b, 12, sms, m=m)
        assert mp.grid[1] * mp.tm >= m > (mp.grid[1] - 1) * mp.tm
        assert mp.grid[1] <= MAX_GRID_Y and mp.smem <= smem
        rows = sorted({i for _, (r0, r1), _, _, _ in mp.tiles(m, b, 12) for i in range(r0, r1)})
        assert rows == list(range(m))
        assert cuda_graph.mma_plan(4, n, b, 12, sms, m=n) == cuda_graph.mma_plan(4, n, b, 12, sms)


def _definition(src: str, name: str) -> str:
    """The text of a csrc function's definition: from its name, at the start
    of a line or after its return type, to the brace that closes its body."""
    for m in re.finditer(rf"^(?:[\w:<>]+[ *&]+)?{name}\(", src, re.M):
        if src.index("{", m.end()) < src.find(";", m.end()):
            break
    else:
        raise ValueError(f"no definition of {name}")
    start, depth, i = m.start(), 0, src.index("{", m.end())
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
        i += 1


SPECTRAL_CU = (_build.CSRC / "spectral.cu").read_text()
GRU_CU = (_build.CSRC / "gru.cu").read_text()


@pytest.mark.parametrize("kernel,launch", [("spectral_chain_kernel", "chain_launch"),
                                           ("spectral_chain_mma_kernel", "chain_mma_launch")])
def test_chain_grid_takes_every_row_tile_past_the_ceiling(kernel, launch):
    """C.7: each chain kernel (f32, bf16) took one row tile a blockIdx.y, so
    past 65,535 tiles a launch was refused. Its launch now lays 2 * tiles
    blocks along x (a grid's x takes 2^31 - 1), and block x takes chain
    x % 2 of tile x / 2: the kernel reads neither blockIdx.y nor gridDim.y.
    The kernels themselves run past the ceiling on the card
    (chip_smoke.py `grid_ceiling_check`)."""
    body = _definition(SPECTRAL_CU, kernel)
    assert "const int chain = blockIdx.x & 1;" in body
    assert "(long)(blockIdx.x >> 1) *" in body
    assert "blockIdx.y" not in body and "gridDim.y" not in body
    assert "return launch_chains<kOut, true>(" in _definition(SPECTRAL_CU, launch)
    chains = _definition(SPECTRAL_CU, "launch_chains")
    assert "cfg.gridDim = kFlat ? dim3((unsigned)(2 * tiles))" in chains


def test_wide_chain_walks_its_tiles_under_the_grids_y():
    """The wide chain kernel keeps grid (2, min(tiles, 65,535)) and walks its
    row tiles in steps of gridDim.y, so it too takes any row count."""
    assert "gridDim.y" in _definition(SPECTRAL_CU, "spectral_chain_wide_kernel")
    assert ("return launch_chains<kOut, false>("
            in _definition(SPECTRAL_CU, "chain_wide_launch"))
    assert ": dim3(2, (unsigned)std::min(tiles, kMaxGridY))" in _definition(
        SPECTRAL_CU, "launch_chains")


@pytest.mark.parametrize("h", [64, 140])
@pytest.mark.parametrize("b", [262_144, 1_000_003])
def test_gru_cluster_grid_takes_any_batch(b, h):
    """The audit of C.7: the GRU cluster kernels took a batch group of 4 rows
    a blockIdx.y, so past 262,140 batch rows (the segmented GRU's B x N /
    segment) they were refused too. Their clusters now lie along x (block x
    is rank x % cluster of group x / cluster), forward and backward, on a
    grid of cluster * groups blocks, which the plans keep within a grid's
    x."""
    from stemgnn_tpu_torch.ops import cuda_gru

    for kernel in ("gru_fwd_cluster_kernel", "gru_bwd_cluster_kernel"):
        body = _definition(GRU_CU, kernel)
        assert "const int b = (int)(blockIdx.x / blocks) * R + p;" in body
        assert "blockIdx.y" not in body
    launch = _definition(GRU_CU, "launch_clustered")
    assert "cfg.gridDim = dim3((unsigned)cluster * (unsigned)groups);" in launch
    for plan in (cuda_gru.launch_plan(b, h, *H100), cuda_gru.bwd_plan(b, h, *H100)):
        assert plan.route == "cluster" and plan.groups > MAX_GRID_Y
        assert plan.cluster * plan.groups <= 2**31 - 1
        assert plan.groups * plan.rows >= b > (plan.groups - 1) * plan.rows


# --- the ring ---


@pytest.mark.parametrize("graph", [2, 4, 8])
def test_ring_attention_matches_attention_adjacency(groups, graph):
    """The ring's row blocks, joined, against the JAX package's
    attention_adjacency and its ring at the same graph axis
    (tests/test_ring.py's sizes and tolerance); rows sum to 1; its gradients
    with respect to the encoding and both weights against the port's
    autograd of attention_adjacency."""
    enc, wk, wq, gout = _ring_inputs()
    ranks = groups["ring", graph][:graph]
    got = np.concatenate([r["rows"] for r in ranks], axis=1)
    want = jnp_impl.attention_adjacency(jnp.asarray(enc), jnp.asarray(wk), jnp.asarray(wq), ALPHA)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    jring = jax_ring_attention(jax_mesh.make_mesh(1, graph), jnp.asarray(enc), jnp.asarray(wk),
                               jnp.asarray(wq), ALPHA)
    np.testing.assert_allclose(got, np.asarray(jring), atol=1e-5, rtol=1e-5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (enc, wk, wq)]
    torch.sum(torch_impl.attention_adjacency(*leaves, ALPHA) * torch.from_numpy(gout)).backward()
    for name, leaf in zip(("enc", "wk", "wq"), leaves):
        scale = float(leaf.grad.abs().max())
        np.testing.assert_allclose(ranks[0][name], leaf.grad.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_ring_refuses_an_n_graph_does_not_divide(groups):
    """As the JAX package's ring (stemgnn_tpu/parallel/ring.py:95-97): N = 30
    on graph 4 raises, in the encoding API and in a --use_ring train step."""
    mesh = port_mesh.Mesh(data=1, graph=4, rank=0, data_group=None, graph_group=None,
                          world_group=None)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(mesh, torch.zeros((1, 30, 30)), torch.zeros((30, 1)),
                       torch.zeros((30, 1)), ALPHA)
    for msg in groups["odd_ring"]:
        assert msg == "N=30 not divisible by graph axis 4"


# --- the dense model on the mesh ---


def _jax_loss_grads(data, hi, key, shape, ring):
    """The loss and gradients of the JAX package's forward on its mesh (MSE,
    f64), the dropout drawn from `key`."""
    jcfg, jmesh = JaxConfig(**DENSE), jax_mesh.make_mesh(*shape)
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _np_tree(DENSE))
    x, y = jax_engine.gather_windows(jnp.asarray(data), jnp.asarray(hi),
                                     DENSE["window_size"], DENSE["horizon"])

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, x, training=True, dropout_rng=key, mesh=jmesh,
                                   use_ring=ring)
        return jnp.mean((f - y) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(tree)
    return float(loss), flatten_params(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("ring", RINGS, ids=["rows", "ring"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_train_step_matches_one_process(groups, shape, ring):
    """The dense model's node-sharded train step (f64, dropout on the global
    [B, N, N] attention, each rank its rows): loss, every gradient and every
    parameter after one RMSProp step equal on every rank and within 1e-10 of
    the port's single process; without and with the ring."""
    _, args = cases.__dict__["train_step"], _calls(shape[0] * shape[1])["step", shape, ring][1]
    single = cases.train_step(None, *args[1:8])
    ranks = groups["step", shape, ring]
    _same_on_every_rank(ranks, f"{shape} ring={ring}")
    got = ranks[0]
    assert abs(got["loss"] - single["loss"]) <= 1e-10 * max(1.0, abs(single["loss"]))
    for k, want in single["grads"].items():
        _close(got["grads"][k], want, f"d {k}")
        _close(got["params"][k], single["params"][k], k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_train_step_takes_the_ranks_mask_rows(groups, shape):
    """Handed only its part of the step's mask (`stemgnn.mask_rows`, as the
    engine's chunk keeps it), each rank's step is bitwise the step handed the
    whole [B, N, N] mask."""
    for got, want in zip(groups["step_rows", shape], groups["step", shape, False]):
        assert got["loss"] == want["loss"]
        for k, g in want["grads"].items():
            np.testing.assert_array_equal(got["grads"][k], g, err_msg=k)


@pytest.mark.parametrize("cfg_kw,shape,rank,shard", [
    (DENSE, (1, 2), 1, True), (DENSE, (2, 2), 2, True), (DENSE, (2, 2), 1, False),
    (DENSE, (2, 1), 1, True), (ODD["dense"], (1, 4), 3, True), (ODD["stretch"], (1, 2), 1, True),
    (DENSE, None, 0, True)], ids=["1x2", "2x2", "2x2-replicated", "2x1", "odd-n", "stretch",
                                   "no-mesh"])
def test_fill_masks_keeps_the_ranks_part_of_each_draw(cfg_kw, shape, rank, shard):
    """The engine's chunk (`engine.fill_masks`) holds, of each step's draw
    from the generator or of the masks it is handed, the rank's part
    (`stemgnn.mask_rows`): [B / data, N / graph, N] of the node-sharded dense
    path, the whole [B, N, N] where 'graph' does not divide N, the whole
    [N, k] on the stretch path; the draws are the eager steps' draws."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.train import engine

    cfg = StemGNNConfig(**cfg_kw)
    mesh = None if shape is None else port_mesh.Mesh(
        data=shape[0], graph=shape[1], rank=rank, data_group=None, graph_group=None,
        world_group=None)
    batch_sharded = mesh is not None and shard and mesh.data > 1
    n, keep = 3, 1.0 - cfg.dropout_rate
    gen = torch.Generator().manual_seed(5)
    wholes = torch.stack([stemgnn.draw_dropout_mask(stemgnn.dropout_shape(cfg, B), keep, gen)
                          for _ in range(n)])
    want = wholes
    if mesh is not None and cfg.sparse_k is None:
        if batch_sharded:
            want = want[:, mesh.batch_rows(B)]
        if cfg.units % mesh.graph == 0:
            want = want[:, :, mesh.node_block(cfg.units)]
    got = torch.zeros(want.shape, dtype=torch.bool)
    engine.fill_masks(got, cfg, B, mesh, batch_sharded, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    got.zero_()
    engine.fill_masks(got, cfg, B, mesh, batch_sharded, dropout_masks=wholes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ring", RINGS, ids=["rows", "ring"])
def test_dense_train_step_matches_jax(groups, ring):
    """The (2, 2) step's loss and every gradient within 1e-10 of the JAX
    package's forward on the same mesh (value_and_grad at f64, GSPMD's
    partition or its ring), its dropout key drawing the mask the port is
    handed."""
    data, hi, _, key = _step_inputs(DENSE, B, 92)
    with jax.enable_x64():
        jloss, jgrads = _jax_loss_grads(data, hi, key, (2, 2), ring)
    got = groups["step", (2, 2), ring][0]
    assert abs(got["loss"] - jloss) <= 1e-10 * max(1.0, abs(jloss))
    for k, want in jgrads.items():
        _close(got["grads"][k], want, f"d {k}")


@pytest.mark.parametrize("ring", RINGS, ids=["rows", "ring"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_forecasts_match_one_process_and_jax(groups, shape, ring):
    """The engine's eval step (batch replicated) and eval program (batch
    sharded over 'data'): every rank holds the whole forecast, within 1e-10
    of one process's at f64; at f32 within 1e-5 of the JAX package's forward
    on the same mesh (its GSPMD partition, or its ring) and of one process's.
    The ring's eval is the dense eval's (the JAX dryrun's ring_eval rule)."""
    single = {dt: cases.eval_forecasts(None, DENSE, *_eval_inputs(dt)) for dt in
              (np.float64, np.float32)}
    for r in groups["eval", shape, ring, np.float64]:
        for name in ("step", "epoch"):
            assert r[name].shape == single[np.float64][name].shape
            _close(r[name], single[np.float64][name], name)
    flat, data, hi_matrix = _eval_inputs(np.float32)
    jcfg = JaxConfig(**DENSE)
    x, _ = jax_engine.gather_windows(jnp.asarray(data), jnp.asarray(hi_matrix[0]),
                                     DENSE["window_size"], DENSE["horizon"])
    jf, _ = jax_stemgnn.forward(_np_tree(DENSE), jcfg, x, mesh=jax_mesh.make_mesh(*shape),
                                use_ring=ring)
    for r in groups["eval", shape, ring, np.float32]:
        _close(r["step"], np.asarray(jf), "against JAX", np.float32)
        for name in ("step", "epoch"):
            _close(r[name], single[np.float32][name], name, np.float32)
        np.testing.assert_allclose(r["epoch"], single[np.float32]["epoch"], rtol=1e-3, atol=5e-4)


# --- C.9: an N that 'graph' does not divide ---


@pytest.mark.parametrize("variant", list(ODD))
def test_an_indivisible_n_runs_the_whole_model_on_every_rank(groups, variant):
    """C.9: N = 30 on (1, 4), the dense model and the stretch model: every
    rank runs the whole model on its batch rows (the JAX package's
    single-array build), and the step's loss and every gradient are one
    process's within 1e-10 (f64), on every rank."""
    kw = ODD[variant]
    data, hi, mask, _ = _step_inputs(kw, B, 93)
    single = cases.train_step(None, kw, _flat(kw, np.float64), data, hi, mask)
    ranks = groups["odd", variant]
    _same_on_every_rank(ranks, variant)
    assert abs(ranks[0]["loss"] - single["loss"]) <= 1e-10 * max(1.0, abs(single["loss"]))
    for k, want in single["grads"].items():
        _close(ranks[0]["grads"][k], want, f"d {k}")


# --- C.8: the stretch step's top-k on two ranks at f32 ---


def test_two_rank_f32_stretch_step_keeps_the_top_k_set(groups):
    """C.8 at a small stretch size (N 2048, sparse_k 32, a 32-unit GRU over
    segments of 256, batch 2, f32): the (1, 2) forward's top-k index set is
    one process's, on both ranks."""
    single = cases.sparse_topk(None, C8, *_c8_inputs())
    for r in groups["c8"]:
        assert r["idx"] == single["idx"]


# --- the CLI ---


def _tiny_csv(path, n=8, t=220):
    rng = np.random.default_rng(0)
    data = np.sin(np.arange(t)[:, None] / 7.0 + np.arange(n)) * 10 + rng.standard_normal((t, n))
    np.savetxt(path, data + 50.0, delimiter=",", header=",".join(map(str, range(n))),
               comments="")


@pytest.mark.parametrize("flags", [["--graph_axis", "2", "--data_axis", "2"],
                                   ["--graph_axis", "4", "--use_ring", "True"]],
                         ids=["2x2", "1x4-ring"])
def test_cli_on_four_gloo_ranks(tmp_path, flags):
    """`torchrun --nproc_per_node 4 -m stemgnn_tpu_torch ... --device cpu` on a
    small series of 8 nodes: one epoch and the test pass, the mesh line with
    the real ring flag on every rank, and one set of files."""
    _tiny_csv(tmp_path / "tiny.csv")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "4", "-m", "stemgnn_tpu_torch", "--dataset", "tiny", "--data_dir", str(tmp_path),
         "--output_dir", str(tmp_path / "out"), "--device", "cpu", "--window_size", "8",
         "--horizon", "3", "--multi_layer", "2", "--batch_size", "16", "--epoch", "1",
         *flags], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ring = "--use_ring" in flags
    data, graph = (1, 4) if ring else (2, 2)
    line = (f"mesh: data={data} graph={graph} devices=4 batch_sharded=True ring={ring}")
    assert out.stdout.count(line) == 4, out.stdout[-3000:]
    assert out.stdout.count("Performance on test set") == 4
    assert (tmp_path / "out" / "tiny" / "test" / "predict.csv").exists()
