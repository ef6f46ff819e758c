"""The port's stretch path against the JAX package (CPU): the top-k sparse
latent graph and its feature-space Chebyshev conv (`ops/sparse.py`), the
segmented GRU, the whole stretch forward with every parameter gradient (f64
against the jnp path, f32 against the Pallas kernels in interpret mode, bf16
against `precision="bfloat16"`), the init draw at stretch shapes, the config
checks, the converters and checkpoint at H != N, the FLOP model, the bench's
rows, and the engine's chunk, which draws [N, k] dropout masks."""

import argparse
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu import data as jax_data
from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.config import TrainConfig as JaxTrainConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.ops import sparse as jax_sparse
from stemgnn_tpu.train import engine as jax_engine
from stemgnn_tpu.utils import flops as jax_flops
from stemgnn_tpu_torch import bench, ops
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig, add_cli_args, config_from_args
from stemgnn_tpu_torch.models import forward, init_params, param_count
from stemgnn_tpu_torch.models import stemgnn as port_stemgnn
from stemgnn_tpu_torch.models.convert import (
    flatten_params,
    params_from_jax,
    params_to_jax,
    unflatten_params,
)
from stemgnn_tpu_torch.ops import cuda_gru
from stemgnn_tpu_torch.ops import sparse as port_sparse
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train import engine as port_engine
from stemgnn_tpu_torch.train.optim import make_optimizer
from stemgnn_tpu_torch.utils import flops as port_flops

torch.set_num_threads(1)

# the stretch forward's test shape: 48 nodes in segments of 10 (the last one
# ragged), GRU hidden 8, top-8 graph, window 8, multi 2, batch 3
N, W, M, B, K, H, SEG = 48, 8, 2, 3, 8, 8, 10
STRETCH = dict(units=N, window_size=W, horizon=3, multi_layer=M, sparse_k=K,
               gru_hidden=H, gru_segment=SEG)
DENSE_GRU = dict(units=N, window_size=W, horizon=3, multi_layer=M, sparse_k=K)
VARIANTS = {"segmented": STRETCH, "dense_gru": DENSE_GRU}
ALPHA = 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), tree)


def _close(got, want, dtype, what, noise=0.0):
    """f64: within 1e-10; f32: within 1e-6 of the largest entry of `want`,
    plus `noise` (an array or a number) where given."""
    want = np.asarray(want)
    atol = 1e-10 if dtype == np.float64 else 1e-6 * float(np.abs(want).max()) + 1e-12
    np.testing.assert_array_less(np.abs(np.asarray(got) - want), atol + noise + 1e-30,
                                 err_msg=what)


def _kq(rng, n, dtype):
    return (rng.standard_normal(n).astype(dtype), rng.standard_normal(n).astype(dtype))


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


# --- the sparse ops ---


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_topk_latent_graph_matches_jax(dtype, dropout):
    """The same idx (as a set and in order: seeded normal data has no ties),
    c, degree and inv_sqrt as `topk_latent_graph`, and the same gradients of
    a weighted sum of the three arrays with respect to key and query. With
    dropout the [N, k] mask is the one the JAX function draws from its key.

    A row whose scores all fall on one side of LeakyReLU's kink has an exact
    key gradient of 0 (the softmax's and the degree's sums cancel), which f32
    gives as rounding noise of the summed terms, up to 2e-6 of the largest
    entry here. So at f32 each gradient entry is held to 1e-6 of the largest
    entry plus twice the JAX function's own f32 distance from its f64 result
    at that entry."""
    rng = np.random.default_rng(60)
    n, k = 40, 7
    key_vec, query_vec = _kq(rng, n, dtype)
    gc, gd, gi = (rng.standard_normal(s).astype(dtype) for s in ((n, k), n, n))
    rate = 0.5 if dropout else 0.0
    drop_key = jax.random.PRNGKey(3)

    def jax_run(dt):
        with _x64(dt):
            def jfn(kv, qv):
                g = jax_sparse.topk_latent_graph(kv, qv, ALPHA, k, dropout_rng=drop_key,
                                                 dropout_rate=rate)
                return (jnp.sum(g.c * gc.astype(dt)) + jnp.sum(g.degree * gd.astype(dt))
                        + jnp.sum(g.inv_sqrt * gi.astype(dt))), g

            (_, g), grads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
                jnp.asarray(key_vec.astype(dt)), jnp.asarray(query_vec.astype(dt)))
            return jax.tree.map(np.asarray, g), [np.asarray(d) for d in grads]

    with _x64(dtype):
        mask = np.asarray(jax.random.bernoulli(drop_key, 1.0 - rate, (n, k)))
    jg, (dk, dq) = jax_run(dtype)
    noise = [0.0, 0.0]
    if dtype == np.float32:
        _, grads64 = jax_run(np.float64)
        noise = [2.0 * np.abs(d - d64) for d, d64 in zip((dk, dq), grads64)]
    tk, tq = _t(key_vec).requires_grad_(True), _t(query_vec).requires_grad_(True)
    g = port_sparse.topk_latent_graph(tk, tq, ALPHA, k, dropout_mask=_t(mask),
                                      dropout_rate=rate)
    (torch.sum(g.c * _t(gc)) + torch.sum(g.degree * _t(gd))
     + torch.sum(g.inv_sqrt * _t(gi))).backward()
    assert set(g.idx.tolist()) == set(jg.idx.tolist())
    assert g.idx.tolist() == jg.idx.tolist()
    assert g.c.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    for name in ("c", "degree", "inv_sqrt"):
        _close(getattr(g, name).detach().numpy(), getattr(jg, name), dtype, name)
    _close(tk.grad.numpy(), dk, dtype, "d key", noise[0])
    _close(tq.grad.numpy(), dq, dtype, "d query", noise[1])
    if dropout:
        assert 0.3 < mask.mean() < 0.7


def _graph_inputs(rng, dtype, n=40, k=7, batch=3, w=5):
    key_vec, query_vec = _kq(rng, n, dtype)
    with _x64(dtype):
        jg = jax.tree.map(np.asarray, jax_sparse.topk_latent_graph(
            jnp.asarray(key_vec), jnp.asarray(query_vec), ALPHA, k))
    x = rng.standard_normal((batch, n, w)).astype(dtype)
    return jg, x


@pytest.mark.parametrize("fn", ["laplacian_apply", "sparse_cheb_conv"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_laplacian_and_cheb_conv_match_jax(dtype, fn):
    """`laplacian_apply` and `sparse_cheb_conv` on the graph of seeded key and
    query: the output and the gradients with respect to x, c, degree and
    inv_sqrt of a weighted sum of it."""
    rng = np.random.default_rng(61)
    jg, x = _graph_inputs(rng, dtype)
    jfn, tfn = getattr(jax_sparse, fn), getattr(port_sparse, fn)
    out_shape = (x.shape[0], 4) + x.shape[1:] if fn == "sparse_cheb_conv" else x.shape
    gout = rng.standard_normal(out_shape).astype(dtype)
    with _x64(dtype):
        def loss(xv, c, degree, inv_sqrt):
            g = jax_sparse.SparseLatentGraph(jnp.asarray(jg.idx), c, degree, inv_sqrt)
            y = jfn(g, xv)
            return jnp.sum(y * gout), y

        (_, jy), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (x, jg.c, jg.degree, jg.inv_sqrt)))
        jy, jgrads = np.asarray(jy), [np.asarray(a) for a in jgrads]
    leaves = [_t(a).requires_grad_(True) for a in (x, jg.c, jg.degree, jg.inv_sqrt)]
    g = port_sparse.SparseLatentGraph(_t(jg.idx).long(), *leaves[1:])
    y = tfn(g, leaves[0])
    torch.sum(y * _t(gout)).backward()
    assert y.shape == out_shape
    _close(y.detach().numpy(), jy, dtype, fn)
    for name, leaf, want in zip(("x", "c", "degree", "inv_sqrt"), leaves, jgrads):
        _close(leaf.grad.numpy(), want, dtype, f"d {name}")


def test_dense_attention_equivalent_matches_jax():
    rng = np.random.default_rng(62)
    jg, _ = _graph_inputs(rng, np.float64)
    with jax.enable_x64():
        want = np.asarray(jax_sparse.dense_attention_equivalent(
            jax.tree.map(jnp.asarray, jg), 40))
    g = port_sparse.SparseLatentGraph(_t(jg.idx).long(), *(_t(a) for a in jg[1:]))
    np.testing.assert_array_equal(port_sparse.dense_attention_equivalent(g, 40).numpy(), want)
    with pytest.raises(ValueError, match=r"k=41 > N=40"):
        port_sparse.topk_latent_graph(_t(np.zeros(40)), _t(np.zeros(40)), ALPHA, 41)


# --- the segmented GRU ---


def _gru_tree(rng, h, w, dtype):
    bound = 1.0 / np.sqrt(h)
    return {name: rng.uniform(-bound, bound, shape).astype(dtype) for name, shape in (
        ("w_ih", (3 * h, w)), ("w_hh", (3 * h, h)), ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}


@pytest.mark.parametrize("seg", [5, 0], ids=["ragged_segments", "one_segment"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_segmented_gru_matches_jax(dtype, seg):
    """`gru_over_nodes_segmented` (N = 12 in segments of 5, the last one of
    2 nodes; and seg 0, one segment of 12) through `_GruScan`'s plain route
    (its saving forward and plain backward): enc [B, N, H] and the gradients
    of a weighted sum of it with respect to x and the four GRU tensors,
    against the JAX function and jax.grad (f64 within 1e-10, f32 within 1e-6
    of each largest entry)."""
    rng = np.random.default_rng(63)
    b, w, n, h = 3, 4, 12, 6
    tree = _gru_tree(rng, h, w, dtype)
    x = rng.standard_normal((b, w, n)).astype(dtype)
    g_out = rng.standard_normal((b, n, h)).astype(dtype)
    with _x64(dtype):
        def loss(p, xv):
            enc = jax_stemgnn.gru_over_nodes_segmented(p, xv, h, seg)
            return jnp.sum(enc * g_out), enc

        (_, jenc), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        jenc, jgx = np.asarray(jenc), np.asarray(jgx)
        jgp = jax.tree.map(np.asarray, jgp)
    tp = {k: _t(v).requires_grad_(True) for k, v in tree.items()}
    tx = _t(x).requires_grad_(True)
    enc = cuda_gru.gru_over_nodes_segmented(tp, tx, seg)
    torch.sum(enc * _t(g_out)).backward()
    assert enc.shape == (b, n, h)
    _close(enc.detach().numpy(), jenc, dtype, "enc")
    _close(tx.grad.numpy(), jgx, dtype, "d x")
    for name, leaf in tp.items():
        _close(leaf.grad.numpy(), jgp[name], dtype, f"d {name}")
    with torch.no_grad():  # the serving route: the plain recurrence alone
        np.testing.assert_array_equal(
            cuda_gru.gru_over_nodes_segmented(tp, tx, seg).numpy(), enc.detach().numpy())


def test_fold_segments_is_the_jax_layout():
    """Row s * B + b of the fold is segment s of batch element b, zero-padded
    past N, and unfold is its inverse on the node axis."""
    x = torch.arange(2 * 3 * 7, dtype=torch.float64).reshape(2, 3, 7)
    folded = cuda_gru.fold_segments(x, 3)  # 3 segments
    assert folded.shape == (6, 3, 3)
    for s in range(3):
        for b in range(2):
            seg = x[b, :, 3 * s: 3 * s + 3]
            assert torch.equal(folded[s * 2 + b, :, : seg.shape[1]], seg)
    assert not folded[4:, :, 1:].any()
    out = folded.transpose(1, 2)  # [S*B, seg, W] as a recurrence's output
    assert torch.equal(cuda_gru.unfold_segments(out, 2, 7), x.transpose(1, 2))


# --- the whole stretch forward and its gradients ---


def _leaf_tree(tree):
    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def _train_both(variant, np_tree, x, y, use_pallas, precision="float32"):
    """Loss, forecast and every parameter gradient of the training forward on
    one batch, both sides, with the [N, k] dropout mask the JAX forward draws
    from its key (bernoulli(key, keep, C's shape)) handed to the port."""
    cfg, jcfg = StemGNNConfig(**VARIANTS[variant]), JaxConfig(**VARIANTS[variant],
                                                              pallas_min_nodes=0)
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.dropout_rate, (N, K)))
    assert 0.3 < mask.mean() < 0.7

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, jnp.asarray(x), training=True, dropout_rng=key,
                                   use_pallas=use_pallas, precision=precision)
        return jnp.mean((f - jnp.asarray(y)) ** 2), f

    (jloss, jf), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, np_tree))
    params = _leaf_tree(np_tree)
    tf, graph = forward(params, cfg, _t(x), training=True, dropout_mask=_t(mask),
                        compute_dtype=precision)
    tloss = torch.mean((tf - _t(y)) ** 2)
    tloss.backward()
    assert isinstance(graph, port_sparse.SparseLatentGraph) and graph.c.shape == (N, K)
    tgrads = {k: v.grad for k, v in flatten_params(params).items()}
    return (float(jloss), np.asarray(jf), flatten_params(jax.tree.map(np.asarray, jgrads)),
            float(tloss.detach()), tf.detach().numpy(), tgrads)


def _np_tree(variant):
    return torch_stream_init(0, JaxConfig(**VARIANTS[variant], pallas_min_nodes=0))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stretch_forward_and_grads_f64_match_jnp(variant):
    """The training forward and every parameter gradient at f64 against the
    JAX package's jnp path (use_pallas=False): within 1e-10."""
    rng = np.random.default_rng(64)
    x, y = rng.standard_normal((B, W, N)), rng.standard_normal((B, 3, N))
    with jax.enable_x64():
        jloss, jf, jgrads, tloss, tf, tgrads = _train_both(
            variant, _cast(_np_tree(variant), np.float64), x, y, use_pallas=False)
    np.testing.assert_allclose(tf, jf, atol=1e-10, rtol=0)
    assert abs(tloss - jloss) < 1e-10
    assert list(tgrads) == list(jgrads)
    for name, want in jgrads.items():
        if tgrads[name] is None:  # stack 1's unused shortcut
            assert not want.any(), name
            continue
        assert tgrads[name].dtype == torch.float64
        np.testing.assert_allclose(tgrads[name].numpy(), want, atol=1e-10, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stretch_forward_and_grads_f32_match_pallas(variant):
    """The same at f32 against `stemgnn.forward(..., use_pallas=True)` with
    pallas_min_nodes=0 in interpret mode (the spectral kernels; the dense-GRU
    variant's GRU kernel too; the segmented GRU is a lax.scan there):
    forecast within 1e-4, loss within 1e-5, each gradient within 1e-3 of its
    largest entry."""
    rng = np.random.default_rng(65)
    x = rng.standard_normal((B, W, N)).astype(np.float32)
    y = rng.standard_normal((B, 3, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jloss, jf, jgrads, tloss, tf, tgrads = _train_both(
            variant, _np_tree(variant), x, y, use_pallas=True)
    np.testing.assert_allclose(tf, jf, atol=1e-4)
    assert abs(tloss - jloss) < 1e-5
    for name, want in jgrads.items():
        if tgrads[name] is None:
            assert not want.any(), name
            continue
        atol = 1e-3 * float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(tgrads[name].numpy(), want, atol=atol, rtol=1e-3,
                                   err_msg=name)


def _l2(got, want):
    return float(np.sqrt(sum(np.sum((np.asarray(g) - np.asarray(w)) ** 2)
                             for g, w in zip(got, want))))


def test_stretch_bf16_forward_and_grads_match_pallas():
    """At compute_dtype "bfloat16" (on the stretch path it reaches only the
    spectral cell) against `stemgnn.forward(..., use_pallas=True,
    precision="bfloat16")` in interpret mode, by the rule of
    tests/test_torch_port_bf16.py `test_model_bf16_forward_and_grads_match_pallas`:
    forecast within 1e-5 and 5 times closer to it than to the f32 forward,
    loss within 1e-5, each gradient within 3e-3 of its largest entry and in
    L2 over all of them 5 times closer than to the f32 gradients."""
    rng = np.random.default_rng(66)
    x = rng.standard_normal((B, W, N)).astype(np.float32)
    y = rng.standard_normal((B, 3, N)).astype(np.float32)
    np_tree = _np_tree("segmented")
    with pltpu.force_tpu_interpret_mode():
        with jax.default_matmul_precision("bfloat16"):
            jloss, jf, jgrads, tloss, tf, tgrads = _train_both(
                "segmented", np_tree, x, y, use_pallas=True, precision="bfloat16")
        with jax.default_matmul_precision("float32"):
            _, jf32, jgrads32, *_ = _train_both("segmented", np_tree, x, y, use_pallas=True)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    assert _l2([tf], [jf32]) >= 5.0 * _l2([tf], [jf])
    assert abs(tloss - jloss) < 1e-5
    got, want, want32 = [], [], []
    for name, grad in tgrads.items():
        if grad is None:
            assert not jgrads[name].any(), name
            continue
        w = jgrads[name]
        np.testing.assert_allclose(grad.numpy(), w, rtol=0,
                                   atol=3e-3 * float(np.abs(w).max()) + 1e-9, err_msg=name)
        got.append(grad.numpy())
        want.append(w)
        want32.append(jgrads32[name])
    assert _l2(got, want32) >= 5.0 * _l2(got, want)


def test_sparse_full_k_matches_the_dense_forward():
    """sparse_k = N at batch 1 (where the batch mean is exact) is the dense
    forward, up to the two paths' sums (the JAX package's
    `test_forward_sparse_full_k_matches_dense` tolerance)."""
    n, w, h = 12, 8, 3
    dense = StemGNNConfig(units=n, window_size=w, horizon=h, multi_layer=2)
    full = StemGNNConfig(units=n, window_size=w, horizon=h, multi_layer=2, sparse_k=n)
    params = init_params(0, dense, device="cpu")
    x = _t(np.random.default_rng(67).standard_normal((1, w, n)).astype(np.float32))
    with torch.inference_mode():
        f_dense, att = forward(params, dense, x)
        f_sparse, g = forward(params, full, x)
    np.testing.assert_allclose(f_sparse.numpy(), f_dense.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(port_sparse.dense_attention_equivalent(g, n).numpy(),
                               att.numpy(), rtol=2e-3, atol=2e-4)


def test_training_dropout_is_an_nk_mask():
    """A stretch training forward needs a mask or a generator; the mask it
    draws is [N, k], and the same generator state gives the same forecast."""
    cfg = StemGNNConfig(**STRETCH)
    params = init_params(0, cfg, device="cpu")
    x = torch.ones((B, W, N))
    with pytest.raises(ValueError, match="dropout"):
        forward(params, cfg, x, training=True)
    with pytest.raises(RuntimeError):  # a [B, N, N] mask does not fit C
        forward(params, cfg, x, training=True,
                dropout_mask=torch.ones((B, N, N), dtype=torch.bool))
    assert port_stemgnn.dropout_shape(cfg, B) == (N, K)
    assert port_stemgnn.dropout_shape(StemGNNConfig(units=N), B) == (B, N, N)
    gen = torch.Generator().manual_seed(3)
    a, _ = forward(params, cfg, x, training=True, dropout_generator=gen)
    gen.manual_seed(3)
    mask = port_stemgnn.draw_dropout_mask((N, K), 0.5, gen)
    b, _ = forward(params, cfg, x, training=True, dropout_mask=mask)
    assert torch.equal(a, b)


# --- init, config, converters, checkpoint ---


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_draw_at_stretch_shapes_equals_torch_stream_init(variant):
    """`init_params` at H != N (and the dense-GRU variant's H = N) equals the
    JAX package's `torch_stream_init` at the same shapes: bitwise for the
    uniforms, within 4 ulp for the xavier_normal weight (the rule of
    tests/test_torch_port_model.py)."""
    want = flatten_params(_np_tree(variant))
    got = flatten_params(params_to_jax(init_params(0, StemGNNConfig(**VARIANTS[variant]),
                                                   device="cpu")))
    assert list(got) == list(want)
    h = H if variant == "segmented" else N
    assert got["gru/w_hh"].shape == (3 * h, h) and got["weight_key"].shape == (h, 1)
    for name, w_ in want.items():
        g_ = got[name]
        assert g_.shape == w_.shape and g_.dtype == np.float32, name
        if name.endswith("/weight"):
            assert np.all(np.abs(g_ - w_) <= 4 * np.spacing(np.abs(w_))), name
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=name)


@pytest.mark.parametrize("kw,message", [
    (dict(gru_hidden=8), "gru_hidden (the decoupled stretch GRU) requires sparse_k"),
    (dict(sparse_k=4, gru_segment=5), "gru_segment requires gru_hidden"),
], ids=["gru_hidden_without_sparse_k", "gru_segment_without_gru_hidden"])
def test_config_errors_carry_the_jax_messages(kw, message):
    with pytest.raises(ValueError) as jerr:
        JaxConfig(units=N, **kw)
    with pytest.raises(ValueError) as terr:
        StemGNNConfig(units=N, **kw)
    assert str(terr.value) == str(jerr.value) and str(terr.value).startswith(message)


def test_cli_flags_and_model_config_keep_the_jax_names():
    """--sparse_k, --gru_hidden and --gru_segment parse with the JAX package's
    names and defaults (0: unset), and model_config maps 0 to None as it does."""
    for name in ("sparse_k", "gru_hidden", "gru_segment"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name) == 0
    assert TrainConfig().model_config(N) == StemGNNConfig(units=N)
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    cfg = config_from_args(parser.parse_args(
        ["--sparse_k", "8", "--gru_hidden", "16", "--gru_segment", "35"]))
    jcfg = JaxTrainConfig(sparse_k=8, gru_hidden=16, gru_segment=35).model_config(140)
    mcfg = cfg.model_config(140)
    assert (mcfg.sparse_k, mcfg.gru_hidden, mcfg.gru_segment) == (
        jcfg.sparse_k, jcfg.gru_hidden, jcfg.gru_segment) == (8, 16, 35)


def test_converters_and_checkpoint_round_trip_at_stretch_shapes(tmp_path):
    np_tree = _np_tree("segmented")
    for dtype in (np.float32, np.float64):
        p = _cast(np_tree, dtype)
        back = params_to_jax(params_from_jax(p, device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(p)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    params = params_from_jax(np_tree, "cpu")
    assert params["gru"]["w_ih"].shape == (3 * H, W)
    assert param_count(params) == sum(a.size for a in jax.tree.leaves(np_tree))
    ckpt.save(str(tmp_path), params, epoch=0)
    loaded, _, _ = ckpt.load(str(tmp_path), epoch=0, device="cpu")
    for name, t in flatten_params(params).items():
        assert torch.equal(flatten_params(loaded)[name], t), name
    cfg = StemGNNConfig(**STRETCH)
    x = _t(np.random.default_rng(68).standard_normal((B, W, N)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(forward(loaded, cfg, x)[0], forward(params, cfg, x)[0])


def test_kernel_grad_leaves_of_the_segmented_gru():
    """Over bf16 parameters the leaves a kernel's Function differentiates get
    f32 copies: the GRU's w_hh and b_hh on the dense GRU (the JAX package's
    Pallas GRU returns f32 gradients), not on the segmented one (a lax.scan
    there)."""
    for variant, gru_leaf in (("segmented", False), ("dense_gru", True)):
        cfg = StemGNNConfig(**VARIANTS[variant])
        assert port_stemgnn.kernel_grad_leaf("gru/w_hh", cfg) is gru_leaf
        assert port_stemgnn.kernel_grad_leaf("blocks/0/glu/3/left/w", cfg)
        assert not port_stemgnn.kernel_grad_leaf("gru/w_ih", cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_dtype_bf16_gradient_dtypes_match_jax(variant):
    """At param_dtype "bfloat16" the engine's train step hands the optimizer
    each gradient in the dtype jax.grad gives it on the JAX package's Pallas
    path (interpret mode): gru/w_hh and gru/b_hh f32 on the dense GRU (the
    Pallas GRU's custom_vjp), bf16 on the segmented one (a lax.scan there);
    the GLU tensors f32 and every other leaf bf16 on both. Each gradient
    within 1e-3 of its largest entry (the f32 stretch rule above), a bf16 one
    plus one bf16 ulp of it (one f32 value rounded on either side); but the
    segmented GRU's gru/w_hh and gru/b_hh, whose cotangents the JAX package's
    scan adds up step by step in the leaf's bf16 (the port sums its f32
    gradient over the steps and rounds once): each of the SEG additions
    rounds by up to half a bf16 ulp of a running sum, so those two within
    SEG / 2 * 2^-8 of their largest entry more (measured: 8.2e-3 of it,
    against 1.95e-2)."""
    cfg, jcfg = StemGNNConfig(**VARIANTS[variant]), JaxConfig(**VARIANTS[variant],
                                                              pallas_min_nodes=0)
    rng = np.random.default_rng(70)
    data = rng.standard_normal((40, N)).astype(np.float32)
    hi = np.array([14, 20, 26])
    key = jax.random.PRNGKey(4)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.dropout_rate, (N, K)))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), _np_tree(variant))
    x = np.stack([data[h - W:h] for h in hi])
    y = np.stack([data[h:h + 3] for h in hi])

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, jnp.asarray(x), training=True, dropout_rng=key,
                                   use_pallas=True)
        return jnp.mean((f - jnp.asarray(y)) ** 2)

    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    jgrads = flatten_params(jgrads)
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")).items()}
    opt = make_optimizer("RMSProp", flat.values(), 1e-4)
    handed, real_step = [], opt.step
    opt.step = lambda grads: (handed.append([g.clone() for g in grads]), real_step(grads))
    loss = port_engine.make_train_step(cfg, opt, flat.values())(
        unflatten_params(flat), _t(data), _t(hi), dropout_mask=_t(mask))
    assert abs(float(loss) - float(jloss)) < 1e-5
    grads = dict(zip(flat, handed[0]))
    f32_leaves = [k for k, g in jgrads.items() if g.dtype == jnp.float32]
    assert ("gru/w_hh" in f32_leaves) is (variant == "dense_gru")
    assert f32_leaves == [k for k in flat if port_stemgnn.kernel_grad_leaf(k, cfg)]
    for k, g in grads.items():
        want = np.asarray(jnp.asarray(jgrads[k], jnp.float32))
        assert str(g.dtype).split(".")[-1] == str(jgrads[k].dtype), k
        tol = 1e-3 * float(np.abs(want).max()) + 1e-12
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * np.abs(want)
        if g.dtype == torch.bfloat16 and k in ("gru/w_hh", "gru/b_hh"):
            tol = tol + SEG / 2 * 2.0 ** -8 * float(np.abs(want).max())
        assert np.all(np.abs(g.float().numpy() - want) <= tol), k


# --- FLOPs and the bench ---


@pytest.mark.parametrize("kw", [
    dict(units=102400, multi_layer=2, sparse_k=64, gru_hidden=64, gru_segment=1024),
    dict(units=4096, sparse_k=64), dict(units=140)],
    ids=["synthetic-100k-seggru", "synthetic-4k-sparse64", "ECG"])
def test_forward_flops_match_jax(kw):
    for batch in (1, 4):
        assert port_flops.forward_flops(StemGNNConfig(**kw), batch) == \
            jax_flops.forward_flops(JaxConfig(**kw), batch)


def _suite_large_configs():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "suite.py"
    spec = importlib.util.spec_from_file_location("jax_suite", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LARGE_CONFIGS


def test_bench_configs_are_the_jax_suite_rows():
    """Each row of the bench's CONFIGS is the JAX suite's LARGE_CONFIGS row of
    that name (a dense row has no sparse fields there)."""
    suite = _suite_large_configs()
    for name, row in bench.CONFIGS.items():
        want = tuple(suite[name]) + (None, None, 0)[len(suite[name]) - 5:]
        assert row == want[:8], name
    kw = bench.config_kwargs("synthetic-100k-seggru")
    assert (kw["n_nodes"], kw["multi"], kw["batch"], kw["sparse_k"], kw["gru_hidden"],
            kw["gru_segment"]) == (102400, 2, 1, 64, 64, 1024)


def test_measure_runs_a_stretch_row_on_the_cpu():
    """bench.measure and measure_eval take the stretch fields: a tiny stretch
    model on the CPU gives a finite loss and the result carries sparse_k."""
    kw = dict(batch=1, steps=2, n_nodes=30, multi=2, chunk_steps=2, repeats=3,
              max_extra_repeats=0, device="cpu", sparse_k=4, gru_hidden=6, gru_segment=8)
    res = bench.measure(**kw)
    assert res["sparse_k"] == 4 and np.isfinite(res["loss"])
    assert res["edges_per_s"] == pytest.approx(1 * 3 * 30 * 30 * 2 / (res["step_time_ms"] / 1e3))
    assert res["mfu"]["model_flops_per_step"] == port_flops.train_step_flops(
        StemGNNConfig(units=30, multi_layer=2, sparse_k=4, gru_hidden=6, gru_segment=8), 1)
    assert bench.measure_eval(**kw)["windows_per_s"] > 0


def test_bench_main_takes_a_config(monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"windows_per_s": 10.0, "step_time_ms": 100.0, "step_time_ms_min": 99.0,
                "step_time_ms_max": 101.0, "repeats": 3, "spread": 0.02, "chunk_steps": 64,
                "device": "cpu", "power_limit": None}

    monkeypatch.setattr(bench, "measure_eval", fake)
    bench.main(["--mode", "eval", "--config", "synthetic-100k-seggru", "--bf16"])
    line = json.loads(capsys.readouterr().out.strip())
    assert seen["n_nodes"] == 102400 and seen["batch"] == 1 and seen["gru_segment"] == 1024
    assert seen["compute_dtype"] == "bfloat16"
    assert line["extras"]["config"] == "synthetic-100k-seggru"
    with pytest.raises(SystemExit):
        bench.main(["--config", "synthetic-100k-seggru", "--set-baseline"])


# --- the engine ---


def test_chunk_draws_nk_masks_as_the_eager_steps_do(monkeypatch):
    """The engine's chunk on the CPU's eager route, stretch model: the masks it
    draws are [N, k], from the generator the eager steps draw from, so the
    chunk and the same steps taken one by one give the same bits; handed
    masks [n, N, k] are used as they are."""
    cfg = StemGNNConfig(**STRETCH)
    rng = np.random.default_rng(69)
    data = _t(rng.standard_normal((40, N)).astype(np.float32))
    hi_matrix = torch.from_numpy(rng.integers(W, 37, size=(3, 2)))
    shapes = []
    draw = port_stemgnn.draw_dropout_mask

    def spy(shape, keep, generator):
        shapes.append(tuple(shape))
        return draw(shape, keep, generator)

    monkeypatch.setattr(port_stemgnn, "draw_dropout_mask", spy)
    runs = {}
    for mode in ("chunk", "eager", "masks"):
        flat = {k: v.requires_grad_(True)
                for k, v in flatten_params(init_params(0, cfg, device="cpu")).items()}
        params = unflatten_params(flat)
        opt = make_optimizer("RMSProp", flat.values(), 1e-3)
        gen = torch.Generator().manual_seed(11)
        if mode == "chunk":
            losses = port_engine.make_epoch_fn(cfg, opt, flat.values())(
                params, data, hi_matrix, gen)
        elif mode == "eager":
            step = port_engine.make_train_step(cfg, opt, flat.values())
            losses = torch.stack([step(params, data, hi, gen) for hi in hi_matrix])
        else:
            masks = torch.stack([draw((N, K), 0.5, gen) for _ in range(3)])
            losses = port_engine.make_epoch_fn(cfg, opt, flat.values())(
                params, data, hi_matrix, dropout_masks=masks)
        runs[mode] = (losses, {k: v.detach().clone() for k, v in flat.items()})
    assert shapes == [(N, K)] * 6
    for mode in ("eager", "masks"):
        assert torch.equal(runs[mode][0], runs["chunk"][0]), mode
        for k, v in runs["chunk"][1].items():
            assert torch.equal(runs[mode][1][k], v), (mode, k)


def test_train_two_epochs_matches_jax_engine_on_the_stretch_path(tmp_path):
    """engine.train on the stretch path (sparse_k 3, gru_hidden 4, segments
    of 4 of 6 nodes), same init draw and batch order, no dropout: the epoch
    losses and validation metrics agree with the JAX engine's (jnp path)."""
    ops.reset_launches()  # the counts of other tests in this process
    data = jax_data.synthesize("tiny", T=220, N=6, seed=0)
    train, valid, test = jax_data.split_by_ratio(data, 7, 2, 1)
    common = dict(dataset="tiny", window_size=8, horizon=3, epoch=2, batch_size=16,
                  multi_layer=2, validate_freq=1, lr=1e-3, dropout_rate=0.0,
                  sparse_k=3, gru_hidden=4, gru_segment=4)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jmetrics, _ = jax_engine.train(train, valid, JaxTrainConfig(ckpt_async=False, **common),
                                   jout)
    pmetrics, _ = port_engine.train(train, valid, TrainConfig(device="cpu", **common), pout)

    def events(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    je, pe = events(jout), events(pout)
    assert [e["event"] for e in pe] == [e["event"] for e in je]
    for a, b in zip(pe, je):
        if a["event"] == "epoch":
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        else:
            for k in ("mae", "rmse", "mape"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pmetrics["mae"], jmetrics["mae"], rtol=1e-4)
    cfg = TrainConfig(device="cpu", **common)
    metrics = port_engine.test(test, cfg, pout, str(tmp_path / "port_test"))
    assert np.isfinite(metrics["mae"])
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
