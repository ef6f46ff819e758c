"""The port's backward formulas and autograd wiring against the JAX package
(CPU).

- Each plain backward (what a backward wrapper runs on CPU tensors, and what
  the CUDA kernel is held against on the card) against the JAX function it
  mirrors, run as tests/test_pallas_kernels.py runs the Pallas kernels: in
  interpret mode at float32.
- Each autograd.Function's gradients against jax.grad of the jnp twin at
  float64, atol 1e-10, and torch.autograd.gradcheck at float64.
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.ops import jnp_impl, pallas_attention, pallas_gru, pallas_spectral
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.models.convert import params_from_jax
from stemgnn_tpu_torch.ops import cuda_spectral, torch_impl

torch.set_num_threads(1)

W, M, ALPHA = 12, 5, 0.2


def _np_params(n):
    return torch_stream_init(0, JaxConfig(units=n, window_size=W, horizon=3,
                                          multi_layer=M, pallas_min_nodes=0))


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _leaf_tree(tree):
    """numpy tree -> torch tree whose leaves require a gradient."""
    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_tree(v) for v in tree]
    return _t(tree, grad=True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad.numpy()


def _assert_trees_close(got, want, **tol):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g_, w_ in zip(got_l, want_l):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w_), **tol)


# --- (a) plain backward formulas against the Pallas backward kernels, f32 ---


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def test_gru_plain_backward_matches_pallas_vjp(interpret):
    n, b = 10, 3
    rng = np.random.default_rng(30)
    gru = _np_params(n)["gru"]
    x = rng.standard_normal((b, W, n)).astype(np.float32)
    g = rng.standard_normal((b, n, n)).astype(np.float32)  # cotangent of [B, N, H]

    # the JAX package's layouts: x_proj [N, 3, B, H], a3 [3, H, H], bh3 [3, 1, H]
    xs = np.transpose(x, (2, 0, 1))
    x_proj = np.einsum("nbw,gw->nbg", xs, gru["w_ih"]) + gru["b_ih"]
    x_proj_j = np.transpose(x_proj.reshape(n, b, 3, n), (0, 2, 1, 3))
    a3 = np.transpose(gru["w_hh"].reshape(3, n, n), (0, 2, 1))
    bh3 = gru["b_hh"].reshape(3, 1, n)
    hs, res = pallas_gru._vjp_fwd(jnp.asarray(x_proj_j), jnp.asarray(a3),
                                  jnp.asarray(bh3))
    want_dxp, want_da3, want_dbh3 = pallas_gru._vjp_bwd(
        res, jnp.asarray(np.transpose(g, (1, 0, 2))))

    a_all = _t(gru["w_hh"]).T.contiguous()
    out, saved = torch_impl.gru_scan(_t(x_proj.astype(np.float32)), a_all,
                                     _t(gru["b_hh"]), save=True)
    # the saved-tensor contract: (r, z, hpn, c, h_prev - c), [N, 5, B, H]
    np.testing.assert_allclose(saved.numpy(), np.asarray(res[2]), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(hs), (1, 0, 2)),
                               atol=1e-5)
    dxp = ops.gru_scan_bwd(saved, _t(g), a_all)  # [N, B, 3H]
    dw, db = torch_impl.gru_weight_grads(saved, out, dxp)
    # f32, 10 dependent steps: 1e-5 absolute on gradients of order 1
    np.testing.assert_allclose(
        np.transpose(dxp.numpy().reshape(n, b, 3, n), (0, 2, 1, 3)),
        np.asarray(want_dxp), atol=1e-5)
    np.testing.assert_allclose(
        np.transpose(dw.numpy().reshape(n, 3, n), (1, 0, 2)), np.asarray(want_da3),
        atol=1e-4)
    np.testing.assert_allclose(db.numpy().reshape(3, 1, n), np.asarray(want_dbh3),
                               atol=1e-4)


@pytest.mark.parametrize("n", [10, 150], ids=["one_tile", "two_row_tiles"])
def test_attention_plain_backward_matches_pallas_bwd(interpret, n):
    b = 3
    rng = np.random.default_rng(31)
    key = rng.standard_normal((b, n)).astype(np.float32)
    query = rng.standard_normal((b, n)).astype(np.float32)
    g = rng.standard_normal((b, n, n)).astype(np.float32)
    p = pallas_attention._forward_kq(jnp.asarray(key), jnp.asarray(query), ALPHA)
    want = pallas_attention._bwd(ALPHA, (jnp.asarray(key), jnp.asarray(query), p),
                                 jnp.asarray(g))
    got = ops.attention_kq_bwd(_t(key), _t(query), _t(np.asarray(p)), _t(g), ALPHA)
    for g_, w_ in zip(got, want):  # sums of n terms below 1 in magnitude
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5)


@pytest.mark.parametrize("b,n", [(3, 10), (4, 40)],
                         ids=["one_row_block", "two_row_blocks"])
def test_spectral_plain_backward_matches_pallas_backward(interpret, b, n):
    rng = np.random.default_rng(32)
    glu = _np_params(n)["blocks"][0]["glu"]
    x = rng.standard_normal((b, 4, n, W)).astype(np.float32)
    g = rng.standard_normal((b, 4, n, W * M)).astype(np.float32)
    assert (b * n > pallas_spectral.BWD_ROW_TILE) == (n == 40)
    want_dx, want_dglu = pallas_spectral._backward(
        jnp.asarray(x), _jnp(glu), jnp.asarray(g), M)
    dx, dglu = ops.spe_seq_cell_bwd(_t(x), params_from_jax(glu, "cpu"), _t(g), M)
    # f32 sums over b*n rows and 240 columns in another order
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5, rtol=1e-4)
    assert [sorted(d) for d in dglu] == [["left", "right"]] * 6
    for i in range(6):  # each leaf against the JAX pytree's
        for side in ("left", "right"):
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    dglu[i][side][leaf].numpy(),
                    np.asarray(want_dglu[i][side][leaf]), atol=2e-4, rtol=1e-4,
                    err_msg=f"glu {i} {side} {leaf}")


# --- (b) the autograd.Functions against jax.grad of the jnp twins, f64 ---


def _function_case(name):
    """(torch fn of leaf tensors, jax fn of arrays, numpy inputs)."""
    n, b = 8, 3
    rng = np.random.default_rng(40)
    p = _cast(_np_params(n), np.float64)
    if name == "gru":
        gru = p["gru"]
        args = [gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"],
                rng.standard_normal((b, W, n))]
        keys = ("w_ih", "w_hh", "b_ih", "b_hh")
        return (lambda *a: ops.gru_over_nodes(dict(zip(keys, a[:4])), a[4]),
                lambda *a: jax_stemgnn.gru_over_nodes(dict(zip(keys, a[:4])), a[4]),
                args)
    if name == "attention":
        args = [rng.standard_normal((b, n)), rng.standard_normal((b, n))]
        return (lambda k, q: ops.attention_kq(k, q, ALPHA),
                lambda k, q: jnp_impl.attention_from_kq(k, q, ALPHA), args)
    if name == "graph":
        args = [rng.standard_normal((4, n, n)) * 0.1, rng.standard_normal((b, n, W))]
        return ops.cheb_graph_conv, jnp_impl.cheb_graph_conv, args
    glu = p["blocks"][1]["glu"]
    flat = [glu[i][s][leaf] for i in range(6) for s in ("left", "right")
            for leaf in ("w", "b")]
    args = [rng.standard_normal((b, 4, n, W))] + flat

    def unflat(t):
        return [{"left": {"w": t[4 * i], "b": t[4 * i + 1]},
                 "right": {"w": t[4 * i + 2], "b": t[4 * i + 3]}} for i in range(6)]

    return (lambda x, *t: ops.spe_seq_cell(x, unflat(t), M),
            lambda x, *t: jnp_impl.spe_seq_cell(x, unflat(t), M), args)


FUNCTIONS = ["gru", "attention", "graph", "spectral"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_grads_match_jax_grad_at_f64(name):
    tfn, jfn, args = _function_case(name)
    with jax.enable_x64():
        out = jfn(*[jnp.asarray(a) for a in args])
        cot = np.random.default_rng(41).standard_normal(out.shape)
        want = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                        argnums=tuple(range(len(args))))(*[jnp.asarray(a) for a in args])
        want = [np.asarray(w_) for w_ in want]
    targs = [_t(a, grad=True) for a in args]
    tout = tfn(*targs)
    assert tout.grad_fn is not None and "Backward" in type(tout.grad_fn).__name__
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=1e-10)
    (tout * _t(cot)).sum().backward()
    for t_, w_ in zip(targs, want):
        assert t_.grad.dtype == torch.float64
        np.testing.assert_allclose(t_.grad.numpy(), w_, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_gradcheck_at_f64(name):
    tfn, _, args = _function_case(name)
    if name == "spectral":  # gradcheck perturbs every entry: keep the widths small
        n, b, w, m = 3, 2, 4, 2
        rng = np.random.default_rng(42)
        dims = [(4 * w, 4 * w * m)] * 2 + [(4 * w * m, 4 * w * m)] * 4
        flat = []
        for d_in, d_out in dims:
            for _ in range(2):
                flat += [rng.standard_normal((d_in, d_out)) * 0.3,
                         rng.standard_normal(d_out) * 0.3]
        args = [rng.standard_normal((b, 4, n, w))] + flat
        tfn = lambda x, *t: ops.spe_seq_cell(x, cuda_spectral._unflat(t), m)  # noqa: E731
    targs = [_t(a, grad=True) for a in args]
    assert torch.autograd.gradcheck(tfn, targs, eps=1e-6, atol=1e-6, rtol=1e-4)


def test_no_grad_calls_skip_the_functions():
    """Without a gradient to record, the wrappers return plain results with no
    autograd node, as the serving path needs."""
    tfn, _, args = _function_case("attention")
    out = tfn(*[_t(a) for a in args])
    assert out.grad_fn is None
    with torch.no_grad():
        out = tfn(*[_t(a, grad=True) for a in args])
    assert out.grad_fn is None


def test_backward_wrappers_are_counted_kernels_and_cpu_launches_none():
    assert list(ops.KERNELS) == [
        "gru_fwd", "gru_fwd_grid", "attention_kq_fwd", "cheb_graph_conv_fwd",
        "spectral_fwd",
        "gru_bwd", "gru_bwd_grid", "attention_kq_bwd", "spectral_bwd", "spectral_fwd_save",
        "spectral_bwd_reread", "spectral_fwd_save_bf16acts", "spectral_bwd_reread_bf16acts",
        "cheb_graph_conv_fwd_bf16", "spectral_fwd_bf16",
        "spectral_fwd_save_bf16", "spectral_bwd_bf16", "spectral_bwd_reread_bf16"]
    ops.reset_launches()
    for name in FUNCTIONS:
        tfn, _, args = _function_case(name)
        tfn(*[_t(a, grad=True) for a in args]).sum().backward()
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
