"""The port's model against the JAX package (CPU): init draw, weight
converter, module and checkpoint, the whole eval forward, and the whole
training forward with every parameter gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import (
    StemGNN,
    forward,
    init_params,
    param_count,
    params_from_jax,
    params_to_jax,
)
from stemgnn_tpu_torch.models.convert import flatten_params
from stemgnn_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

N, B, W, M = 20, 3, 12, 5
CFG = StemGNNConfig(units=N, window_size=W, horizon=3, multi_layer=M)
JCFG = JaxConfig(units=N, window_size=W, horizon=3, multi_layer=M,
                 pallas_min_nodes=0)


def _leaves(tree):
    return flatten_params(tree)


@pytest.fixture(scope="module")
def np_params():
    return torch_stream_init(0, JCFG)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), tree)


def test_init_draw_equals_jax_torch_stream(np_params):
    got = _leaves(params_to_jax(init_params(0, CFG, device="cpu")))
    want = _leaves(np_params)
    assert list(got) == list(want)  # same tree, same leaf order
    for name, w_ in want.items():
        g_ = got[name]
        assert g_.shape == w_.shape and g_.dtype == np.float32, name
        if name.endswith("/weight"):
            # the one xavier_normal tensor: torch's Sleef log/cos/sin against
            # numpy's libm in the replication. Measured: at most 4 ulp of
            # the element (seeds 0 and 3, N = 20 and 140), above the 2 ulp
            # that initializers.torch_stream_init's docstring states; the
            # tensors agree within the atol 1e-6 of tests/test_torch_rng.py.
            ulp = np.spacing(np.abs(w_))
            assert np.all(np.abs(g_ - w_) <= 4 * ulp), name
            np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=name)


def test_converter_round_trip_is_identity(np_params):
    for dtype in (np.float32, np.float64):
        p = _cast(np_params, dtype)
        back = params_to_jax(params_from_jax(p, device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(p)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert "backcast" not in np_params["blocks"][1]
    assert param_count(params_from_jax(np_params, "cpu")) == sum(
        a.size for a in jax.tree.leaves(np_params))


def test_forward_f32_matches_pallas_forward(np_params):
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B, W, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jf, jatt = jax_stemgnn.forward(
            jax.tree.map(jnp.asarray, np_params), JCFG, jnp.asarray(x),
            use_pallas=True)
    with torch.inference_mode():
        tf, tatt = forward(params_from_jax(np_params, "cpu"), CFG,
                           torch.from_numpy(x))
    assert tf.shape == (B, 3, N) and tatt.shape == (N, N)
    np.testing.assert_allclose(tatt.numpy(), np.asarray(jatt), atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4)


def test_forward_f64_matches_jnp_forward(np_params):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, W, N))
    p64 = _cast(np_params, np.float64)
    with jax.enable_x64():
        jf, jatt = jax_stemgnn.forward(
            jax.tree.map(jnp.asarray, p64), JCFG, jnp.asarray(x),
            use_pallas=False)
        jf, jatt = np.asarray(jf), np.asarray(jatt)
    tf, tatt = forward(params_from_jax(p64, "cpu"), CFG, torch.from_numpy(x))
    np.testing.assert_allclose(tatt.numpy(), jatt, atol=1e-10, rtol=0)
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-10, rtol=0)


def _leaf_tree(tree):
    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def _training_loss_and_grads(np_tree, x, y, use_pallas, cfg=CFG, jcfg=JCFG):
    """Both sides' loss, forecast and parameter gradients of the training
    forward on one batch. The dropout mask is drawn here as the JAX forward
    draws it, bernoulli(rng, keep, [B, N, N]), and handed to the port: the two
    frameworks' generators give different bits from one seed."""
    rng = jax.random.PRNGKey(5)
    keep = 1.0 - jcfg.dropout_rate
    b, n = x.shape[0], cfg.units
    mask = np.asarray(jax.random.bernoulli(rng, keep, (b, n, n)))
    assert 0.3 < mask.mean() < 0.7

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, jnp.asarray(x), training=True,
                                   dropout_rng=rng, use_pallas=use_pallas)
        return jnp.mean((f - jnp.asarray(y)) ** 2), f

    (jloss, jf), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, np_tree))
    params = _leaf_tree(np_tree)
    tf, _ = forward(params, cfg, torch.from_numpy(x), training=True,
                    dropout_mask=torch.from_numpy(mask.copy()))
    tloss = torch.mean((tf - torch.from_numpy(y)) ** 2)
    tloss.backward()
    tgrads = {k: v.grad for k, v in flatten_params(params).items()}
    return (float(jloss), np.asarray(jf), flatten_params(jax.tree.map(np.asarray, jgrads)),
            float(tloss.detach()), tf.detach().numpy(), tgrads)


def test_training_forward_and_grads_f64_match_jax_grad(np_params):
    rng = np.random.default_rng(23)
    x, y = rng.standard_normal((B, W, N)), rng.standard_normal((B, 3, N))
    with jax.enable_x64():
        jloss, jf, jgrads, tloss, tf, tgrads = _training_loss_and_grads(
            _cast(np_params, np.float64), x, y, use_pallas=False)
    np.testing.assert_allclose(tf, jf, atol=1e-10, rtol=0)
    assert abs(tloss - jloss) < 1e-10
    assert list(tgrads) == list(jgrads)
    for name, want in jgrads.items():
        if name == "blocks/1/backcast_short_cut/w" or name == "blocks/1/backcast_short_cut/b":
            # stack 1's shortcut is never used: zeros from jax.grad, no
            # gradient from autograd (the train step fills in zeros)
            assert not want.any() and tgrads[name] is None
            continue
        assert tgrads[name].dtype == torch.float64
        np.testing.assert_allclose(tgrads[name].numpy(), want, atol=1e-10, rtol=0,
                                   err_msg=name)


def test_training_forward_and_grads_f32_match_pallas(np_params):
    rng = np.random.default_rng(24)
    x = rng.standard_normal((B, W, N)).astype(np.float32)
    y = rng.standard_normal((B, 3, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jloss, jf, jgrads, tloss, tf, tgrads = _training_loss_and_grads(
            np_params, x, y, use_pallas=True)
    np.testing.assert_allclose(tf, jf, atol=1e-4)
    assert abs(tloss - jloss) < 1e-5
    for name, want in jgrads.items():
        if tgrads[name] is None:
            assert not want.any(), name
            continue
        # f32 through the Pallas backward kernels (interpret mode) against the
        # port's plain backward formulas: 1e-3 of the gradient's largest entry
        atol = 1e-3 * float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(tgrads[name].numpy(), want, atol=atol, rtol=1e-3,
                                   err_msg=name)


# The README's COVID-19 command (--window_size 28 --horizon 28) at the default
# multi_layer 5: 25 nodes, D1 = 560, the JAX package's COVID-19 suite cell
# (benchmarks/suite.py) at batch 2
COVID = dict(units=25, window_size=28, horizon=28, multi_layer=5)


@pytest.mark.parametrize("dtype", ["f64_jnp", "f32_pallas"])
def test_covid_shape_training_forward_and_grads_match_jax(dtype):
    """The whole model at the COVID-19 shape, forward and every gradient,
    against the JAX package: at f64 against its jnp path (atol 1e-10), and at
    f32 against its Pallas kernels in interpret mode (forecast atol 1e-4,
    each gradient 1e-3 of its largest entry), as the flagship tests above."""
    cfg = StemGNNConfig(**COVID)
    jcfg = JaxConfig(**COVID, pallas_min_nodes=0)
    rng = np.random.default_rng(25)
    np_tree = torch_stream_init(0, jcfg)
    x = rng.standard_normal((2, 28, 25))
    y = rng.standard_normal((2, 28, 25))
    if dtype == "f64_jnp":
        with jax.enable_x64():
            jloss, jf, jgrads, tloss, tf, tgrads = _training_loss_and_grads(
                _cast(np_tree, np.float64), x, y, False, cfg, jcfg)
        atol_f, atol_l, atol_rel, rtol = 1e-10, 1e-10, 0.0, 0.0
    else:
        x, y = x.astype(np.float32), y.astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            jloss, jf, jgrads, tloss, tf, tgrads = _training_loss_and_grads(
                np_tree, x, y, True, cfg, jcfg)
        atol_f, atol_l, atol_rel, rtol = 1e-4, 1e-5, 1e-3, 1e-3
    assert tf.shape == (2, 28, 25)
    np.testing.assert_allclose(tf, jf, atol=atol_f, rtol=0)
    assert abs(tloss - jloss) < atol_l
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        if tgrads[name] is None:  # stack 1's unused shortcut
            assert not want.any(), name
            continue
        atol = atol_rel * float(np.abs(want).max()) + (1e-10 if dtype == "f64_jnp" else 1e-9)
        np.testing.assert_allclose(tgrads[name].numpy(), want, atol=atol, rtol=rtol,
                                   err_msg=name)


def test_training_dropout_needs_a_mask_or_generator(np_params):
    params = params_from_jax(np_params, "cpu")
    x = torch.zeros((B, W, N))
    with pytest.raises(ValueError, match="dropout"):
        forward(params, CFG, x, training=True)
    gen = torch.Generator().manual_seed(3)
    a, _ = forward(params, CFG, x + 1.0, training=True, dropout_generator=gen)
    gen.manual_seed(3)
    b, _ = forward(params, CFG, x + 1.0, training=True, dropout_generator=gen)
    c, _ = forward(params, CFG, x + 1.0, training=True, dropout_generator=gen)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_module_and_checkpoint_round_trip(tmp_path):
    model = StemGNN(CFG, seed=3, device="cpu")
    params = model.params()
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (B, W, N)).astype(np.float32))
    with torch.inference_mode():
        want, _ = forward(params, CFG, x)
        got, _ = model(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    path = ckpt.save(str(tmp_path), params, meta={"epoch": 4})
    assert path.endswith("/_stemgnn.ckpt")
    ckpt.save(str(tmp_path), params, epoch=4)
    assert (tmp_path / "4_stemgnn.ckpt").exists()
    assert ckpt.latest_epoch(str(tmp_path)) == 4
    loaded, opt_state, meta = ckpt.load(str(tmp_path), device="cpu")
    assert meta == {"epoch": 4} and opt_state is None
    for name, t in flatten_params(params).items():
        torch.testing.assert_close(flatten_params(loaded)[name], t.detach(),
                                   rtol=0, atol=0)
    assert ckpt.load(str(tmp_path), epoch=7, device="cpu") is None
