"""The port's bf16 arm (compute_dtype "bfloat16", the JAX package's
`--compute_dtype bfloat16`) on the CPU: the plain versions that the CUDA
kernels' bf16 arms are held to on the card, against the JAX package's Pallas
kernels at compute_dtype=bfloat16 in interpret mode, as
tests/test_pallas_kernels.py runs them; the whole model against
`stemgnn.forward(..., use_pallas=True, precision="bfloat16")`; and the flag
from the command line to the ops.

The plain versions round to bf16 where the JAX kernels cast to bf16 and
multiply in f32, so they differ from the JAX arm only in the order of f32
sums. Each comparison also asks that the port sits closer to the JAX bf16
result than to the JAX f32 one, so that a tolerance cannot pass an f32
computation for a bf16 one."""

import argparse
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models import stemgnn as jax_stemgnn
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.ops import pallas_spectral as ps
from stemgnn_tpu.ops.pallas_graph import cheb_graph_conv_pallas
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig, add_cli_args, config_from_args
from stemgnn_tpu_torch.models import forward, init_params
from stemgnn_tpu_torch.models import stemgnn as port_stemgnn
from stemgnn_tpu_torch.models.convert import flatten_params, params_from_jax
from stemgnn_tpu_torch.ops import cuda_graph, cuda_spectral
from stemgnn_tpu_torch.train import engine

torch.set_num_threads(1)

B, N, W, M = 4, 40, 12, 5
BF16 = "bfloat16"


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _glu(n=N):
    cfg = JaxConfig(units=n, window_size=W, horizon=3, multi_layer=M, pallas_min_nodes=0)
    return torch_stream_init(0, cfg)["blocks"][0]["glu"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(precision, fn, *args, **kw):
    """fn under the JAX package's matmul precision for that policy (its engine
    wraps the model so; on the CPU it leaves f32 products as they are)."""
    with jax.default_matmul_precision(precision):
        return fn(*args, **kw)


def _closer(got, want_bf16, want_f32, factor):
    """The port's result at least `factor` times closer (in L2 over all the
    arrays) to the JAX bf16 result than to the JAX f32 one."""
    d_bf16 = sum(float(np.sum((np.asarray(g) - np.asarray(w)) ** 2))
                 for g, w in zip(got, want_bf16))
    d_f32 = sum(float(np.sum((np.asarray(g) - np.asarray(w)) ** 2))
                for g, w in zip(got, want_f32))
    assert d_f32 >= factor ** 2 * d_bf16, (np.sqrt(d_f32), np.sqrt(d_bf16))


@pytest.mark.parametrize("save", [False, True], ids=["serving", "saving"])
def test_spectral_forward_bf16_matches_pallas(interpret, save):
    """The plain bf16 forward (serving: `spe_seq_cell`; saving: with the 12
    arrays) against `_forward(..., compute_dtype=bfloat16)`: each array within
    1e-3 of its largest entry (measured: 4e-6 of 0.047 for the output), and 5
    times closer to it than to the f32 forward (measured: 55 times)."""
    rng = np.random.default_rng(70)
    glu = _glu()
    x = rng.standard_normal((B, 4, N, W)).astype(np.float32)
    args = (jnp.asarray(x), jax.tree.map(jnp.asarray, glu), M)
    want = _jax(BF16, ps._forward, *args, compute_dtype=jnp.bfloat16, save_acts=save)
    want_f32 = _jax("float32", ps._forward, *args, save_acts=save)
    tglu = params_from_jax(glu, "cpu")
    rows = B * N
    if save:
        out, acts = ops.spe_seq_cell_save(_t(x), tglu, M, compute_dtype=BF16)
        got = [out.numpy()] + [acts[i].numpy() for i in range(12)]
        want = [want[0]] + [np.asarray(a)[:rows] for a in want[1]]
        want_f32 = [want_f32[0]] + [np.asarray(a)[:rows] for a in want_f32[1]]
    else:
        got = [ops.spe_seq_cell(_t(x), tglu, M, compute_dtype=BF16).numpy()]
        want, want_f32 = [want], [want_f32]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg="out" if i == 0 else f"act {i - 1}")
    _closer(got[:1], want[:1], want_f32[:1], 5.0)


def _grad_leaves(dx, dglu):
    return [dx] + [dglu[i][side][leaf] for i in range(6) for side in ("left", "right")
                   for leaf in ("w", "b")]


@pytest.mark.parametrize("reread", [False, True], ids=["recompute", "reread"])
def test_spectral_backward_bf16_matches_jax_grad(interpret, reread):
    """The plain bf16 backward (recompute, or the saving forward and the reread
    backward) against `jax.grad` of `spe_seq_cell_pallas(..., bfloat16)` with
    the JAX package's SAVE_ACTS_BWD off or on: dx and each of the 24 gradients
    within 3e-3 of its largest entry, and in L2 over all of them 3 times
    closer to it than to the f32 gradients. The tolerance is the sums' order:
    a different order of f32 sums rounds a few da, ds to the next bf16, and the
    port's own bf16 gradients with f64 sums differ from its f32-sum ones by up
    to 1.4e-3 of a gradient's largest entry (as they differ from the JAX
    package's). The port's reread gradients are bitwise its recompute ones."""
    rng = np.random.default_rng(71)
    glu = _glu()
    x = rng.standard_normal((B, 4, N, W)).astype(np.float32)
    cot = rng.standard_normal((B, 4, N, W * M)).astype(np.float32)

    def jax_grads(dtype, precision):
        fn = jax.grad(lambda xx, gg: jnp.sum(ps.spe_seq_cell_pallas(xx, gg, M, dtype) * cot),
                      argnums=(0, 1))
        g = _jax(precision, fn, jnp.asarray(x), jax.tree.map(jnp.asarray, glu))
        return _grad_leaves(*g)

    try:
        ps.SAVE_ACTS_BWD = reread
        want = jax_grads(jnp.bfloat16, BF16)
        want_f32 = jax_grads(jnp.float32, "float32")
    finally:
        ps.SAVE_ACTS_BWD = False
    tglu = params_from_jax(glu, "cpu")
    recompute = _grad_leaves(*ops.spe_seq_cell_bwd(_t(x), tglu, _t(cot), M, BF16))
    _, acts = ops.spe_seq_cell_save(_t(x), tglu, M, BF16)
    # rows past the end are padding and never read
    acts = torch.cat([acts, torch.full((12, 5, acts.shape[2]), float("nan"))], dim=1)
    again = _grad_leaves(*ops.spe_seq_cell_bwd_reread(_t(x), tglu, _t(cot), acts, M, BF16))
    assert all(torch.equal(a, b) for a, b in zip(again, recompute))
    got = [t.numpy() for t in (again if reread else recompute)]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-3 * np.abs(w).max(),
                                   err_msg="dx" if i == 0 else f"gradient {i - 1}")
    _closer(got, want, want_f32, 3.0)


def test_graph_conv_bf16_matches_pallas_and_its_backward_stays_f32(interpret):
    """The plain bf16 graph conv against `cheb_graph_conv_pallas(...,
    bfloat16)`: products of bf16 values are exact, so within 1e-5 of the
    largest entry (40-term f32 sums in another order; measured 1e-7), and 5
    times closer than to the f32 kernel. Its gradients are the f32 VJP of the
    f32 inputs, as the JAX package's `_bwd` (within 1e-5 of the largest
    entry)."""
    rng = np.random.default_rng(72)
    mul_l = (rng.standard_normal((4, N, N)) * 0.1).astype(np.float32)
    mul_l[0] = 0.0
    x = rng.standard_normal((B, N, W)).astype(np.float32)
    cot = rng.standard_normal((B, 4, N, W)).astype(np.float32)
    want = np.asarray(cheb_graph_conv_pallas(jnp.asarray(mul_l), jnp.asarray(x), jnp.bfloat16))
    want_f32 = np.asarray(cheb_graph_conv_pallas(jnp.asarray(mul_l), jnp.asarray(x)))
    tl, tx = _t(mul_l).requires_grad_(True), _t(x).requires_grad_(True)
    out = ops.cheb_graph_conv(tl, tx, compute_dtype=BF16)
    got = out.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _closer([got], [want], [want_f32], 5.0)
    (out * _t(cot)).sum().backward()
    jgrads = jax.grad(lambda l_, x_: jnp.sum(cheb_graph_conv_pallas(l_, x_, jnp.bfloat16) * cot),
                      argnums=(0, 1))(jnp.asarray(mul_l), jnp.asarray(x))
    for name, g, w in (("mul_L", tl.grad, jgrads[0]), ("x", tx.grad, jgrads[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def _leaf_tree(tree):
    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def test_model_bf16_forward_and_grads_match_pallas(interpret):
    """The whole training forward at compute_dtype "bfloat16" and every
    parameter gradient against `stemgnn.forward(..., use_pallas=True,
    precision="bfloat16")` (N = 20, batch 3, the same dropout mask): forecast
    within 1e-5 and 5 times closer than to the f32 forward (measured 8.9e-8
    against 1.5e-6), loss within 1e-5, each gradient within 3e-3 of its
    largest entry (the spectral backward's sums, as above: measured 1.3e-3)
    and in L2 over all of them 5 times closer than to the f32 gradients
    (measured 42 times)."""
    n, b = 20, 3
    cfg = StemGNNConfig(units=n, window_size=W, horizon=3, multi_layer=M)
    jcfg = JaxConfig(units=n, window_size=W, horizon=3, multi_layer=M, pallas_min_nodes=0)
    np_tree = torch_stream_init(0, jcfg)
    rng = np.random.default_rng(73)
    x = rng.standard_normal((b, W, n)).astype(np.float32)
    y = rng.standard_normal((b, 3, n)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.dropout_rate, (b, n, n)))

    def jax_run(precision):
        def loss_fn(p):
            f, _ = jax_stemgnn.forward(p, jcfg, jnp.asarray(x), training=True,
                                       dropout_rng=key, use_pallas=True, precision=precision)
            return jnp.mean((f - jnp.asarray(y)) ** 2), f

        (loss, f), g = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, np_tree))
        return float(loss), np.asarray(f), flatten_params(jax.tree.map(np.asarray, g))

    jloss, jf, jgrads = jax_run(BF16)
    _, jf32, jgrads32 = jax_run("float32")
    params = _leaf_tree(np_tree)
    tf, _ = forward(params, cfg, _t(x), training=True, dropout_mask=_t(mask.copy()),
                    compute_dtype=BF16)
    tloss = torch.mean((tf - _t(y)) ** 2)
    tloss.backward()
    tf = tf.detach().numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    _closer([tf], [jf], [jf32], 5.0)
    assert abs(float(tloss.detach()) - jloss) < 1e-5
    got, want, want32 = [], [], []
    for name, p in flatten_params(params).items():
        if p.grad is None:  # stack 1's unused shortcut: zeros from jax.grad
            assert not jgrads[name].any(), name
            continue
        w = jgrads[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=3e-3 * float(np.abs(w).max()) + 1e-9, err_msg=name)
        got.append(p.grad.numpy())
        want.append(w)
        want32.append(jgrads32[name])
    _closer(got, want, want32, 5.0)


def test_compute_dtype_flag_reaches_the_ops(monkeypatch):
    """`--compute_dtype` parses to TrainConfig with the JAX package's name,
    default and values, and the engine's train and eval steps hand it to the
    graph conv and the spectral cell; on CPU tensors no kernel launches."""
    from stemgnn_tpu.config import TrainConfig as JaxTrainConfig

    assert TrainConfig().compute_dtype == JaxTrainConfig().compute_dtype == "float32"
    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    cfg = config_from_args(parser.parse_args(["--compute_dtype", BF16]))
    assert cfg.compute_dtype == BF16
    with pytest.raises(ValueError):
        TrainConfig(compute_dtype="float16")

    seen = []
    for name in ("cheb_graph_conv", "spe_seq_cell"):
        fn = getattr(port_stemgnn.ops, name)

        def spy(*args, compute_dtype="float32", _fn=fn, _name=name):
            seen.append((_name, compute_dtype))
            return _fn(*args, compute_dtype=compute_dtype)

        monkeypatch.setattr(port_stemgnn.ops, name, spy)
    n = 6
    mcfg = cfg.model_config(n)
    flat = {k: v.requires_grad_(True) for k, v in flatten_params(
        port_stemgnn.init_params(0, mcfg, device="cpu")).items()}
    params = port_stemgnn.unflatten_params(flat)
    opt = torch.optim.SGD(flat.values(), lr=1e-3)
    data = torch.from_numpy(np.random.default_rng(74).standard_normal((40, n)).astype(np.float32))
    hi = torch.tensor([20, 25])
    ops.reset_launches()
    step = engine.make_train_step(mcfg, opt, flat.values(), compute_dtype=cfg.compute_dtype)
    loss = step(params, data, hi, dropout_mask=torch.ones((2, n, n), dtype=torch.bool))
    forecast = engine.make_eval_step(mcfg, "cpu", cfg.compute_dtype)(
        params, engine.gather_windows(data, hi, W, 3)[0])
    assert torch.isfinite(loss) and forecast.shape == (2, 3, n)
    assert seen == [("cheb_graph_conv", BF16), ("spe_seq_cell", BF16)] * 4
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
    assert ops.replayed() == dict.fromkeys(ops.KERNELS, 0)


def test_bf16_arms_have_counters_and_plans():
    """Each bf16 arm counts under a name of its own, and calls on CPU tensors
    count nothing; the graph conv's bf16 plan keeps a batch's panel of x a
    whole number of 16-byte pieces of bf16 in shared memory."""
    assert list(ops.KERNELS)[-5:] == [
        "cheb_graph_conv_fwd_bf16", "spectral_fwd_bf16", "spectral_fwd_save_bf16",
        "spectral_bwd_bf16", "spectral_bwd_reread_bf16"]
    ops.reset_launches()
    rng = np.random.default_rng(75)
    tglu = params_from_jax(_glu(6), "cpu")
    x = _t(rng.standard_normal((2, 4, 6, W)).astype(np.float32))
    out = cuda_spectral.spe_seq_cell_bf16(x, tglu, M)
    np.testing.assert_array_equal(
        out.numpy(), ops.spe_seq_cell(x, tglu, M, compute_dtype=BF16).numpy())
    _, acts = cuda_spectral.spe_seq_cell_save_bf16(x, tglu, M)
    cuda_spectral.spe_seq_cell_bwd_reread_bf16(x, tglu, torch.ones_like(out), acts, M)
    cuda_spectral.spe_seq_cell_bwd_bf16(x, tglu, torch.ones_like(out), M)
    cuda_graph.cheb_graph_conv_bf16(torch.zeros((4, 6, 6)), torch.ones((2, 6, W)))
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
    for n, b in ((140, 32), (800, 3)):
        f32, bf16 = cuda_graph.launch_plan(4, n, b, W), cuda_graph.launch_plan(4, n, b, W, 2)
        assert bf16.batch_stride % 8 == 0 and bf16.batch_stride >= bf16.panel * W + 4
        assert bf16.smem == 2 * (32 * bf16.panel + 4 * bf16.batch_stride)
        assert bf16.smem <= cuda_graph.SMEM_PER_BLOCK and bf16.panel >= f32.panel
    assert cuda_graph.launch_plan(4, 140, 32, W, 2).panel == 144
    with pytest.raises(ValueError):
        ops.cheb_graph_conv(torch.zeros((4, 6, 6)), torch.ones((2, 6, W)),
                            compute_dtype="float16")


def _chip_smoke():
    """chip_smoke.py, which keeps the bf16 arms' rule past D1 = 720 (it
    imports only the standard library until a check runs)."""
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_noise_rule_past_d1_720(seed):
    """chip_smoke.py's rule for the bf16 spectral arms past D1 = 720
    (`bf16_noise_agreement`), with plain versions standing in for the
    kernels, at W = 103, multi 5 on 240 rows (D1 = 2060), inputs drawn as
    chip_smoke.py draws them: the bf16 plain version in another sum order
    (its rows reversed, or its order blocks reversed, and its results put
    back) passes, forward and backward;
    the f32 plain version fails, no closer to the bf16 plain version than to
    itself; and the bf16 plain version with f32 sums stands more than 2^-8
    of an array's largest entry from the one with f64 sums in its backward,
    which a fixed 2^-8 would refuse."""
    smoke = _chip_smoke()
    b, n, w, m = 4, 60, 103, 5
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 4, n, w)).astype(np.float32))
    g = torch.from_numpy((1e-3 * rng.standard_normal((b, 4, n, w * m))).astype(np.float32))
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=m)
    glu = init_params(0, cfg, device="cpu")["blocks"][0]["glu"]
    p64 = smoke.spectral_plain_arrays(x, glu, g, m, BF16, torch.float64)
    p32 = smoke.spectral_plain_arrays(x, glu, g, m, BF16)
    f32 = smoke.spectral_plain_arrays(x, glu, g, m, "float32")

    def rows_back(t):  # [B, K, N, .] with B and N reversed: the rows reversed
        return t.flip(0).flip(2)

    def blocks_back(t):  # the 4 order blocks of each GLU axis reversed
        if t.dim() == 1:
            return t.reshape(4, -1).flip(0).reshape(-1)
        return t.reshape(4, t.shape[0] // 4, 4, t.shape[1] // 4).flip(0).flip(2).reshape(
            t.shape)

    fwd, bwd = smoke.spectral_plain_arrays(rows_back(x), glu, rows_back(g), m, BF16)
    stand_ins = [([rows_back(t) for t in fwd[:2]] + [t.flip(0) for t in fwd[2:]],
                  [rows_back(bwd[0])] + bwd[1:])]
    # the order blocks reversed: the same sums, each product's terms in
    # another order (the DFT matrices are block diagonal)
    glu_back = [{s: {k: blocks_back(t) for k, t in p[s].items()} for s in p} for p in glu]
    fwd, bwd = smoke.spectral_plain_arrays(x.flip(1), glu_back, g.flip(1), m, BF16)
    stand_ins.append(([t.flip(1) for t in fwd[:2]] + [t.reshape(t.shape[0], 4, -1).flip(1).reshape(t.shape)
                                                      for t in fwd[2:]],
                      [bwd[0].flip(1)] + [blocks_back(t) for t in bwd[1:]]))
    for other in stand_ins:
        for part in (0, 1):
            bad, rel, noise, closer = smoke.bf16_noise_agreement(other[part], p64[part],
                                                                 p32[part], f32[part])
            assert not bad, (part, bad, rel, noise, closer)
            assert noise <= smoke.BF16_NOISE_FACTOR and closer >= smoke.BF16_CLOSER
    for part in (0, 1):
        bad, _, _, closer = smoke.bf16_noise_agreement(f32[part], p64[part], p32[part],
                                                       f32[part])
        assert closer == 0.0 and any("closer" in label for label in bad), bad
    worst = max(((a - a64).abs().max() / a64.abs().max()).item()
                for a, a64 in zip(p32[1], p64[1]))
    assert worst > smoke.BF16_ATOL_REL, worst
