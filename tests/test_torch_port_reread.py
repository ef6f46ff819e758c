"""The port's spectral saving forward and reread backward (CPU): the plain
pair against the JAX package's `_kernel_save` and `_bwd_kernel_reread`, run in
interpret mode as tests/test_pallas_kernels.py runs them, and the port's
reread path against its recompute path through the autograd.Function.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against the plain pair and against each other bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stemgnn_tpu.config import StemGNNConfig as JaxConfig
from stemgnn_tpu.models.initializers import torch_stream_init
from stemgnn_tpu.ops import pallas_spectral as ps
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import forward
from stemgnn_tpu_torch.models.convert import flatten_params, params_from_jax
from stemgnn_tpu_torch.ops import cuda_spectral, torch_impl

torch.set_num_threads(1)

W, M = 12, 5
# (batch, nodes): 30 rows, under one row tile of either JAX kernel; 160 rows,
# two tiles of the JAX backward (128) and not a multiple of any tile
SHAPES = pytest.mark.parametrize("b,n", [(3, 10), (4, 40)],
                                 ids=["one_row_tile", "two_row_tiles_ragged"])


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _glu(n, w=W, m=M):
    cfg = JaxConfig(units=n, window_size=w, horizon=3, multi_layer=m, pallas_min_nodes=0)
    return torch_stream_init(0, cfg)["blocks"][0]["glu"]


def _t(a):
    return torch.from_numpy(np.array(a))


@SHAPES
def test_plain_save_forward_matches_pallas_kernel_save(interpret, b, n):
    rng = np.random.default_rng(60)
    glu = _glu(n)
    x = rng.standard_normal((b, 4, n, W)).astype(np.float32)
    want_out, want_acts = ps._forward(jnp.asarray(x), jax.tree.map(jnp.asarray, glu), M,
                                      save_acts=True)
    out, acts = ops.spe_seq_cell_save(_t(x), params_from_jax(glu, "cpu"), M)
    rows = b * n
    assert out.shape == (b, 4, n, W * M) and acts.shape == (12, rows, 4 * W * M)
    assert len(want_acts) == 12 and want_acts[0].shape[0] % ps.ROW_TILE == 0
    # f32, sums of up to 240 terms in another order: atol 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=1e-4)
    for i, want in enumerate(want_acts):  # the JAX arrays are padded to ROW_TILE rows
        np.testing.assert_allclose(acts[i].numpy(), np.asarray(want)[:rows], rtol=0,
                                   atol=1e-4, err_msg=f"act {i}")
    # and the saving forward is the forward
    np.testing.assert_allclose(
        out.numpy(), torch_impl.spe_seq_cell(_t(x), params_from_jax(glu, "cpu"), M).numpy(),
        rtol=0, atol=1e-4)


def _check_reread_backward(rng, b, n, w=W, m=M):
    """The plain reread backward against `jax.grad` of the Pallas cell with the
    JAX package's saving forward and reread backward."""
    glu = _glu(n, w, m)
    x = rng.standard_normal((b, 4, n, w)).astype(np.float32)
    cot = rng.standard_normal((b, 4, n, w * m)).astype(np.float32)
    try:
        ps.SAVE_ACTS_BWD = True
        want_dx, want_dglu = jax.grad(
            lambda xx, gg: jnp.sum(ps.spe_seq_cell_pallas(xx, gg, m) * cot),
            argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, glu))
    finally:
        ps.SAVE_ACTS_BWD = False
    tglu = params_from_jax(glu, "cpu")
    _, acts = ops.spe_seq_cell_save(_t(x), tglu, m)
    # rows past the end are padding and never read
    acts = torch.cat([acts, torch.full((12, 7, acts.shape[2]), float("nan"))], dim=1)
    dx, dglu = ops.spe_seq_cell_bwd_reread(_t(x), tglu, _t(cot), acts, m)

    def close(got, want, name):  # f32: 1e-4 of the gradient's largest entry
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)

    close(dx, want_dx, "dx")
    for i in range(6):
        for side in ("left", "right"):
            for leaf in ("w", "b"):
                close(dglu[i][side][leaf], want_dglu[i][side][leaf],
                      f"glu {i} {side} {leaf}")


@SHAPES
def test_plain_reread_backward_matches_jax_grad_with_save_acts(interpret, b, n):
    _check_reread_backward(np.random.default_rng(61), b, n)


def _cell_case():
    n, b = 8, 3
    rng = np.random.default_rng(62)
    glu = jax.tree.map(lambda a: np.asarray(a, np.float64), _glu(n))
    tglu = params_from_jax(glu, "cpu")
    leaves = [t.requires_grad_(True) for t in cuda_spectral._flat(tglu)]
    x = _t(rng.standard_normal((b, 4, n, W))).requires_grad_(True)
    cot = _t(rng.standard_normal((b, 4, n, W * M)))
    return (lambda: (ops.spe_seq_cell(x, tglu, M) * cot).sum()), [x] + leaves


def _model_case():
    n, b = 8, 3
    rng = np.random.default_rng(63)
    cfg = StemGNNConfig(units=n, window_size=W, horizon=3, multi_layer=M)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), torch_stream_init(
        0, JaxConfig(units=n, window_size=W, horizon=3, multi_layer=M)))
    params = params_from_jax(tree, "cpu")
    leaves = [t.requires_grad_(True) for t in flatten_params(params).values()]
    x = _t(rng.standard_normal((b, W, n)))
    y = _t(rng.standard_normal((b, 3, n)))
    mask = _t(rng.random((b, n, n)) < 0.5)
    return (lambda: torch.mean((forward(params, cfg, x, training=True,
                                        dropout_mask=mask)[0] - y) ** 2)), leaves


@pytest.mark.parametrize("case", [_cell_case, _model_case], ids=["cell", "model"])
def test_reread_gradients_equal_recompute_gradients_at_f64(case, monkeypatch):
    """Through the autograd.Function with SAVE_ACTS_BWD off and on: the same
    value and gradients (atol 1e-12 at f64), and with the switch on the
    backward is the reread one."""
    loss_fn, leaves = case()
    calls = {"save": 0, "reread": 0, "recompute": 0}

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cuda_spectral, "spe_seq_cell_save_plain",
                        counted("save", cuda_spectral.spe_seq_cell_save_plain))
    monkeypatch.setattr(cuda_spectral, "spe_seq_cell_bwd_reread_plain",
                        counted("reread", cuda_spectral.spe_seq_cell_bwd_reread_plain))
    monkeypatch.setattr(cuda_spectral, "spe_seq_cell_bwd_plain",
                        counted("recompute", cuda_spectral.spe_seq_cell_bwd_plain))

    def run(switch):
        monkeypatch.setattr(cuda_spectral, "SAVE_ACTS_BWD", switch)
        for t in leaves:
            t.grad = None
        loss = loss_fn()
        loss.backward()
        return loss.detach(), [None if t.grad is None else t.grad.clone()
                               for t in leaves]

    assert cuda_spectral.SAVE_ACTS_BWD is True  # the port's default (PERF.md's A/B)
    loss_a, grads_a = run(False)
    cells = calls["recompute"]
    assert cells >= 1 and calls["save"] == calls["reread"] == 0
    loss_b, grads_b = run(True)
    assert calls == {"save": cells, "reread": cells, "recompute": cells}
    np.testing.assert_allclose(loss_b.numpy(), loss_a.numpy(), rtol=0, atol=1e-12)
    for a, b in zip(grads_a, grads_b):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12)


def test_new_wrappers_are_counted_kernels_and_launch_nothing_on_the_cpu():
    assert list(ops.KERNELS)[9:11] == ["spectral_fwd_save", "spectral_bwd_reread"]
    ops.reset_launches()
    rng = np.random.default_rng(64)
    tglu = params_from_jax(_glu(6), "cpu")
    x = _t(rng.standard_normal((2, 4, 6, W)).astype(np.float32))
    out, acts = ops.spe_seq_cell_save(x, tglu, M)
    ops.spe_seq_cell_bwd_reread(x, tglu, torch.ones_like(out), acts, M)
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
    # a capture's launches are taken off the wrappers and kept for its replays
    with ops.counting_capture() as recorded:
        ops.spe_seq_cell_save.launches += 2
    assert ops.launches()["spectral_fwd_save"] == 0 and recorded["spectral_fwd_save"] == 2
    ops.add_replayed(recorded)
    ops.add_replayed(recorded)
    assert ops.replayed()["spectral_fwd_save"] == 4
    ops.reset_launches()
    assert ops.replayed() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("w,multi", [
    (8, 6),    # D0 = 32, D1 = 192
    (12, 1),   # D1 = D0: layer 0's runs of 4 outnumber a product's column groups
    (7, 5),    # D1 / 4 odd, and runs of 4 columns straddle two windows
    (10, 5),   # W * multi = 50: runs straddle two windows, D1 / 4 even
    (12, 6),   # D1 = 288: the rows kernel's wide blocks, two weight-gradient column tiles
    (25, 5),   # D1 = 500
    (28, 5),   # D1 = 560: the README's COVID-19 command
    (35, 5),   # D1 = 700: past 680, the rows kernel's 8-row tiles (C.5)
])
def test_spectral_backward_shape_rule(interpret, w, multi):
    """The CUDA kernels take every window and multiplier with D0 = 4 * W and
    D1 = 4 * W * multi in runs of 4 columns (csrc/spectral.cu `shape_ok`, the
    forward's rule and the backward's; chip_smoke.py holds them against the
    plain versions at W = 7, 10, 25, 28, 35 and 103, at multi 6, 15 and 64 and
    at D1 = 2000). At such shapes the plain reread backward, which the
    kernels are held to, matches the JAX package's."""
    _check_reread_backward(np.random.default_rng(65), 2, 5, w, multi)


@pytest.mark.parametrize("w,multi", [
    (7, 5),    # D1 / 4 odd, runs of 4 columns that straddle two windows
    (25, 5),   # D1 = 500
    (28, 5),   # D1 = 560: the COVID-19 window
    (12, 6),   # D1 = 288
    (35, 5),   # D1 = 700: past 680 (C.5)
    (103, 5),  # D1 = 2060: past 2048 (C.5)
])
def test_plain_save_forward_matches_pallas_at_other_windows(interpret, w, multi):
    """The plain saving forward, which the CUDA saving forward is held to on
    the card, against the JAX package's `_forward(save_acts=True)` (Pallas
    `_kernel_save` in interpret mode) at f32 with precision "float32": the
    output and the 12 saved arrays, each within atol 1e-5 of its own largest
    entry (sums of up to 700 f32 terms in another order)."""
    rng = np.random.default_rng(66)
    b, n = 2, 5
    glu = _glu(n, w, multi)
    x = rng.standard_normal((b, 4, n, w)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want_out, want_acts = ps._forward(jnp.asarray(x), jax.tree.map(jnp.asarray, glu),
                                          multi, save_acts=True)
    out, acts = ops.spe_seq_cell_save(_t(x), params_from_jax(glu, "cpu"), multi)
    rows = b * n
    assert out.shape == (b, 4, n, w * multi) and acts.shape == (12, rows, 4 * w * multi)
    assert len(want_acts) == 12
    for i, (got, want) in enumerate([(out, want_out)] + [
            (acts[i], np.asarray(a)[:rows]) for i, a in enumerate(want_acts)]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg="out" if i == 0 else f"act {i - 1}")
