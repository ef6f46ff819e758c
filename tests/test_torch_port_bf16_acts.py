"""The bf16-storage arm of the spectral saving pair on the CPU: the JAX
package's `_kernel_save` with SAVE_ACTS_F32 off (act_dtype = compute_dtype,
pallas_spectral.py:213) and `_bwd_kernel_reread` on the bf16 arrays it
stores, run in interpret mode as tests/test_pallas_kernels.py runs them,
against the port's plain versions (`spe_seq_cell_save(..., act_dtype=
"bfloat16")`, `spe_seq_cell_bwd_reread` on bf16 acts) and its autograd
dispatch under `cuda_spectral.SAVE_ACTS_BWD` and `SAVE_ACTS_F32`. The JAX
package's switches are patched inside each test, never in its file.

The CUDA arms run only on the card: chip_smoke.py holds them against these
plain versions and their bf16 planes bit for bit against the f32-storage
arm's planes rounded to bf16."""

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
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models import forward
from stemgnn_tpu_torch.models.convert import flatten_params, params_from_jax
from stemgnn_tpu_torch.ops import cuda_spectral

torch.set_num_threads(1)

BF16 = "bfloat16"


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _glu(n, w, m):
    cfg = JaxConfig(units=n, window_size=w, horizon=3, multi_layer=m, pallas_min_nodes=0)
    return torch_stream_init(0, cfg)["blocks"][0]["glu"]


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bf16_arrays(monkeypatch):
    """The JAX package's switches for the bf16-storage arm, for this test."""
    monkeypatch.setattr(ps, "SAVE_ACTS_BWD", True)
    monkeypatch.setattr(ps, "SAVE_ACTS_F32", False)


def _rel(got, want):
    """max |got - want| over the largest |want|, in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,n", [(3, 10), (4, 40)], ids=["one_row_tile", "ragged"])
def test_plain_bf16_planes_and_output_match_kernel_save(interpret, monkeypatch, b, n):
    """The plain saving forward with act_dtype "bfloat16" against
    `_forward(save_acts=True)` at compute_dtype bfloat16 with SAVE_ACTS_F32
    off: the 12 arrays are bf16 on both sides, each entry within one bf16 ulp
    of JAX's (2^-7 of the value at most: both round an f32 a or s whose sums
    differ in order only) plus 1e-3 of the array's largest entry, the
    tolerance test_torch_port_bf16.py holds the f32-storage arm's arrays to
    (a layer's input rounded to the other bf16 moves the next layer's a and s;
    measured up to 2e-4 of the largest entry, near zero), and the output,
    computed from the unrounded values, equals the f32-storage arm's output
    bit for bit on each side and stays within 1e-3 of its largest entry of
    JAX's (the bf16 forward tolerance of test_torch_port_bf16.py)."""
    _bf16_arrays(monkeypatch)
    w, m = 12, 5
    rng = np.random.default_rng(80)
    glu = _glu(n, w, m)
    x = rng.standard_normal((b, 4, n, w)).astype(np.float32)
    with jax.default_matmul_precision(BF16):
        want_out, want_acts = ps._forward(jnp.asarray(x), jax.tree.map(jnp.asarray, glu), m,
                                          jnp.bfloat16, save_acts=True)
    tglu = params_from_jax(glu, "cpu")
    out, acts = ops.spe_seq_cell_save(_t(x), tglu, m, BF16, act_dtype=BF16)
    out_f32acts, acts_f32 = ops.spe_seq_cell_save(_t(x), tglu, m, BF16)
    rows = b * n
    assert acts.dtype == torch.bfloat16 and acts.shape == (12, rows, 4 * w * m)
    assert all(a.dtype == jnp.bfloat16 for a in want_acts)
    assert torch.equal(out, out_f32acts)
    assert torch.equal(acts, acts_f32.to(torch.bfloat16))
    for i, (got, want) in enumerate(zip(acts, want_acts)):
        got, want = got.float().numpy(), np.asarray(want[:rows], np.float32)
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3 * np.abs(want).max(),
                                   err_msg=f"saved array {i}")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=1e-3 * float(np.abs(want_out).max()))


def _leaves(dx, dglu):
    return [dx] + [dglu[i][side][leaf] for i in range(6) for side in ("left", "right")
                   for leaf in ("w", "b")]


# (batch, nodes, window, multi): the flagship window and multi (D1 = 240); the
# window 35 (D1 = 700, a run of 4 columns that straddles two windows); past
# D1 = 2048 (W = 103, multi 5: D1 = 2060), where the card takes the wide
# kernels
REREAD_SHAPES = [(3, 10, 12, 5), (2, 9, 35, 5), (2, 6, 103, 5)]


@pytest.mark.parametrize("b,n,w,m", REREAD_SHAPES, ids=["d1_240", "d1_700", "d1_2060"])
def test_plain_reread_on_bf16_acts_matches_backward_reread(interpret, monkeypatch, b, n, w, m):
    """The plain reread backward on bf16 acts against `_backward_reread` at
    compute_dtype bfloat16 on the same bf16 arrays (JAX's `_forward` with
    SAVE_ACTS_F32 off wrote them): dx and each of the 24 gradients within
    3e-3 of its largest entry up to D1 = 720 and 1e-2 past it. Both round
    u = a * s, da and ds to bf16 and sum bf16 products in f32, in another
    order, and a sum that lands on the other side of a rounding moves a value
    by a bf16 ulp (3e-3 is the bf16 backward tolerance of
    test_torch_port_bf16.py; measured 2.8e-4 at D1 = 240 and 9.6e-5 at 700;
    past D1 = 2048 the sums are 2060 terms long: measured 4.0e-3). In L2 over
    all of them the port is at least 4 times closer to JAX's bf16-storage
    gradients than to the gradients of the f32-storage arm on the same inputs
    (measured 497, 1993 and 22.5 times), so the arm reads what was stored,
    not the unrounded values."""
    _bf16_arrays(monkeypatch)
    rng = np.random.default_rng(81)
    glu = _glu(n, w, m)
    x = rng.standard_normal((b, 4, n, w)).astype(np.float32)
    g = (1e-3 * rng.standard_normal((b, 4, n, w * m))).astype(np.float32)
    jx, jglu = jnp.asarray(x), jax.tree.map(jnp.asarray, glu)
    with jax.default_matmul_precision(BF16):
        _, jacts = ps._forward(jx, jglu, m, jnp.bfloat16, save_acts=True)
        want = _leaves(*ps._backward_reread(jx, jglu, jnp.asarray(g), jacts, m, jnp.bfloat16))
        monkeypatch.setattr(ps, "SAVE_ACTS_F32", True)
        _, jacts32 = ps._forward(jx, jglu, m, jnp.bfloat16, save_acts=True)
        want_f32acts = _leaves(*ps._backward_reread(jx, jglu, jnp.asarray(g), jacts32, m,
                                                    jnp.bfloat16))
    assert jacts[0].dtype == jnp.bfloat16 and jacts32[0].dtype == jnp.float32
    acts = torch.stack([_t(a) for a in jacts])
    got = _leaves(*ops.spe_seq_cell_bwd_reread(_t(x), params_from_jax(glu, "cpu"), _t(g),
                                                acts, m, BF16))
    tol = 3e-3 if 4 * w * m <= 720 else 1e-2
    for i, (a, b_) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), b_) <= tol, ("dx" if i == 0 else f"gradient {i - 1}",
                                            _rel(a.numpy(), b_))
    d_bf16 = sum(float(np.sum((a.numpy() - np.asarray(b_)) ** 2)) for a, b_ in zip(got, want))
    d_f32 = sum(float(np.sum((a.numpy() - np.asarray(b_)) ** 2))
                for a, b_ in zip(got, want_f32acts))
    assert d_f32 >= 4.0 * d_bf16, (np.sqrt(d_f32), np.sqrt(d_bf16))


@pytest.mark.parametrize("reread", [False, True], ids=["recompute", "reread"])
@pytest.mark.parametrize("acts_f32", [True, False], ids=["f32_acts", "bf16_acts"])
@pytest.mark.parametrize("compute_dtype", ["float32", BF16])
def test_spe_seq_cell_dispatch_follows_both_switches(monkeypatch, reread, acts_f32,
                                                     compute_dtype):
    """Under autograd the cell saves acts only with SAVE_ACTS_BWD on, and
    stores them as bf16 only at compute_dtype bfloat16 with SAVE_ACTS_F32 off
    (at f32 the arrays are f32 either way, as the JAX package's act_dtype);
    the backward then gives what the plain backward of that arm gives, bit
    for bit, and no kernel launches on the CPU."""
    monkeypatch.setattr(cuda_spectral, "SAVE_ACTS_BWD", reread)
    monkeypatch.setattr(cuda_spectral, "SAVE_ACTS_F32", acts_f32)
    seen = []
    plain_save = cuda_spectral.spe_seq_cell_save_plain

    def spy(*args, **kw):
        out = plain_save(*args, **kw)
        seen.append(out[1].dtype)
        return out

    monkeypatch.setattr(cuda_spectral, "spe_seq_cell_save_plain", spy)
    rng = np.random.default_rng(82)
    b, n, w, m = 2, 6, 12, 5
    glu = params_from_jax(_glu(n, w, m), "cpu")
    x = torch.from_numpy(rng.standard_normal((b, 4, n, w)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, 4, n, w * m)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in cuda_spectral._flat(glu)]
    xg = x.clone().requires_grad_(True)
    ops.reset_launches()
    out = ops.spe_seq_cell(xg, cuda_spectral._unflat(leaves), m, compute_dtype)
    (out * g).sum().backward()
    bf16_acts = reread and not acts_f32 and compute_dtype == BF16
    assert seen == ([torch.bfloat16 if bf16_acts else torch.float32] if reread else [])
    if bf16_acts:
        _, acts = plain_save(x, glu, m, compute_dtype, BF16)
        want = _leaves(*cuda_spectral.spe_seq_cell_bwd_reread_plain(x, glu, g, acts, m,
                                                                    compute_dtype))
    else:
        want = _leaves(*cuda_spectral.spe_seq_cell_bwd_plain(x, glu, g, m, compute_dtype))
    assert torch.equal(xg.grad, want[0])
    assert all(torch.equal(t.grad, w_) for t, w_ in zip(leaves, want[1:]))
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)


def test_bf16_storage_arm_has_counters_and_raises_at_f32():
    """The arm counts under names of its own (`spectral_fwd_save_bf16acts`,
    `spectral_bwd_reread_bf16acts`), and calls on CPU tensors count nothing;
    both switches default to the JAX package's (f32 storage); an act dtype
    other than f32 and bf16 is refused."""
    assert ops.KERNELS["spectral_fwd_save_bf16acts"] is cuda_spectral.spe_seq_cell_save_bf16acts
    assert (ops.KERNELS["spectral_bwd_reread_bf16acts"]
            is cuda_spectral.spe_seq_cell_bwd_reread_bf16acts)
    assert cuda_spectral.SAVE_ACTS_F32 is True and ps.SAVE_ACTS_F32 is True
    rng = np.random.default_rng(83)
    glu = params_from_jax(_glu(6, 12, 5), "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 4, 6, 12)).astype(np.float32))
    ops.reset_launches()
    out, acts = cuda_spectral.spe_seq_cell_save_bf16acts(x, glu, 5)
    assert acts.dtype == torch.bfloat16
    dx, _ = cuda_spectral.spe_seq_cell_bwd_reread_bf16acts(x, glu, torch.ones_like(out), acts, 5)
    assert dx.shape == x.shape
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
    with pytest.raises(ValueError):
        ops.spe_seq_cell_save(x, glu, 5, BF16, act_dtype="float16")


def _leaf_tree(tree):
    if isinstance(tree, dict):
        return {k: _leaf_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def test_model_bf16_step_with_bf16_acts_matches_pallas(interpret, monkeypatch):
    """The whole training forward and every gradient at compute_dtype
    bfloat16 with both packages' SAVE_ACTS_BWD on and SAVE_ACTS_F32 off,
    against `stemgnn.forward(..., use_pallas=True, precision="bfloat16")`
    (N = 20, batch 3, the same dropout mask): the forecast bit for bit the
    f32-storage arm's on the port's side and within 1e-5 of JAX's, the loss
    within 1e-5, each gradient within 3e-3 of its largest entry (the bf16
    spectral backward's sums, as test_torch_port_bf16.py holds the
    f32-storage arm; measured 1.3e-3)."""
    _bf16_arrays(monkeypatch)
    monkeypatch.setattr(cuda_spectral, "SAVE_ACTS_BWD", True)
    n, b, w, m = 20, 3, 12, 5
    cfg = StemGNNConfig(units=n, window_size=w, horizon=3, multi_layer=m)
    jcfg = JaxConfig(units=n, window_size=w, horizon=3, multi_layer=m, pallas_min_nodes=0)
    np_tree = torch_stream_init(0, jcfg)
    rng = np.random.default_rng(84)
    x = rng.standard_normal((b, w, n)).astype(np.float32)
    y = rng.standard_normal((b, 3, n)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - jcfg.dropout_rate, (b, n, n)))

    def loss_fn(p):
        f, _ = jax_stemgnn.forward(p, jcfg, jnp.asarray(x), training=True, dropout_rng=key,
                                   use_pallas=True, precision=BF16)
        return jnp.mean((f - jnp.asarray(y)) ** 2), f

    with jax.default_matmul_precision(BF16):
        (jloss, jf), jg = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, np_tree))
    jgrads = flatten_params(jax.tree.map(np.asarray, jg))

    def port_step(acts_f32):
        monkeypatch.setattr(cuda_spectral, "SAVE_ACTS_F32", acts_f32)
        params = _leaf_tree(np_tree)
        f, _ = forward(params, cfg, _t(x), training=True, dropout_mask=_t(mask),
                       compute_dtype=BF16)
        loss = torch.mean((f - _t(y)) ** 2)
        loss.backward()
        return f.detach(), loss.detach(), flatten_params(params)

    tf, tloss, tparams = port_step(False)
    tf32acts, _, _ = port_step(True)
    assert torch.equal(tf, tf32acts)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert abs(float(tloss) - float(jloss)) < 1e-5
    for name, p in tparams.items():
        if p.grad is None:  # stack 1's unused shortcut: zeros from jax.grad
            assert not jgrads[name].any(), name
            continue
        assert _rel(p.grad.numpy(), jgrads[name]) <= 3e-3, (name, _rel(p.grad.numpy(),
                                                                         jgrads[name]))
