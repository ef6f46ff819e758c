"""The port's op twins and kernel modules against the JAX package (CPU).

- Twins at float64: each stemgnn_tpu_torch.ops.torch_impl function against
  its stemgnn_tpu jnp counterpart under jax.enable_x64(), atol 1e-10.
- Each CUDA kernel module's plain version (what its wrapper runs on a CPU
  tensor) against the JAX Pallas kernel in interpret mode at float32, at
  the tolerances of tests/test_pallas_kernels.py.
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
from stemgnn_tpu.ops import jnp_impl
from stemgnn_tpu.ops.pallas_attention import attention_kq_pallas
from stemgnn_tpu.ops.pallas_graph import cheb_graph_conv_pallas
from stemgnn_tpu.ops.pallas_gru import gru_over_nodes_pallas
from stemgnn_tpu.ops.pallas_spectral import spe_seq_cell_pallas
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.config import StemGNNConfig
from stemgnn_tpu_torch.models.convert import params_from_jax
from stemgnn_tpu_torch.ops import torch_impl

torch.set_num_threads(1)

N, B, W, M = 20, 3, 12, 5
CFG = StemGNNConfig(units=N, window_size=W, horizon=3, multi_layer=M)
JCFG = JaxConfig(units=N, window_size=W, horizon=3, multi_layer=M,
                 pallas_min_nodes=0)


@pytest.fixture(scope="module")
def np_params():
    return torch_stream_init(0, JCFG)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return np.asarray(tree, dtype=dtype)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _lap(rng, n, dtype):
    return (rng.standard_normal((n, n)) * 0.1).astype(dtype)


def _twin_cases(rng, p):
    """(name, numpy args, jax fn, torch fn), args shared by both sides."""
    glu = p["blocks"][0]["glu"]
    lap = _lap(rng, N, np.float64)
    return [
        ("dense", (rng.standard_normal((B, N, W)),
                   p["blocks"][0]["backcast_short_cut"]),
         jnp_impl.dense, torch_impl.dense),
        ("glu", (rng.standard_normal((B, N, 4 * W)), glu[0]), jnp_impl.glu,
         torch_impl.glu),
        ("attention_from_kq", (rng.standard_normal((B, N)),
                               rng.standard_normal((B, N)), 0.2),
         jnp_impl.attention_from_kq, torch_impl.attention_from_kq),
        ("cheb_graph_conv", (jnp_impl.cheb_polynomial(lap),
                             rng.standard_normal((B, N, W))),
         jnp_impl.cheb_graph_conv, torch_impl.cheb_graph_conv),
        ("order_contract", (rng.standard_normal((B, 4, N, W * M)),
                            p["blocks"][0]["weight"]),
         jnp_impl.order_contract, torch_impl.order_contract),
        ("spe_seq_cell", (rng.standard_normal((B, 4, N, W)), glu, M),
         jnp_impl.spe_seq_cell, torch_impl.spe_seq_cell),
        ("cheb_polynomial", (lap,), jnp_impl.cheb_polynomial,
         torch_impl.cheb_polynomial),
        ("laplacian_from_attention",
         (np.asarray(jnp_impl.attention_from_kq(
             rng.standard_normal((B, N)), rng.standard_normal((B, N)), 0.2)),),
         jnp_impl.laplacian_from_attention, torch_impl.laplacian_from_attention),
        ("gru_over_nodes", (p["gru"], rng.standard_normal((B, W, N))),
         jax_stemgnn.gru_over_nodes, torch_impl.gru_over_nodes),
    ]


TWINS = ["dense", "glu", "attention_from_kq", "cheb_graph_conv",
         "order_contract", "spe_seq_cell", "cheb_polynomial",
         "laplacian_from_attention", "gru_over_nodes"]


def _to_torch(a):
    if isinstance(a, (dict, list)):
        return params_from_jax(a, device="cpu")
    if isinstance(a, float) or isinstance(a, int):
        return a
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _to_jax(a):
    if isinstance(a, (dict, list)):
        return _jnp(a)
    if isinstance(a, float) or isinstance(a, int):
        return a
    return jnp.asarray(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("name", TWINS)
def test_twin_matches_jnp_at_f64(name, np_params):
    with jax.enable_x64():
        rng = np.random.default_rng(TWINS.index(name))
        p64 = _cast(np_params, np.float64)
        case = {c[0]: c for c in _twin_cases(rng, p64)}[name]
        _, args, jfn, tfn = case
        want = jfn(*[_to_jax(a) for a in args])
        got = tfn(*[_to_torch(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w_, g_ in zip(want, got):
        assert g_.dtype == torch.float64
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0, atol=1e-10)


# --- each kernel module's plain version against its Pallas kernel (f32) ---


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def test_spectral_plain_matches_pallas(np_params, interpret):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, 4, N, W)).astype(np.float32)
    glu = np_params["blocks"][0]["glu"]
    want = spe_seq_cell_pallas(jnp.asarray(x), _jnp(glu), M)
    got = ops.spe_seq_cell(torch.from_numpy(x), params_from_jax(glu, "cpu"), M)
    assert got.shape == (B, 4, N, W * M)
    # FFT (port) against DFT-as-matmul (Pallas), as test_pallas_kernels.py:47
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)


def test_spectral_dft_fold_matches_fft(np_params):
    """The wrapper's folded DFT weights, applied as plain matmuls, give the
    FFT cell: pins the fold the CUDA kernel receives."""
    from stemgnn_tpu_torch.ops import cuda_spectral as cs

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((B, 4, N, W)).astype(np.float32))
    glu = params_from_jax(np_params["blocks"][1]["glu"], "cpu")
    cf, sf, ci, si = (torch.from_numpy(m).float()
                      for m in torch_impl.dft_matrices(W, 4, W * M))
    wts = cs.folded_weights(glu, cf, sf)
    rows = x.permute(0, 2, 1, 3).reshape(B * N, 4 * W)
    chains = [rows, rows]
    for i in range(6):
        wl, bl, wr, br = wts[4 * i : 4 * i + 4]
        u = chains[i % 2]
        chains[i % 2] = (u @ wl + bl) * torch.sigmoid(u @ wr + br)
    out = chains[0] @ ci + chains[1] @ si
    out = out.reshape(B, N, 4, W * M).permute(0, 2, 1, 3)
    want = torch_impl.spe_seq_cell(x, glu, M)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)


def test_gru_plain_matches_pallas(np_params, interpret):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, W, N)).astype(np.float32)
    want = gru_over_nodes_pallas(_jnp(np_params["gru"]), jnp.asarray(x))
    got = ops.gru_over_nodes(params_from_jax(np_params["gru"], "cpu"),
                             torch.from_numpy(x))
    assert got.shape == (B, N, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_plain_matches_pallas(interpret):
    rng = np.random.default_rng(13)
    key = rng.standard_normal((B, N)).astype(np.float32)
    query = rng.standard_normal((B, N)).astype(np.float32)
    want = attention_kq_pallas(jnp.asarray(key), jnp.asarray(query), 0.2)
    got = ops.attention_kq(torch.from_numpy(key), torch.from_numpy(query), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_graph_plain_matches_pallas(interpret):
    rng = np.random.default_rng(14)
    mul_L = np.array(jnp_impl.cheb_polynomial(
        jnp.asarray(_lap(rng, N, np.float32))))
    x = rng.standard_normal((B, N, W)).astype(np.float32)
    want = cheb_graph_conv_pallas(jnp.asarray(mul_L), jnp.asarray(x))
    got = ops.cheb_graph_conv(torch.from_numpy(mul_L), torch.from_numpy(x))
    assert got.shape == (B, 4, N, W)
    np.testing.assert_array_equal(got[:, 0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_launching(np_params):
    """On CPU tensors no wrapper builds or launches its kernel."""
    from stemgnn_tpu_torch.ops import cuda_attention, cuda_graph, cuda_gru, cuda_spectral

    ops.reset_launches()
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((B, W, N)).astype(np.float32))
    gru = params_from_jax(np_params["gru"], "cpu")
    enc = ops.gru_over_nodes(gru, x)
    ops.attention_kq(enc[:, 0].contiguous(), enc[:, 1].contiguous(), 0.2)
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)
    for m in (cuda_gru, cuda_attention, cuda_graph, cuda_spectral):
        assert m._fn.cache_info().currsize == 0, m.__name__
