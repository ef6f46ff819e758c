"""Plain PyTorch twins of stemgnn_tpu/ops/jnp_impl.py.

These are the semantic source of truth of the port: each CUDA kernel's
plain version is the function here, and tests hold every function against
its jnp counterpart at float64. Reference semantics:

- latent attention: base_model.py:151-162 (rank-1 additive scores,
  LeakyReLU(alpha), softmax over the last axis)
- Chebyshev graph conv: base_model.py:62-64 (mul_L[4,N,N] @ x[B,N,W])
- spectral-sequential cell: base_model.py:46-59 (full FFT along W, 3 GLU
  layers applied separately to flattened real/imag parts, inverse FFT of
  the widened spectrum, keep the real part)
- GRU over the node axis: base_model.py:137 (torch nn.GRU gate order
  r, z, n with the sequence running over nodes)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x, p):
    """x @ w + b with params {'w': [in,out], 'b': [out]}."""
    return x @ p["w"] + p["b"]


def glu(x, p):
    """Gated linear unit: left(x) * sigmoid(right(x)) (base_model.py:12-13)."""
    return dense(x, p["left"]) * torch.sigmoid(dense(x, p["right"]))


def attention_from_kq(key, query, alpha: float):
    """Rank-1 additive attention from the [B, N] key/query projections.

    scores[b, i, j] = key[b, i] + query[b, j]; LeakyReLU(alpha); row softmax.
    """
    scores = key[:, :, None] + query[:, None, :]  # [B, N, N]
    scores = F.leaky_relu(scores, negative_slope=alpha)
    return torch.softmax(scores, dim=-1)


def cheb_graph_conv(mul_L, x):
    """Chebyshev-Laplacian graph convolution: [K,N,N],[B,N,W] -> [B,K,N,W]."""
    return torch.einsum("knm,bmw->bknw", mul_L, x)


def order_contract(gconv, weight):
    """Per-order weight contraction summed over orders (base_model.py:66-67).

    gconv: [B, K, N, U]; weight: [K, U, U]. Returns [B, N, U].
    """
    return torch.einsum("bknu,kuv->bnv", gconv, weight)


def spe_seq_cell(x, glu_params, multi: int):
    """Spectral-sequential cell: [B, K, N, W] -> [B, K, N, W*multi].

    Full (not one-sided) FFT along W; real and imaginary parts flattened to
    [B, N, K*W] pass through 3 GLUs each (even-indexed GLUs on the real
    part, odd on the imaginary); the widened spectra are inverse-
    transformed as a length-(W*multi) spectrum and the real part is kept.
    """
    b, k, n, w = x.shape
    ff = torch.fft.fft(x, dim=-1)
    real = ff.real.permute(0, 2, 1, 3).reshape(b, n, k * w)
    imag = ff.imag.permute(0, 2, 1, 3).reshape(b, n, k * w)
    for i in range(3):
        real = glu(real, glu_params[2 * i])
        imag = glu(imag, glu_params[2 * i + 1])
    wm = w * multi
    real = real.reshape(b, n, k, wm).permute(0, 2, 1, 3)
    imag = imag.reshape(b, n, k, wm).permute(0, 2, 1, 3)
    return torch.fft.ifft(torch.complex(real, imag), dim=-1).real


def cheb_polynomial(laplacian):
    """Nonstandard Chebyshev basis with T0 = 0 (base_model.py:121-134).

    T0 = 0 (zeros, NOT the identity: it zeroes the k=0 branch of the order
    contraction), T1 = L, T2 = 2 L^2, T3 = 4 L^3 - L. Returns [4, N, N].
    """
    t0 = torch.zeros_like(laplacian)
    t1 = laplacian
    t2 = 2.0 * (laplacian @ t1) - t0
    t3 = 2.0 * (laplacian @ t2) - t1
    return torch.stack([t0, t1, t2, t3], dim=0)


def laplacian_from_attention(attention):
    """Mean-batch attention -> normalized Laplacian (base_model.py:140-147).

    The degree is taken from the ASYMMETRIC attention before symmetrization
    (:141 precedes :143), a reference quirk kept.

    attention: [B, N, N]. Returns (mul_L [4,N,N], sym_attention [N,N]).
    """
    att = attention.mean(dim=0)
    degree = att.sum(dim=1)
    att = 0.5 * (att + att.T)
    inv_sqrt = 1.0 / (torch.sqrt(degree) + 1e-7)
    lap = inv_sqrt[:, None] * (torch.diag(degree) - att) * inv_sqrt[None, :]
    return cheb_polynomial(lap), att


def gru_input_projection(gru, x):
    """x [B, W, N] -> x @ W_ih^T + b_ih over the node sequence, [N, B, 3H]."""
    xs = x.permute(2, 0, 1)  # [N, B, W]
    return torch.matmul(xs, gru["w_ih"].T) + gru["b_ih"]


def gru_over_nodes(gru, x):
    """torch nn.GRU applied with the NODE axis as the sequence (base_model.py:137).

    x: [B, W, N]. Each "time step" is one node; the hidden state is
    H-dimensional (H == N in the reference). Returns the output sequence
    as [B, N_seq, H]. The input projection for all steps is one matmul;
    the recurrence is a loop of [B, H] @ [H, 3H] products.
    """
    b = x.shape[0]
    x_proj = gru_input_projection(gru, x)  # [N, B, 3H]
    h_dim = gru["w_hh"].shape[1]
    w_hh_t = gru["w_hh"].T  # [H, 3H]
    b_hh = gru["b_hh"]
    h = x.new_zeros((b, h_dim))
    outs = []
    for xp in x_proj:
        hp = h @ w_hh_t + b_hh
        r = torch.sigmoid(xp[:, :h_dim] + hp[:, :h_dim])
        z = torch.sigmoid(xp[:, h_dim : 2 * h_dim] + hp[:, h_dim : 2 * h_dim])
        c = torch.tanh(xp[:, 2 * h_dim :] + r * hp[:, 2 * h_dim :])
        h = (1.0 - z) * c + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)  # [B, N_seq, H]
