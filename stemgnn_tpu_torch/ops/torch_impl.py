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

The backward functions (`gru_scan_bwd`, `attention_kq_bwd`,
`spe_seq_cell_bwd`, `spe_seq_cell_bwd_reread`) and `spe_seq_cell_save` are
the plain versions of the CUDA backward kernels and the saving forward.
They are written as explicit formulas over the tensors the forward saves,
not as autograd of the forward, so they pin the saved-tensor contract that
the kernels follow.

`cheb_graph_conv` and the spectral functions take `compute_dtype`, the JAX
package's precision policy: at "bfloat16" they round what the JAX package's
Pallas kernels take as bf16 operands (`.to(torch.bfloat16)` and back), at
the same points, and multiply in the tensors' own dtype, so every product of
two rounded values is exact and only the sums' order differs from a bf16 x
bf16 -> f32 matrix unit. A bf16 `torch.matmul` would round its output to bf16,
which the JAX kernels do not, so none is used.
"""

from __future__ import annotations

import functools

import numpy as np
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


# compute_dtype (the JAX package's precision policy) -> the dtype of the
# operands of the graph conv's and the spectral cell's products
OPERAND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def operand_dtype(compute_dtype: str):
    if compute_dtype not in OPERAND_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                         f"{tuple(OPERAND_DTYPES)}")
    return OPERAND_DTYPES[compute_dtype]


def rounding(compute_dtype: str):
    """t -> t rounded to the operand precision of `compute_dtype`, in t's own
    dtype: the identity for "float32"; for "bfloat16" to the nearest bf16
    (ties to even, as the JAX package's astype)."""
    dtype = operand_dtype(compute_dtype)
    if dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(dtype).to(t.dtype)


def cheb_graph_conv(mul_L, x, compute_dtype: str = "float32"):
    """Chebyshev-Laplacian graph convolution: [K,N,N],[B,N,W] -> [B,K,N,W];
    at "bfloat16" of mul_L and x rounded to bf16 (pallas_graph.py `_forward`)."""
    rnd = rounding(compute_dtype)
    return torch.einsum("knm,bmw->bknw", rnd(mul_L), rnd(x))


def order_contract(gconv, weight):
    """Per-order weight contraction summed over orders (base_model.py:66-67).

    gconv: [B, K, N, U]; weight: [K, U, U]. Returns [B, N, U].
    """
    return torch.einsum("bknu,kuv->bnv", gconv, weight)


def spe_seq_cell(x, glu_params, multi: int, compute_dtype: str = "float32"):
    """Spectral-sequential cell: [B, K, N, W] -> [B, K, N, W*multi].

    Full (not one-sided) FFT along W; real and imaginary parts flattened to
    [B, N, K*W] pass through 3 GLUs each (even-indexed GLUs on the real
    part, odd on the imaginary); the widened spectra are inverse-
    transformed as a length-(W*multi) spectrum and the real part is kept.
    At "bfloat16" the output of `spe_seq_cell_save`, which rounds where the
    JAX package's kernel rounds (its DFTs are products, not an FFT).
    """
    if compute_dtype != "float32":
        return spe_seq_cell_save(x, glu_params, multi, compute_dtype)[0]
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
    x_proj = gru_input_projection(gru, x)  # [N, B, 3H]
    return gru_scan(x_proj, gru["w_hh"].T, gru["b_hh"])


def gru_scan(x_proj, w_hh_t, b_hh, save: bool = False):
    """The recurrence core of `gru_over_nodes`.

    x_proj [N, B, 3H] (gates r, z, n along the last axis), w_hh_t [H, 3H],
    b_hh [3H] -> out [B, N, H]. With `save`, also the activations the
    backward needs, saved [N, 5, B, H] = (r, z, hpn, c, h_prev - c) per step
    (stemgnn_tpu/ops/pallas_gru.py `_fwd_kernel`), as (out, saved).
    """
    n, b, _ = x_proj.shape
    h_dim = w_hh_t.shape[0]
    h = x_proj.new_zeros((b, h_dim))
    outs, saved = [], []
    for xp in x_proj:
        hp = h @ w_hh_t + b_hh
        r = torch.sigmoid(xp[:, :h_dim] + hp[:, :h_dim])
        z = torch.sigmoid(xp[:, h_dim : 2 * h_dim] + hp[:, h_dim : 2 * h_dim])
        hpn = hp[:, 2 * h_dim :]
        c = torch.tanh(xp[:, 2 * h_dim :] + r * hpn)
        if save:
            saved.append(torch.stack([r, z, hpn, c, h - c]))
        h = (1.0 - z) * c + z * h
        outs.append(h)
    out = torch.stack(outs, dim=1)  # [B, N, H]
    return (out, torch.stack(saved)) if save else out


def gru_scan_bwd(saved, g, a_all):
    """Reverse recurrence over the saved activations (pallas_gru.py
    `_bwd_kernel`): elementwise gate gradients and one [B, 3H] x [3H, H]
    product per step on the dh chain.

    saved [N, 5, B, H], g [B, N, H] (cotangent of the output sequence),
    a_all [H, 3H] (= W_hh^T) -> dxp [N, B, 3H], the gradient of x_proj
    (dr, dz, dn along the last axis). The gradient of the recurrent product
    h @ a_all is (dr, dz, dn * r): the caller forms it from dxp and saved.
    """
    n, _, b, h_dim = saved.shape
    dh = g.new_zeros((b, h_dim))
    a_t = a_all.T
    dxp = [None] * n
    for t in range(n - 1, -1, -1):
        r, z, hpn, c, hmc = saved[t]
        dh_total = g[:, t] + dh
        dz = dh_total * hmc * z * (1.0 - z)
        dn = dh_total * (1.0 - z) * (1.0 - c * c)
        dr = dn * hpn * r * (1.0 - r)
        dxp[t] = torch.cat([dr, dz, dn], dim=-1)
        dh = dh_total * z + torch.cat([dr, dz, dn * r], dim=-1) @ a_t
    return torch.stack(dxp)


def gru_weight_grads(saved, out, dxp):
    """(d w_hh_t [H, 3H], d b_hh [3H]) from the saved states, as products
    over all steps at once (pallas_gru.py `_vjp_bwd`, after the kernel)."""
    n, _, b, h_dim = saved.shape
    hs = out.transpose(0, 1)  # [N, B, H]
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]], dim=0)
    dcat = torch.cat([dxp[..., : 2 * h_dim], dxp[..., 2 * h_dim :] * saved[:, 0]],
                     dim=-1).reshape(n * b, 3 * h_dim)
    return h_prev.reshape(n * b, h_dim).T @ dcat, dcat.sum(dim=0)


def attention_kq_bwd(key, query, p, g, alpha: float):
    """Backward of `attention_from_kq` from its saved output p
    (pallas_attention.py `_bwd_kernel`): softmax backward, LeakyReLU
    backward by the recomputed pre-activation sign, then dkey as row sums
    and dquery as column sums. key, query [B, N]; p, g [B, N, N]."""
    gp = g * p
    dl = gp - p * gp.sum(dim=-1, keepdim=True)
    pre = key[:, :, None] + query[:, None, :]
    dpre = torch.where(pre >= 0, dl, alpha * dl)
    return dpre.sum(dim=2), dpre.sum(dim=1)


@functools.lru_cache(maxsize=16)
def dft_matrices(w: int, k: int, wm: int):
    """Block-diagonal forward/inverse DFT matrices (numpy float64, cached).

    Forward (length w, k blocks):  R = x @ Cf,  I = x @ Sf
        Cf[n, j] = cos(2 pi n j / w),  Sf[n, j] = -sin(2 pi n j / w)
    Inverse (length wm, real part): y = R @ Ci + I @ Si
        Ci[j, n] = cos(2 pi j n / wm) / wm,  Si[j, n] = -sin(...) / wm
    (stemgnn_tpu/ops/pallas_spectral.py `_dft_matrices`, kept at float64
    here and cast by the caller)
    """
    n_idx = np.arange(w)
    ang_f = 2.0 * np.pi * np.outer(n_idx, n_idx) / w
    m_idx = np.arange(wm)
    ang_i = 2.0 * np.pi * np.outer(m_idx, m_idx) / wm
    eye = np.eye(k)
    return tuple(np.kron(eye, m) for m in (
        np.cos(ang_f), -np.sin(ang_f), np.cos(ang_i) / wm, -np.sin(ang_i) / wm))


@functools.lru_cache(maxsize=16)
def _dft_tensors(w: int, k: int, wm: int, device, dtype):
    """`dft_matrices` as tensors of `dtype` on `device` (cached, so a call
    that repeats moves nothing from the host)."""
    return tuple(torch.from_numpy(m).to(device=device, dtype=dtype)
                 for m in dft_matrices(w, k, wm))


def _folded_glu_weights(glu_params, cf, sf):
    """(wl, wr) of the six GLUs with the forward DFT folded into layer 0:
    Cf @ W for GLU 0 (real chain), Sf @ W for GLU 1 (imaginary chain)."""
    out = []
    for i, p in enumerate(glu_params):
        wl, wr = p["left"]["w"], p["right"]["w"]
        if i < 2:
            dft = cf if i == 0 else sf
            wl, wr = dft @ wl, dft @ wr
        out.append((wl, wr))
    return out


def _rows(t):
    """[B, K, N, C] -> [B*N, K*C]."""
    b, k, n, c = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * n, k * c)


def spe_seq_cell_save(x, glu_params, multi: int, compute_dtype: str = "float32",
                      act_dtype: str = "float32"):
    """`spe_seq_cell` over the folded-DFT chain that also returns each GLU's
    linear output a and gate s (pallas_spectral.py `_kernel_save`).

    x [B,K,N,W] -> (out [B,K,N,W*multi], acts [12, B*N, K*W*multi]: a0, s0,
    ..., a5, s5, GLU 2 * layer + chain). At "bfloat16" the operands of every
    product are rounded as `_forward` and `_kernel_save` round them: x, the
    folded 2-D weights (the fold in full precision first), Ci, Si and each
    GLU's input; biases, a, s and out are not. acts are stored in `act_dtype`:
    x's dtype at "float32", or bf16 tensors at "bfloat16" (the JAX package's
    act_dtype with SAVE_ACTS_F32 off, pallas_spectral.py:213: each a and s
    rounded to nearest as it is stored; the chain and the output go on from
    the unrounded values)."""
    b, k, n, w = x.shape
    wm = w * multi
    rnd = rounding(compute_dtype)
    cf, sf, ci, si = _dft_tensors(w, k, wm, x.device, x.dtype)
    rows = _rows(x)
    cur = [rows, rows]
    acts = []
    for i, (p, (wl, wr)) in enumerate(zip(glu_params,
                                          _folded_glu_weights(glu_params, cf, sf))):
        u = rnd(cur[i % 2])
        a = u @ rnd(wl) + p["left"]["b"]
        s = torch.sigmoid(u @ rnd(wr) + p["right"]["b"])
        acts += [a, s]
        cur[i % 2] = a * s
    out = rnd(cur[0]) @ rnd(ci) + rnd(cur[1]) @ rnd(si)
    acts = torch.stack(acts)
    if operand_dtype(act_dtype) != torch.float32:
        acts = acts.to(operand_dtype(act_dtype))
    return out.reshape(b, n, k, wm).permute(0, 2, 1, 3), acts


def spe_seq_cell_bwd_reread(x, glu_params, g, acts, multi: int,
                            compute_dtype: str = "float32"):
    """Backward of `spe_seq_cell` from the saved (a, s) of each GLU
    (pallas_spectral.py `_bwd_kernel_reread` and `_backward_reread`).

    The input u of a GLU is rebuilt as a * s of the GLU before it on its chain
    (x for layer 0): no product and no sigmoid before the backward sweep. Then
    the inverse DFT and the six GLUs are backpropagated and the layer-0 weight
    gradients unfolded (dW = Cf^T @ dAW). x [B,K,N,W], g [B,K,N,W*multi], acts
    [12, >= B*N, K*W*multi] (rows past B*N are padding; f32, or the bf16 of
    `spe_seq_cell_save(..., act_dtype="bfloat16")`, upcast as
    `_bwd_kernel_reread` upcasts them, so u = a * s and every use of a and s
    takes the rounded values) -> (dx like x, dglu: six dicts like
    glu_params). At "bfloat16" both operands of every product are rounded, as
    the JAX kernel's `dot` rounds them: g, Ci, Si, the folded weights, u, da
    and ds (the bias gradients sum da and ds unrounded; the unfold is in full
    precision)."""
    b, k, n, w = x.shape
    wm = w * multi
    rnd = rounding(compute_dtype)
    cf, sf, ci, si = _dft_tensors(w, k, wm, x.device, x.dtype)
    fold = (cf, sf)
    weights = _folded_glu_weights(glu_params, cf, sf)
    rows, gr = _rows(x), rnd(_rows(g))
    cur = [rows, rows]
    saved = []
    for i in range(6):
        a, s = (acts[j, : b * n].to(x.dtype) for j in (2 * i, 2 * i + 1))
        saved.append((rnd(cur[i % 2]), a, s))
        cur[i % 2] = a * s
    d = [gr @ rnd(ci).T, gr @ rnd(si).T]
    dglu = [None] * 6
    for i in range(5, -1, -1):
        u, a, s = saved[i]
        wl, wr = weights[i]
        dy = d[i % 2]
        da = dy * s
        dspre = dy * a * (s * (1.0 - s))
        rda, rds = rnd(da), rnd(dspre)
        dwl, dwr = u.T @ rda, u.T @ rds
        if i < 2:
            dwl, dwr = fold[i].T @ dwl, fold[i].T @ dwr
        dglu[i] = {"left": {"w": dwl, "b": da.sum(dim=0)},
                   "right": {"w": dwr, "b": dspre.sum(dim=0)}}
        d[i % 2] = rda @ rnd(wl).T + rds @ rnd(wr).T
    dx = (d[0] + d[1]).reshape(b, n, k, w).permute(0, 2, 1, 3)
    return dx, dglu


def spe_seq_cell_bwd(x, glu_params, g, multi: int, compute_dtype: str = "float32"):
    """Backward of `spe_seq_cell` over the folded-DFT chain
    (pallas_spectral.py `_bwd_kernel` and `_backward`): recomputes (a, s) of
    each GLU from x, then the reread backward on them. x [B,K,N,W],
    g [B,K,N,W*multi] -> (dx like x, dglu: six dicts like glu_params)."""
    _, acts = spe_seq_cell_save(x, glu_params, multi, compute_dtype)
    return spe_seq_cell_bwd_reread(x, glu_params, g, acts, multi, compute_dtype)


def cheb_graph_conv_bwd(mul_L, x, g):
    """Backward of `cheb_graph_conv`: (d mul_L [K,N,N], dx [B,N,W])."""
    return (torch.einsum("bknw,bmw->knm", g, x),
            torch.einsum("knm,bknw->bmw", mul_L, g))
