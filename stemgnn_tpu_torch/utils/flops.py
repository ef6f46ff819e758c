"""Analytic FLOP model and the H100's peak rates, for the bench's
speed-of-light accounting (stemgnn_tpu/utils/flops.py, dense path).

Conventions, as in the JAX package:
- a multiply-add counts as 2 operations (a product [p,q]@[q,r] is 2*p*q*r);
- the FFT and inverse FFT of the spectral cell count as the DFT products the
  kernels execute;
- a train step counts as 3x the forward (backward about 2x forward for a
  program dominated by products; the standard MFU convention);
- small elementwise work (softmax, gates, residuals) is left out.
"""

from __future__ import annotations

from typing import Dict, Optional

from stemgnn_tpu_torch.config import StemGNNConfig


def forward_flops(cfg: StemGNNConfig, batch: int) -> Dict[str, float]:
    """Forward-pass FLOPs of one batch, by component."""
    n, w, b = cfg.units, cfg.window_size, batch
    wm = cfg.wm
    gin, gout = cfg.glu_in, cfg.glu_out  # 4W, 4Wm
    horizon = cfg.horizon
    stacks = cfg.stack_cnt
    f: Dict[str, float] = {}

    # node-axis GRU, hidden == N: the input projection and N sequential
    # [B,N]@[N,3N] products
    f["gru"] = 2.0 * n * b * w * 3 * n + 6.0 * b * n * n * n
    # rank-1 key and query projections [B,N,N]@[N,1], twice
    f["attention"] = 4.0 * b * n * n
    # Chebyshev basis: T2 = 2L^2, T3 = 2L*T2 - T1, two N^3 products
    f["cheb"] = 2 * 2.0 * n * n * n
    # graph conv: mul_L [4,N,N] @ x [B,N,W], per stack
    f["graph_conv"] = stacks * 2.0 * 4 * b * n * n * w

    # spectral cell, per stack: DFT products and 3 GLU layers on 2 chains
    dft = 2 * 2.0 * b * 4 * n * w * w
    idft = 2 * 2.0 * b * 4 * n * wm * wm
    glu = 8.0 * b * n * gin * gout + 16.0 * b * n * gout * gout
    f["spectral_cell"] = stacks * (dft + idft + glu)

    # per-order weight contraction [B,4,N,Wm] x [4,Wm,Wm], per stack
    f["contraction"] = stacks * 2.0 * 4 * b * n * wm * wm

    # block heads: forecast Wm->Wm->W, and stack 0's backcast Wm->W, W->W
    heads = stacks * (2.0 * b * n * wm * wm + 2.0 * b * n * wm * w)
    heads += 2.0 * b * n * wm * w + 2.0 * b * n * w * w
    f["heads"] = heads

    # output head: W->W, LeakyReLU, W->horizon
    f["fc"] = 2.0 * b * n * w * w + 2.0 * b * n * w * horizon
    return f


def train_step_flops(cfg: StemGNNConfig, batch: int) -> float:
    """FLOPs of one train step (forward and backward, 3x the forward)."""
    return 3.0 * sum(forward_flops(cfg, batch).values())


# Published dense peak rates of one card in TFLOP/s (NVIDIA's data sheet, SXM
# part, no sparsity, at the full power limit), keyed on a lower-case part of
# `torch.cuda.get_device_name()`: bf16 on the tensor cores, the usual MFU
# denominator, and f32 on the CUDA cores, which is what the port's f32 kernels
# can reach.
_PEAK_TFLOPS = {
    "h100": {"bf16": 989.0, "f32": 67.0},
}


def peak_tflops(device_name: str) -> Optional[Dict[str, float]]:
    """{"bf16": ..., "f32": ...} for a device name, None if unknown."""
    name = device_name.lower()
    for key in sorted(_PEAK_TFLOPS, key=len, reverse=True):
        if key in name:
            return _PEAK_TFLOPS[key]
    return None


def mfu(cfg: StemGNNConfig, batch: int, step_time_s: float,
        device_name: str) -> Dict[str, float]:
    """Achieved TFLOP/s of a measured train step and its share of the peaks.

    Always {model_flops_per_step, achieved_tflops}; for a known device also
    {peak_tflops_bf16, mfu_vs_bf16_peak, peak_tflops_f32, mfu_vs_f32_peak}
    (left out on the CPU)."""
    peak = peak_tflops(device_name)
    flops = train_step_flops(cfg, batch)
    achieved = flops / step_time_s / 1e12
    out = {"model_flops_per_step": flops, "achieved_tflops": achieved}
    if peak is not None:
        for kind in ("bf16", "f32"):
            out[f"peak_tflops_{kind}"] = peak[kind]
            out[f"mfu_vs_{kind}_peak"] = achieved / peak[kind]
    return out
