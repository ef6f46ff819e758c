"""Analytic FLOPs of the StemGNN forward and train step, and the H100's
peak rates.

A copy of `stemgnn_tpu_torch/utils/flops.py`'s `forward_flops` and
`train_step_flops`, over a configuration's dict (`configs/<name>.json`), so
that the yardstick does not move with the program. Conventions:
- a multiply-add counts as 2 operations (a product [p,q]@[q,r] is 2*p*q*r);
- the FFT and inverse FFT of the spectral cell count as DFT products;
- a train step counts as 3x the forward;
- small elementwise work (softmax, gates, residuals) is left out.

The peaks are the rate at which the card can run a product at the
configuration's `compute_dtype`: float32 products that keep f32 accuracy can
run on the tensor cores (3xTF32), so a float32 configuration is held to the
TF32 tensor-core peak, 495 TFLOP/s, not the 67 TFLOP/s of the CUDA cores;
bfloat16 to 989 TFLOP/s. NVIDIA's data sheet, H100 SXM, dense, at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 495e12, "bfloat16": 989e12}


def peak_flop_per_s(cfg: dict) -> float:
    return PEAK_FLOP_PER_S[cfg["compute_dtype"]]


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    """The least seconds of work that moves `nbytes` and runs `flops`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def forward_flops(cfg: dict, batch: int) -> dict:
    """Forward-pass FLOPs of one batch, by component."""
    n, w, b = cfg["units"], cfg["window_size"], batch
    wm = w * cfg["multi_layer"]
    gin, gout = 4 * w, 4 * wm
    horizon = cfg["horizon"]
    stacks = cfg["stack_cnt"]
    gru_hidden = cfg.get("gru_hidden")
    sparse_k = cfg.get("sparse_k")
    f = {}
    if gru_hidden is not None:
        h = gru_hidden
        f["gru"] = 2.0 * n * b * w * 3 * h + 6.0 * b * n * h * h
    else:
        f["gru"] = 2.0 * n * b * w * 3 * n + 6.0 * b * n * n * n
    if sparse_k is not None:
        hdim = gru_hidden if gru_hidden is not None else n
        f["attention"] = 4.0 * b * n * hdim
        f["graph_conv"] = stacks * 2.0 * 4 * b * n * sparse_k * w
    else:
        f["attention"] = 4.0 * b * n * n
        f["cheb"] = 2 * 2.0 * n * n * n
        f["graph_conv"] = stacks * 2.0 * 4 * b * n * n * w
    dft = 2 * 2.0 * b * 4 * n * w * w
    idft = 2 * 2.0 * b * 4 * n * wm * wm
    glu = 8.0 * b * n * gin * gout + 16.0 * b * n * gout * gout
    f["spectral_cell"] = stacks * (dft + idft + glu)
    f["contraction"] = stacks * 2.0 * 4 * b * n * wm * wm
    heads = stacks * (2.0 * b * n * wm * wm + 2.0 * b * n * wm * w)
    heads += 2.0 * b * n * wm * w + 2.0 * b * n * w * w
    f["heads"] = heads
    f["fc"] = 2.0 * b * n * w * w + 2.0 * b * n * w * horizon
    return f


def train_step_flops(cfg: dict, batch: int) -> float:
    """FLOPs of one train step (forward and backward, 3x the forward)."""
    return 3.0 * sum(forward_flops(cfg, batch).values())
