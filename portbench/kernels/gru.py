"""The GRU recurrence kernels over the node axis (`ops/cuda_gru.py`,
`csrc/gru.cu`): across clusters up to H = 360, across the whole card past it.

The bytes and operations are a copy of `chip_smoke.py` `gru_fwd_work` and
`gru_bwd_work`: the forward reads x and the GRU's tensors once and writes
the output once, with the input projection's and the recurrence's products;
the backward reads the saved gates, the output's cotangent and W_hh^T once
and writes the gradient of the projected input once. The bound leaves out
that the N steps of the recurrence run one after another.
"""

from __future__ import annotations

from portbench.flops import bound_s as _bound

KERNELS = r"gru_(fwd|bwd)_(cluster|grid)_kernel"


def fwd_work(b: int, w: int, n: int, h: int) -> tuple:
    params = 3 * h * w + 3 * h * h + 6 * h
    return (4 * (b * w * n + params + b * n * h),
            2 * n * b * w * 3 * h + 2 * n * b * h * 3 * h)


def bwd_work(b: int, n: int, h: int) -> tuple:
    return (4 * (5 * n * b * h + n * b * h + 3 * h * h + 3 * n * b * h),
            2 * n * b * 3 * h * h + 14 * n * b * h)


def bound_s(cfg: dict, batches, training: bool, peak: float) -> float:
    n, w = cfg["units"], cfg["window_size"]
    h = cfg.get("gru_hidden") or n
    total = 0.0
    for b in batches:
        total += _bound(*fwd_work(b, w, n, h), peak)
        if training:
            total += _bound(*bwd_work(b, n, h), peak)
    return total
