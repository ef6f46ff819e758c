"""The spectral cell's kernels (`ops/cuda_spectral.py`, `csrc/spectral.cu`).

The bytes and operations are a copy of `chip_smoke.py` `spectral_bounds`:
each input read once and each output written once, the 12 saved arrays of
the saving forward written once and read once by the reread backward, the
operations as the DFT products and GLU layers count them. A train step's
bound is, for each stack, the lesser of the two routes the port has: the
saving forward with the reread backward, or the serving forward with the
recompute backward; so a port that changes route cannot read above its
bound.
"""

from __future__ import annotations

from portbench.flops import bound_s as _bound

KERNELS = r"spectral_\w+_kernel"


def entry_work(rows: int, w: int, m: int, bf16: bool) -> dict:
    """(bytes, operations) of each of the four spectral entries on `rows`
    rows of [4, W] at multi m: "fwd" (serving), "fwd_save", "bwd_reread",
    "bwd" (recompute). f32 saved arrays."""
    k, wm = 4, w * m
    d0, d1 = k * w, k * wm
    glu_2d = 2 * (2 * d0 * d1 + 4 * d1 * d1)
    glu_b = 2 * 6 * d1
    spe_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1 + 2 * k * wm * wm) + 8 * k * w * w * d1
    glu_flops = 2 * rows * (4 * d0 * d1 + 8 * d1 * d1)
    reread_flops = 2 * glu_flops + 2 * rows * 2 * k * wm * wm + 16 * k * w * w * d1
    if bf16:
        fwd_bytes = 2 * (rows * d0 + glu_2d) + 4 * (glu_b + rows * d1)
        bwd_bytes = 2 * (rows * d0 + rows * d1 + glu_2d) + 4 * (rows * d0 + glu_2d + glu_b)
    else:
        fwd_bytes = 4 * (rows * d0 + glu_2d + glu_b + rows * d1)
        bwd_bytes = 4 * (2 * rows * d0 + rows * d1 + 2 * (glu_2d + glu_b))
    acts = 4 * 12 * rows * d1
    return {"fwd": (fwd_bytes, spe_flops), "fwd_save": (fwd_bytes + acts, spe_flops),
            "bwd_reread": (bwd_bytes + acts, reread_flops),
            "bwd": (bwd_bytes, glu_flops + reread_flops)}


def bound_s(cfg: dict, batches, training: bool, peak: float) -> float:
    w, m = cfg["window_size"], cfg["multi_layer"]
    bf16 = cfg["compute_dtype"] == "bfloat16"
    total = 0.0
    for b in batches:
        work = entry_work(b * cfg["units"], w, m, bf16)
        t = {name: _bound(nbytes, flops, peak) for name, (nbytes, flops) in work.items()}
        one = (min(t["fwd_save"] + t["bwd_reread"], t["fwd"] + t["bwd"]) if training
               else t["fwd"])
        total += cfg["stack_cnt"] * one
    return total
