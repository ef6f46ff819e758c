"""Dataset fetch/synthesis.

The reference bundles `dataset/ECG_data.csv` and `dataset/PeMS07.csv`;
this repository carries deterministic synthetic stand-ins instead. This
module provides them, with the documented
shapes (README.md:74-80: ECG 5000x140, PEMS07 T x 228, METR-LA 207,
PEMS-BAY 325, PEMS03 358, PEMS04 307, PEMS08 170, COVID-19 25) so every
config in BASELINE.json is runnable end-to-end. Real CSVs dropped into the
data dir take precedence.

The generator produces multivariate series with latent cross-node
structure (a random sparse mixing graph driving shared periodic + AR
components) so the latent-correlation layer has real signal to learn.

A numpy copy of stemgnn_tpu/data/synthetic.py; tests hold the CSVs the
two write to be byte-identical.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# name -> (T, N) documented shapes; T for traffic sets chosen to give
# realistic split sizes while staying quick to train on.
DATASET_SHAPES = {
    "ECG_data": (5000, 140),
    "PeMS07": (12672, 228),
    # full-length stand-in under its own name: the committed
    # dataset/PeMS07.csv is the T=1500 parity stand-in (kept so the
    # multi-seed parity rows stay reproducible against their exact data);
    # this name synthesizes the full documented length for scale runs
    "PeMS07-full": (12672, 228),
    "METR-LA": (34272, 207),
    "PEMS-BAY": (52116, 325),
    "PEMS03": (26208, 358),
    "PEMS04": (16992, 307),
    "PEMS07": (28224, 228),
    "PEMS08": (17856, 170),
    # upstream COVID-19 is T=335, but a 7/2/1 split of 335 rows leaves a
    # 34-row test split — too short for the documented window-28/horizon-28
    # config (the reference crashes on the empty window set). The synthetic
    # stand-in uses T=1000 so the full documented config runs end-to-end.
    "COVID-19": (1000, 25),
}


def synthesize(name: str, T: Optional[int] = None, N: Optional[int] = None,
               seed: Optional[int] = None) -> np.ndarray:
    """Deterministic synthetic [T, N] series with cross-node correlation."""
    if name in DATASET_SHAPES:
        t0, n0 = DATASET_SHAPES[name]
        T = T or t0
        N = N or n0
    if T is None or N is None:
        raise ValueError(f"unknown dataset {name!r}; pass T and N explicitly")
    if seed is None:
        seed = abs(hash(name)) % (2**31)
    rng = np.random.default_rng(seed)

    # latent factors: a few shared periodic sources + AR(1) noise
    n_factors = max(4, N // 32)
    tt = np.arange(T)[:, None]
    periods = rng.uniform(16, 288, size=n_factors)
    phases = rng.uniform(0, 2 * np.pi, size=n_factors)
    factors = np.sin(2 * np.pi * tt / periods + phases)  # [T, F]
    ar = np.zeros((T, n_factors))
    eps = rng.standard_normal((T, n_factors)) * 0.3
    for t in range(1, T):
        ar[t] = 0.9 * ar[t - 1] + eps[t]
    factors = factors + ar

    # sparse mixing: each node listens to ~3 factors
    mix = rng.standard_normal((n_factors, N)) * (
        rng.random((n_factors, N)) < min(1.0, 3.0 / n_factors)
    )
    scale = rng.uniform(0.5, 3.0, size=N)
    offset = rng.uniform(-1.0, 5.0, size=N)
    data = factors @ mix * scale + offset
    data += rng.standard_normal((T, N)) * 0.1
    if name == "COVID-19":
        # count-like positive data with trend, matching the published
        # magnitude regime (MAE ~660 at horizon 28)
        data = np.abs(data) * 300.0 + np.linspace(0, 2000, T)[:, None]
    return data.astype(np.float64)


def ensure_dataset(name: str, data_dir: str = "dataset") -> str:
    """Return path to `<data_dir>/<name>.csv`, synthesizing it if absent.

    The written CSV includes a header row to mirror the reference ingest
    contract (pd.read_csv consumes row 0 as header — main.py:42)."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"{name}.csv")
    if os.path.exists(path):
        return path
    data = synthesize(name)
    header = ",".join(str(i) for i in range(data.shape[1]))
    np.savetxt(path, data, delimiter=",", header=header, comments="")
    return path
