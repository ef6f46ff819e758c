"""Data pipeline: CSV ingest, NaN fill, normalization, sliding windows.

Reference semantics preserved exactly:
- CSV load via `pd.read_csv(file).values` (main.py:42) — note pandas'
  default header=0 consumes the first CSV row as column names; the
  reference datasets are headerless so one sample row is silently
  dropped. We replicate this.
- ratio split by row-count truncation (main.py:45-50)
- forward-fill then backward-fill NaNs (forecast_dataloader.py:48-49)
- min_max normalize: (x-min)/(max-min+1e-5), clipped to [0,1]
  (forecast_dataloader.py:8-13); de-normalize uses the ASYMMETRIC epsilon
  1e-8 (forecast_dataloader.py:29) — both kept.
- z_score: per-column std==0 replaced by 1 (forecast_dataloader.py:19)
- window index set: hi in [window_size, T-horizon] strided by interval
  (forecast_dataloader.py:68-73)

There is no per-item Dataset/DataLoader. The normalized split moves to the
device once as one [T, N] tensor; batches are gathered there from a [B]
vector of window end indices (see train.engine).

A numpy/pandas copy of stemgnn_tpu/data/pipeline.py: the port never
imports the JAX package, and tests hold the two to identical outputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd


def load_csv(path: str) -> np.ndarray:
    """pd.read_csv(path).values — replicates main.py:42 (header row consumed)."""
    return pd.read_csv(path).values


def split_by_ratio(
    data: np.ndarray, train_length: float, valid_length: float, test_length: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ratio split by row truncation (main.py:45-50)."""
    total = train_length + valid_length + test_length
    train_ratio = train_length / total
    valid_ratio = valid_length / total
    t = len(data)
    train = data[: int(train_ratio * t)]
    valid = data[int(train_ratio * t) : int((train_ratio + valid_ratio) * t)]
    test = data[int((train_ratio + valid_ratio) * t) :]
    return train, valid, test


def ffill_bfill(data: np.ndarray) -> np.ndarray:
    """Forward- then backward-fill NaNs per column (forecast_dataloader.py:48-49)."""
    df = pd.DataFrame(data)
    return df.ffill(limit=len(df)).bfill(limit=len(df)).values


def compute_norm_stats(train_data: np.ndarray, method: str) -> Optional[Dict]:
    """Stats from the TRAIN split only, as json-able lists (handler.py:112-121)."""
    if method == "z_score":
        return {
            "mean": np.mean(train_data, axis=0).tolist(),
            "std": np.std(train_data, axis=0).tolist(),
        }
    if method == "min_max":
        return {
            "min": np.min(train_data, axis=0).tolist(),
            "max": np.max(train_data, axis=0).tolist(),
        }
    return None


def normalized(
    data: np.ndarray, normalize_method: str, norm_statistic: Optional[Dict] = None
) -> Tuple[np.ndarray, Optional[Dict]]:
    """forecast_dataloader.py:7-22 semantics (epsilon 1e-5, clip, std==0 -> 1)."""
    if normalize_method == "min_max":
        if not norm_statistic:
            norm_statistic = {
                "max": np.max(data, axis=0),
                "min": np.min(data, axis=0),
            }
        lo = np.asarray(norm_statistic["min"], dtype=np.float64)
        hi = np.asarray(norm_statistic["max"], dtype=np.float64)
        scale = hi - lo + 1e-5
        data = np.clip((data - lo) / scale, 0.0, 1.0)
    elif normalize_method == "z_score":
        if not norm_statistic:
            norm_statistic = {
                "mean": np.mean(data, axis=0),
                "std": np.std(data, axis=0),
            }
        mean = np.asarray(norm_statistic["mean"], dtype=np.float64)
        std = np.asarray(norm_statistic["std"], dtype=np.float64)
        std = np.where(std == 0, 1.0, std)  # (:19)
        data = (data - mean) / std
        norm_statistic["std"] = std.tolist()
    return data, norm_statistic


def de_normalized(
    data: np.ndarray, normalize_method: str, norm_statistic: Dict
) -> np.ndarray:
    """forecast_dataloader.py:25-38 — min_max uses epsilon 1e-8 HERE (vs 1e-5
    in `normalized`); the asymmetry is a reference quirk kept for parity."""
    if normalize_method == "min_max":
        lo = np.asarray(norm_statistic["min"], dtype=np.float64)
        hi = np.asarray(norm_statistic["max"], dtype=np.float64)
        scale = hi - lo + 1e-8
        return data * scale + lo
    if normalize_method == "z_score":
        mean = np.asarray(norm_statistic["mean"], dtype=np.float64)
        std = np.asarray(norm_statistic["std"], dtype=np.float64)
        std = np.where(std == 0, 1.0, std)
        return data * std + mean
    return data


def window_end_indices(
    df_length: int, window_size: int, horizon: int, interval: int = 1
) -> np.ndarray:
    """The reference's x_end_idx (forecast_dataloader.py:68-73):
    hi in range(window_size, df_length - horizon + 1), strided by interval."""
    x_index_set = range(window_size, df_length - horizon + 1)
    n = len(x_index_set) // interval
    return np.array([x_index_set[j * interval] for j in range(n)], dtype=np.int32)


class WindowDataset:
    """Normalized split + window index set (ForecastDataset equivalent).

    Holds the full normalized split as one float32 [T, N] array; windows are
    views x = data[hi-W:hi], y = data[hi:hi+horizon] (forecast_dataloader.py:56-63).
    """

    def __init__(
        self,
        raw: np.ndarray,
        window_size: int,
        horizon: int,
        normalize_method: Optional[str] = None,
        norm_statistic: Optional[Dict] = None,
        interval: int = 1,
    ):
        self.window_size = window_size
        self.horizon = horizon
        self.interval = interval
        self.normalize_method = normalize_method
        self.norm_statistic = norm_statistic
        data = ffill_bfill(raw)
        self.x_end_idx = window_end_indices(len(data), window_size, horizon, interval)
        if normalize_method:
            data, self.norm_statistic = normalized(
                data, normalize_method, norm_statistic
            )
        self.data = np.ascontiguousarray(data, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.x_end_idx)

    @property
    def node_cnt(self) -> int:
        return self.data.shape[1]

    def get(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        hi = int(self.x_end_idx[index])
        return (
            self.data[hi - self.window_size : hi],
            self.data[hi : hi + self.horizon],
        )

    def epoch_batches(
        self,
        batch_size: int,
        shuffle: bool,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = False,
    ) -> List[np.ndarray]:
        """Per-epoch batch index lists (DataLoader equivalent, handler.py:136-138)."""
        idx = np.arange(len(self.x_end_idx))
        if shuffle:
            assert rng is not None
            rng.shuffle(idx)
        batches = [
            self.x_end_idx[idx[i : i + batch_size]]
            for i in range(0, len(idx), batch_size)
        ]
        if drop_last and batches and len(batches[-1]) < batch_size:
            batches.pop()
        return batches
