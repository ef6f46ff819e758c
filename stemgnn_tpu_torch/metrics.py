"""Evaluation metrics — exact reference semantics (utils/math_utils.py).

Computed host-side in numpy on de-normalized arrays, as the reference does
(handler.py:73-79). Quirks kept: MAPE adds 1e-5 *outside* the division and
caps per-element APE at 5 == 500% (math_utils.py:32-34); all outputs are
float64.
"""

from __future__ import annotations

import numpy as np


def MAPE(v, v_, axis=None):
    """math_utils.py:24-34: mean(min(|y_hat-y|/|y| + 1e-5, 5))."""
    mape = (np.abs(v_ - v) / np.abs(v) + 1e-5).astype(np.float64)
    mape = np.where(mape > 5, 5, mape)
    return np.mean(mape, axis)


def masked_MAPE(v, v_, axis=None):
    """math_utils.py:4-21 (dead code in the reference; kept for API parity)."""
    mask = v == 0
    percentage = np.abs(v_ - v) / np.abs(v)
    if np.any(mask):
        masked_array = np.ma.masked_array(percentage, mask=mask)
        result = masked_array.mean(axis=axis)
        if isinstance(result, np.ma.MaskedArray):
            return result.filled(np.nan)
        return result
    return np.mean(percentage, axis).astype(np.float64)


def RMSE(v, v_, axis=None):
    """math_utils.py:37-45."""
    return np.sqrt(np.mean((v_ - v) ** 2, axis)).astype(np.float64)


def MAE(v, v_, axis=None):
    """math_utils.py:48-56."""
    return np.mean(np.abs(v_ - v), axis).astype(np.float64)


def evaluate(y, y_hat, by_step=False, by_node=False):
    """math_utils.py:59-74: (mape, mae, rmse) with axis dispatch.

    y, y_hat: [count, horizon, node].
    """
    if not by_step and not by_node:
        return MAPE(y, y_hat), MAE(y, y_hat), RMSE(y, y_hat)
    if by_step and by_node:
        return MAPE(y, y_hat, axis=0), MAE(y, y_hat, axis=0), RMSE(y, y_hat, axis=0)
    if by_step:
        return (
            MAPE(y, y_hat, axis=(0, 2)),
            MAE(y, y_hat, axis=(0, 2)),
            RMSE(y, y_hat, axis=(0, 2)),
        )
    if by_node:
        return (
            MAPE(y, y_hat, axis=(0, 1)),
            MAE(y, y_hat, axis=(0, 1)),
            RMSE(y, y_hat, axis=(0, 1)),
        )
