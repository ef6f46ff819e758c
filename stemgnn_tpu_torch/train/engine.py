"""Eval engine: the reference handler's inference / validate / test
(models/handler.py:41-100,194-207), as stemgnn_tpu/train/engine.py has
them, with the same console lines and CSV artifacts.

The normalized split moves to the device once as one [T, N] tensor and each
batch is gathered there from its [B] window end indices. Every batch runs
at its true size: the short last batch is not padded, because the latent
adjacency depends on batch statistics. Training is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig
from stemgnn_tpu_torch.data.pipeline import WindowDataset, de_normalized
from stemgnn_tpu_torch.device import resolve_device
from stemgnn_tpu_torch.metrics import evaluate
from stemgnn_tpu_torch.models import stemgnn
from stemgnn_tpu_torch.train import checkpoint as ckpt


def gather_windows(data, hi, window_size: int, horizon: int):
    """(x [B,W,N], y [B,h,N]) from window end indices, on data's device.

    Mirrors ForecastDataset.__getitem__ (forecast_dataloader.py:56-63):
    x = data[hi-W:hi], y = data[hi:hi+horizon].
    """
    x_idx = hi[:, None] + torch.arange(-window_size, 0, device=hi.device)[None, :]
    y_idx = hi[:, None] + torch.arange(horizon, device=hi.device)[None, :]
    return data[x_idx], data[y_idx]


def make_eval_step(mcfg: StemGNNConfig, device="cuda"):
    """eval_step(params, x) -> forecast [B, horizon, N] on `device`.

    x may be a numpy array or a tensor; it is moved to `device`."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(params, x):
        x = torch.as_tensor(x, device=dev)
        forecast, _ = stemgnn.forward(params, mcfg, x, training=False)
        return forecast

    return eval_step


def inference(
    eval_step,
    params,
    dataset: WindowDataset,
    batch_size: int,
    node_cnt: int,
    window_size: int,
    horizon: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Autoregressive rolling decode (handler.py:41-64).

    The model emits `len_model_output` steps per call (== horizon normally,
    so one iteration); the reference's splice (shift the window left by
    len_out and write the predictions into the tail) is kept verbatim, on
    the host.
    """
    forecast_set, target_set = [], []
    for hi_batch in dataset.epoch_batches(batch_size, shuffle=False):
        b = len(hi_batch)
        xs = np.stack([dataset.data[hi - window_size : hi] for hi in hi_batch])
        ys = np.stack([dataset.data[hi : hi + horizon] for hi in hi_batch])
        inputs = xs.copy()
        step = 0
        forecast_steps = np.zeros([b, horizon, node_cnt], dtype=np.float64)
        while step < horizon:
            out = torch.as_tensor(eval_step(params, inputs)).cpu().numpy()
            len_out = out.shape[1]
            if len_out == 0:
                raise Exception("Get blank inference result")
            inputs[:, : window_size - len_out, :] = inputs[:, len_out:window_size, :]
            inputs[:, window_size - len_out :, :] = out
            take = min(horizon - step, len_out)
            forecast_steps[:, step : take + step, :] = out[:, :take, :]
            step += take
        forecast_set.append(forecast_steps)
        target_set.append(ys)
    return np.concatenate(forecast_set, axis=0), np.concatenate(target_set, axis=0)


def inference_batched(
    eval_step, params, dataset: WindowDataset, batch_size: int, device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-side eval: one pass over the batches with the split on the
    device, forecasts and targets copied back once. Valid whenever the
    model emits the full horizon per call (stemgnn.forward always does)."""
    dev = resolve_device(device)
    data = torch.from_numpy(dataset.data).to(dev)
    fcs, tgs = [], []
    for hi_batch in dataset.epoch_batches(batch_size, shuffle=False):
        hi = torch.from_numpy(hi_batch.astype(np.int64)).to(dev)
        x, y = gather_windows(data, hi, dataset.window_size, dataset.horizon)
        fcs.append(eval_step(params, x))
        tgs.append(y)
    return (
        torch.cat(fcs).cpu().numpy().astype(np.float64),
        torch.cat(tgs).cpu().numpy().astype(np.float64),
    )


def validate(
    eval_step,
    params,
    dataset: WindowDataset,
    normalize_method: Optional[str],
    statistic: Optional[Dict],
    node_cnt: int,
    window_size: int,
    horizon: int,
    batch_size: int,
    result_file: Optional[str] = None,
    device=None,
) -> Dict:
    """handler.py:67-100: metrics on de-normalized forecasts + CSV artifacts.

    With `device` the batches are gathered on that device
    (`inference_batched`); without it the host splice loop runs
    (`inference`)."""
    if device is not None:
        forecast_norm, target_norm = inference_batched(
            eval_step, params, dataset, batch_size, device)
    else:
        forecast_norm, target_norm = inference(
            eval_step, params, dataset, batch_size, node_cnt, window_size, horizon)
    if normalize_method and statistic:
        forecast = de_normalized(forecast_norm, normalize_method, statistic)
        target = de_normalized(target_norm, normalize_method, statistic)
    else:
        forecast, target = forecast_norm, target_norm
    score = evaluate(target, forecast)
    score_by_node = evaluate(target, forecast, by_node=True)
    score_norm = evaluate(target_norm, forecast_norm)
    print(f"NORM: MAPE {score_norm[0]:7.9%}; MAE {score_norm[1]:7.9f}; RMSE {score_norm[2]:7.9f}.")
    print(f"RAW : MAPE {score[0]:7.9%}; MAE {score[1]:7.9f}; RMSE {score[2]:7.9f}.")
    if result_file:
        os.makedirs(result_file, exist_ok=True)
        step_to_print = 0
        forecasting_2d = forecast[:, step_to_print, :]
        forecasting_2d_target = target[:, step_to_print, :]
        np.savetxt(f"{result_file}/target.csv", forecasting_2d_target, delimiter=",")
        np.savetxt(f"{result_file}/predict.csv", forecasting_2d, delimiter=",")
        np.savetxt(
            f"{result_file}/predict_abs_error.csv",
            np.abs(forecasting_2d - forecasting_2d_target),
            delimiter=",",
        )
        np.savetxt(
            f"{result_file}/predict_ape.csv",
            np.abs((forecasting_2d - forecasting_2d_target) / forecasting_2d_target),
            delimiter=",",
        )
    return dict(
        mae=score[1],
        mae_node=score_by_node[1],
        mape=score[0],
        mape_node=score_by_node[0],
        rmse=score[2],
        rmse_node=score_by_node[2],
    )


def test(
    test_data: np.ndarray,
    cfg: TrainConfig,
    result_train_file: str,
    result_test_file: str,
) -> Dict:
    """handler.py:194-207: restore the best checkpoint onto cfg.device and
    evaluate the test split with the TRAIN-split norm stats."""
    device = resolve_device(cfg.device)
    normalize_statistic = ckpt.load_norm_stat(result_train_file)
    node_cnt = test_data.shape[1]
    mcfg = cfg.model_config(node_cnt)
    restored = ckpt.load(result_train_file, device=device)
    if restored is None:
        raise FileNotFoundError(f"no best checkpoint in {result_train_file}")
    params, _ = restored
    test_set = WindowDataset(
        test_data, cfg.window_size, cfg.horizon, cfg.norm_method, normalize_statistic
    )
    performance_metrics = validate(
        make_eval_step(mcfg, device),
        params,
        test_set,
        cfg.norm_method,
        normalize_statistic,
        node_cnt,
        cfg.window_size,
        cfg.horizon,
        cfg.batch_size,
        result_file=result_test_file,
        device=device,
    )
    mae, mape, rmse = (
        performance_metrics["mae"],
        performance_metrics["mape"],
        performance_metrics["rmse"],
    )
    print(
        "Performance on test set: MAPE: {:5.2f} | MAE: {:5.2f} | RMSE: {:5.4f}".format(
            mape, mae, rmse
        )
    )
    return performance_metrics
