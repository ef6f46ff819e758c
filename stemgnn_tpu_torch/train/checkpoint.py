"""Checkpoints and norm stats.

Reference contract (handler.py:16-38,169,179-187): a checkpoint per epoch
at `<dir>/<epoch>_stemgnn.ckpt` plus a best-by-validation-MAE checkpoint at
`<dir>/_stemgnn.ckpt`; `load` returns None when the file is missing; norm
stats travel separately as `norm_stat.json` (handler.py:122-124).

Format: one `torch.save` of {"params": flat state dict, "meta": dict},
with the parameter tree flattened to "/"-joined names and every tensor on
the CPU. Writes are atomic (tmp file + os.replace).
The JAX package's flax-msgpack checkpoints are not read here; JAX weights
come in through models/convert.py.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from stemgnn_tpu_torch.device import resolve_device
from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params

CKPT_SUFFIX = "_stemgnn.ckpt"


def _path(model_dir: str, epoch=None) -> str:
    epoch = str(epoch) if epoch is not None and epoch != "" else ""
    return os.path.join(model_dir, epoch + CKPT_SUFFIX)


def save(
    model_dir: str,
    params: Any,
    *,
    epoch: Optional[int] = None,
    meta: Optional[Dict] = None,
) -> str:
    """Atomically write a checkpoint; `epoch=None` writes the best-model file."""
    if model_dir is None:
        return ""
    os.makedirs(model_dir, exist_ok=True)
    state = {
        "params": {k: v.detach().cpu() for k, v in flatten_params(params).items()},
        "meta": dict(meta or {}),
    }
    path = _path(model_dir, epoch)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load(
    model_dir: str,
    *,
    epoch: Optional[int] = None,
    device="cuda",
) -> Optional[Tuple[Any, Dict]]:
    """Restore (params, meta) onto `device`; None if absent."""
    dev = resolve_device(device)
    if not model_dir:
        return None
    path = _path(model_dir, epoch)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = unflatten_params({k: v.to(dev) for k, v in state["params"].items()})
    return params, state["meta"]


def save_norm_stat(result_dir: str, normalize_statistic: Optional[Dict]) -> None:
    """norm_stat.json contract (handler.py:122-124)."""
    if normalize_statistic is None:
        return
    os.makedirs(result_dir, exist_ok=True)
    tmp = os.path.join(result_dir, "norm_stat.json.tmp")
    with open(tmp, "w") as f:
        json.dump(normalize_statistic, f)
    os.replace(tmp, os.path.join(result_dir, "norm_stat.json"))


def load_norm_stat(result_dir: str) -> Dict:
    """handler.py:195-196."""
    with open(os.path.join(result_dir, "norm_stat.json"), "r") as f:
        return json.load(f)
