"""Checkpoints and norm stats.

Reference contract (handler.py:16-38,169,179-187): a checkpoint per epoch
at `<dir>/<epoch>_stemgnn.ckpt` plus a best-by-validation-MAE checkpoint at
`<dir>/_stemgnn.ckpt`; `load` returns None when the file is missing; norm
stats travel separately as `norm_stat.json` (handler.py:122-124).

Beyond the reference, as in the JAX package: a checkpoint also carries the
optimizer state and a meta dict (epoch, best validation MAE, its
non-decrease count), which is what `--resume` restores.

Format: one `torch.save` of {"params": flat state dict, "opt_state": the
optimizer's `state_dict()` or None, "meta": dict}, with the parameter tree
flattened to "/"-joined names and every tensor on the CPU. The optimizer's
parameters are numbered in that flattened order. Writes are synchronous and
atomic (tmp file + os.replace).
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
    opt_state: Optional[Dict] = None,
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
        "opt_state": _to_cpu(opt_state),
        "meta": dict(meta or {}),
    }
    path = _path(model_dir, epoch)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_cpu(v) for v in obj]
    return obj


def load(
    model_dir: str,
    *,
    epoch: Optional[int] = None,
    device="cuda",
) -> Optional[Tuple[Any, Optional[Dict], Dict]]:
    """Restore (params, opt_state, meta), params onto `device`; None if
    absent (handler.py:34-35). opt_state is what `save` was given (an
    optimizer `state_dict()` with CPU tensors, for `load_state_dict`)."""
    dev = resolve_device(device)
    if not model_dir:
        return None
    path = _path(model_dir, epoch)
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = unflatten_params({k: v.to(dev) for k, v in state["params"].items()})
    return params, state.get("opt_state"), state["meta"]


def latest_epoch(model_dir: str) -> Optional[int]:
    """Highest epoch number with a checkpoint on disk (for --resume)."""
    if not os.path.isdir(model_dir):
        return None
    epochs = []
    for name in os.listdir(model_dir):
        if name.endswith(CKPT_SUFFIX) and name != CKPT_SUFFIX:
            stem = name[: -len(CKPT_SUFFIX)]
            if stem.isdigit():
                epochs.append(int(stem))
    return max(epochs) if epochs else None


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
