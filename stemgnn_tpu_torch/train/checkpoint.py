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
parameters are numbered in that flattened order. Writes are atomic (tmp file
+ os.replace): synchronous through `save`, or through `AsyncCheckpointer`,
which clones the state on its device and copies and writes it on a worker
thread while training goes on.
The JAX package's flax-msgpack checkpoints are not read here; JAX weights
come in through models/convert.py.
"""

from __future__ import annotations

import json
import os
import queue
import threading
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


def _map_tensors(fn, obj):
    """`obj` with `fn` applied to every tensor in its dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_map_tensors(fn, v) for v in obj]
    return obj


def _to_cpu(obj):
    return _map_tensors(lambda t: t.detach().cpu(), obj)


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


class AsyncCheckpointer:
    """Checkpoint writes that overlap the next epoch
    (stemgnn_tpu/train/checkpoint.py `AsyncCheckpointer`).

    `submit` clones the parameters and the optimizer state on their device,
    which is all the training loop waits for. The clone is needed because the
    port updates parameters in place: the next step, or the next replay of a
    captured graph, would otherwise change what the worker is still copying.
    One worker thread then copies the clone to the host (on a stream of its
    own, after the clone has finished) and writes the file through `save`.
    One queue and one worker, so files are written in the order submitted; the
    queue holds at most `max_pending` snapshots, and `submit` blocks beyond
    that instead of piling up copies of the model. A worker's error is raised
    by the next `submit`, `wait` or `close`.
    """

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        stream = None
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            model_dir, params, opt_state, epoch, meta, ready, dev = item
            try:
                if ready is not None:
                    stream = stream or torch.cuda.Stream(dev)
                    stream.wait_event(ready)
                    with torch.cuda.stream(stream):
                        save(model_dir, params, opt_state, epoch=epoch, meta=meta)
                else:
                    save(model_dir, params, opt_state, epoch=epoch, meta=meta)
            except Exception as e:  # raised again by the next submit, wait or close
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, model_dir: str, params: Any, opt_state: Optional[Dict] = None, *,
               epoch: Optional[int] = None, meta: Optional[Dict] = None):
        """Snapshot `params` and `opt_state` (an optimizer's `state_dict()`)
        on their device and queue the write."""
        self._raise_pending()
        if model_dir is None:
            return

        def clone(t):
            return t.detach().clone()

        params = {k: clone(v) for k, v in flatten_params(params).items()}
        opt_state = _map_tensors(clone, opt_state)
        ready = None
        dev = next(iter(params.values())).device
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        self._q.put((model_dir, params, opt_state, epoch, dict(meta or {}), ready, dev))

    def wait(self):
        """Block until every queued checkpoint is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self):
        """Drain the queue and stop the worker, then raise a pending error."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()
