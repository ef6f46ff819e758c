"""Carry weights between stemgnn_tpu and the port.

The port keeps the JAX package's parameter layout (models/stemgnn.py
init_params): linear `w` is [in, out], the block `weight` is [4, Wm, Wm],
the GRU keeps torch's layout (`w_ih` [3N, W], `w_hh` [3N, N]) and stack 1
has no `backcast`. So a conversion is a change of array type, tree for
tree, with each array's dtype kept.

`flatten_params` / `unflatten_params` give the "/"-joined names the
module and the checkpoint store the tree under.

Optimizer state crosses the same way (`opt_state_from_jax` /
`opt_state_to_jax`): the JAX package's RMSProp state is {"nu": tree}, optax
Adam's is mu / nu / count; torch.optim keeps `square_avg`, or `exp_avg` /
`exp_avg_sq`, and `step` per parameter, numbered in the flattened order.
Every leaf keeps its own dtype, bf16 (param_dtype "bfloat16", and the moments
beside such parameters, f32 or bf16 leaf by leaf) included. numpy has no bf16
of its own: JAX's arrays come as numpy arrays of ml_dtypes' bfloat16, which
cross as their 16-bit patterns (`_to_torch`); the way back needs that dtype,
which a process that holds JAX arrays has loaded (`_to_numpy`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stemgnn_tpu_torch.device import resolve_device


def _to_torch(a, device):
    """A numpy array (or anything np.asarray takes) as a tensor of its dtype on
    `device`; a bfloat16 array (ml_dtypes) by its bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t):
    """A tensor as a numpy array of its dtype on the host; bf16 as ml_dtypes'
    bfloat16 (the dtype of JAX's bf16 arrays), taken from the process, which
    has it wherever there are JAX arrays to hand this to."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    ml_dtypes = sys.modules.get("ml_dtypes")
    if ml_dtypes is None:
        raise RuntimeError("a bf16 leaf goes to numpy as ml_dtypes.bfloat16, which this "
                           "process has not loaded (JAX loads it)")
    return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)


def params_from_jax(tree, device="cuda"):
    """JAX pytree (numpy arrays, or anything np.asarray takes) -> port params,
    each leaf of its own dtype."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _to_torch(t, dev)

    return conv(tree)


def params_to_jax(params):
    """Port params -> the JAX pytree layout, as numpy arrays on the host."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_jax(v) for v in params]
    return _to_numpy(params)


def flatten_params(tree, prefix: str = "") -> dict:
    """{'blocks': [{'glu': [{'left': {'w': t}}]}]} -> {'blocks/0/glu/0/left/w': t}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flatten_params(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten_params(flat: dict):
    """Inverse of flatten_params; a level whose keys are all digits is a list."""
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t

    return listify(tree)


def param_count(params) -> int:
    return sum(t.numel() for t in flatten_params(params).values())


_RMSPROP_KEYS = {"nu": "square_avg"}
_ADAM_KEYS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def opt_state_from_jax(state: dict, opt) -> None:
    """Load JAX optimizer moments into `opt` (RMSprop or Adam over the
    flattened parameters), each of its own dtype (f32 beside a bf16
    parameter stays f32: train/optim.py's leafwise optimizers keep it so).
    state: {"nu": tree} for RMSProp, {"mu": tree, "nu": tree, "count": int}
    for Adam, numpy leaves; "count" (steps taken) is optional and 0 if
    absent."""
    keys = _ADAM_KEYS if isinstance(opt, torch.optim.Adam) else _RMSPROP_KEYS
    leaves = [p for group in opt.param_groups for p in group["params"]]
    flat = {k: list(flatten_params(state[k]).values()) for k in keys}
    count = float(state.get("count", 0))
    per_param = {}
    for i, p in enumerate(leaves):
        entry = {"step": torch.tensor(count, dtype=torch.float32)}
        for jax_key, torch_key in keys.items():
            entry[torch_key] = _to_torch(flat[jax_key][i], p.device)
        per_param[i] = entry
    opt.load_state_dict({"state": per_param,
                         "param_groups": opt.state_dict()["param_groups"]})


def opt_state_to_jax(opt, params) -> dict:
    """The moments of `opt` as trees shaped like `params` (numpy leaves),
    with "count": {"nu", "count"} for RMSprop, {"mu", "nu", "count"} for
    Adam. `params` is the tree whose flattened leaves `opt` updates."""
    keys = _ADAM_KEYS if isinstance(opt, torch.optim.Adam) else _RMSPROP_KEYS
    leaves = [p for group in opt.param_groups for p in group["params"]]
    names = list(flatten_params(params))
    out = {}
    for jax_key, torch_key in keys.items():
        out[jax_key] = unflatten_params({
            name: _to_numpy(opt.state[p][torch_key])
            for name, p in zip(names, leaves)})
    out["count"] = int(opt.state[leaves[0]]["step"]) if opt.state else 0
    return out
