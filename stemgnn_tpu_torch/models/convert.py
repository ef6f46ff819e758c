"""Carry weights between stemgnn_tpu and the port.

The port keeps the JAX package's parameter layout (models/stemgnn.py
init_params): linear `w` is [in, out], the block `weight` is [4, Wm, Wm],
the GRU keeps torch's layout (`w_ih` [3N, W], `w_hh` [3N, N]) and stack 1
has no `backcast`. So a conversion is a change of array type, tree for
tree, with each array's dtype kept.

`flatten_params` / `unflatten_params` give the "/"-joined names the
module and the checkpoint store the tree under.
"""

from __future__ import annotations

import numpy as np
import torch

from stemgnn_tpu_torch.device import resolve_device


def params_from_jax(tree, device="cuda"):
    """JAX pytree (numpy arrays, or anything np.asarray takes) -> port params."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)


def params_to_jax(params):
    """Port params -> the JAX pytree layout, as numpy arrays on the host."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_jax(v) for v in params]
    return params.detach().cpu().numpy().copy()


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
