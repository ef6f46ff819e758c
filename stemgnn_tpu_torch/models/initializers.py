"""Parameter init in the reference's draw order.

`init_params(seed, cfg)` draws every tensor from a torch CPU generator
seeded with `seed`, in the order the reference `Model.__init__` consumes
torch's stream (base_model.py:79-104):

  weight_key, weight_query (xavier_uniform gain=1.414, :88-91) ->
  nn.GRU(W, H) reset_parameters (w_ih, w_hh, b_ih, b_hh, all
  U(-1/sqrt(H), 1/sqrt(H)), :92) -> per block (StockBlockLayer.__init__,
  :16-44): contraction weight ([1,4,1,Wm,Wm] xavier_normal, :23-26),
  forecast, forecast_result, [backcast, stack 0 only], backcast_short_cut,
  6 GLU (left, right) linears -> head fc1, fc2 (:97-101).

With seed 0 this is the draw of the reference's `torch.manual_seed(0)`
(main.py:52), and it equals stemgnn_tpu's numpy replication
(`torch_stream_init`): bitwise for the uniform draws, within 4 ulp for the
one xavier_normal tensor (torch's vectorised Box-Muller against numpy's
libm; measured at seeds 0 and 3, N = 20 and 140). Linear weights are stored transposed, [in, out];
the block weight as [4, Wm, Wm].

The GRU's hidden size H is N, or `cfg.gru_hidden` on the stretch path: then
weight_key and weight_query are [H, 1] and the GRU's tensors [3H, W],
[3H, H], [3H], [3H], drawn in the same order (the JAX package's
`init_params` and `torch_stream_init`).

`init_params_threefry(seed, cfg)` is the JAX package's other init stream,
`--init_stream threefry` (stemgnn_tpu/models/stemgnn.py `init_params`,
stemgnn_tpu/models/initializers.py): the same distributions drawn with
`jax.random` from `split(PRNGKey(seed))[1]` (stemgnn_tpu/train/engine.py),
a key split per tensor, computed in numpy by utils/threefry.py. Every leaf
is bitwise the JAX package's draw on the CPU, the two xavier_normal block
weights included (tests/test_torch_port_threefry.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stemgnn_tpu_torch.device import resolve_device
from stemgnn_tpu_torch.utils import threefry


def init_params(seed: int, cfg, device="cuda") -> dict:
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    w, wm = cfg.window_size, cfg.wm
    h = cfg.gru_hidden or cfg.units

    def lin(out_f, in_f):
        wt = torch.empty(out_f, in_f)
        torch.nn.init.kaiming_uniform_(wt, a=math.sqrt(5), generator=g)
        bound = 1.0 / math.sqrt(in_f)
        b = torch.empty(out_f).uniform_(-bound, bound, generator=g)
        return {"w": wt.T.contiguous(), "b": b}

    def xavier_uniform(shape, gain):
        t = torch.empty(shape)
        return torch.nn.init.xavier_uniform_(t, gain=gain, generator=g)

    def gru_uniform(shape):
        bound = 1.0 / math.sqrt(h)
        return torch.empty(shape).uniform_(-bound, bound, generator=g)

    params = {
        "weight_key": xavier_uniform((h, 1), 1.414),
        "weight_query": xavier_uniform((h, 1), 1.414),
        "gru": {
            "w_ih": gru_uniform((3 * h, w)),
            "w_hh": gru_uniform((3 * h, h)),
            "b_ih": gru_uniform((3 * h,)),
            "b_hh": gru_uniform((3 * h,)),
        },
        "blocks": [],
    }
    dims = [(cfg.glu_in, cfg.glu_out)] * 2 + [(cfg.glu_out, cfg.glu_out)] * 4
    for stack_i in range(cfg.stack_cnt):
        weight = torch.empty(1, 4, 1, wm, wm)
        torch.nn.init.xavier_normal_(weight, generator=g)
        blk = {
            "weight": weight.reshape(4, wm, wm),
            "forecast": lin(wm, wm),
            "forecast_result": lin(w, wm),
        }
        if stack_i == 0:
            blk["backcast"] = lin(w, wm)  # drawn between forecast_result and shortcut
        blk["backcast_short_cut"] = lin(w, w)
        blk["glu"] = [{"left": lin(d_out, d_in), "right": lin(d_out, d_in)}
                      for d_in, d_out in dims]
        params["blocks"].append(blk)
    params["fc1"] = lin(w, w)
    params["fc2"] = lin(cfg.horizon, w)
    return _to(params, dev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(dev)
    return tree.to(dev)


def _torch_fans(shape) -> tuple:
    """torch's (fan_in, fan_out) of a tensor of `shape`."""
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def init_params_threefry(seed: int, cfg, device="cuda") -> dict:
    """The JAX package's threefry init (module docstring), in the port's
    tree and key order, f32 on `device`."""
    dev = resolve_device(device)
    w, wm = cfg.window_size, cfg.wm
    h = cfg.gru_hidden or cfg.units

    def uniform(key, shape, bound):
        return threefry.uniform(key, shape, -bound, bound)

    def lin(key, in_f, out_f):
        kw, kb = threefry.split(key)
        bound = 1.0 / math.sqrt(in_f)
        return {"w": uniform(kw, (in_f, out_f), bound), "b": uniform(kb, (out_f,), bound)}

    def xavier_uniform(key, shape, gain):
        fan_in, fan_out = _torch_fans(shape)
        return uniform(key, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))

    def block(key, stack_i):
        keys = threefry.split(key, 12)
        shape = (1, 4, 1, wm, wm)
        fan_in, fan_out = _torch_fans(shape)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        blk = {"weight": (np.float32(std) * threefry.normal(keys[0], shape)).reshape(4, wm, wm),
               "forecast": lin(keys[1], wm, wm),
               "forecast_result": lin(keys[2], wm, w)}
        if stack_i == 0:
            blk["backcast"] = lin(keys[4], wm, w)
        blk["backcast_short_cut"] = lin(keys[3], w, w)
        dims = [(cfg.glu_in, cfg.glu_out)] * 2 + [(cfg.glu_out, cfg.glu_out)] * 4
        blk["glu"] = []
        for i, (d_in, d_out) in enumerate(dims):
            kl, kr = threefry.split(keys[5 + i])
            blk["glu"].append({"left": lin(kl, d_in, d_out), "right": lin(kr, d_in, d_out)})
        return blk

    key = threefry.split(threefry.prng_key(seed))[1]
    keys = threefry.split(key, 8 + cfg.stack_cnt)
    gru_keys = threefry.split(keys[2], 4)
    bound = 1.0 / math.sqrt(h)
    params = {
        "weight_key": xavier_uniform(keys[0], (h, 1), 1.414),
        "weight_query": xavier_uniform(keys[1], (h, 1), 1.414),
        "gru": {
            "w_ih": uniform(gru_keys[0], (3 * h, w), bound),
            "w_hh": uniform(gru_keys[1], (3 * h, h), bound),
            "b_ih": uniform(gru_keys[2], (3 * h,), bound),
            "b_hh": uniform(gru_keys[3], (3 * h,), bound),
        },
        "blocks": [block(keys[3 + i], i) for i in range(cfg.stack_cnt)],
        "fc1": lin(keys[3 + cfg.stack_cnt], w, w),
        "fc2": lin(keys[4 + cfg.stack_cnt], w, cfg.horizon),
    }
    return _to(params, dev)
