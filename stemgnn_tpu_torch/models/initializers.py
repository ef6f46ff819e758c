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
"""

from __future__ import annotations

import math

import torch

from stemgnn_tpu_torch.device import resolve_device


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
    return tree.to(dev)
