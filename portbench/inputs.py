"""What the benchmark makes from `--seed` and hands to the program and to
the reference alike: the initial weights, the raw series, the window end
indices and the seeds of the program's own random streams.

The weights are drawn on the device, in one call of a seeded generator
there, each leaf scaled to the range of the reference's initializer
(base_model.py:79-104: xavier_uniform for the key and query, torch's GRU and
Linear ranges, a uniform of xavier_normal's deviation for the order
weights). They are laid out as the port's tree, flattened to "/"-joined
names, linear weights stored [in, out].
"""

from __future__ import annotations

import math

import numpy as np
import torch

# tags of the streams drawn from one --seed
WEIGHTS, SERIES, WINDOWS, DROPOUT, SAMPLE = range(5)


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream `tag`, a function of (seed, tag) alone."""
    state = np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0]
    return int(state & np.uint64(2**63 - 1))


def leaf_specs(cfg: dict) -> list:
    """[(name, shape, bound)] of every parameter, in the port's tree order;
    each leaf is drawn uniform in [-bound, bound]."""
    n, w, h = cfg["units"], cfg["window_size"], cfg["horizon"]
    wm = w * cfg["multi_layer"]
    hid = cfg.get("gru_hidden") or n
    specs = [("weight_key", (hid, 1), 1.414 * math.sqrt(6.0 / (1 + hid))),
             ("weight_query", (hid, 1), 1.414 * math.sqrt(6.0 / (1 + hid)))]
    g = 1.0 / math.sqrt(hid)
    specs += [("gru/w_ih", (3 * hid, w), g), ("gru/w_hh", (3 * hid, hid), g),
              ("gru/b_ih", (3 * hid,), g), ("gru/b_hh", (3 * hid,), g)]

    def linear(name, d_in, d_out):
        return [(f"{name}/w", (d_in, d_out), 1.0 / math.sqrt(d_in)),
                (f"{name}/b", (d_out,), 1.0 / math.sqrt(d_in))]

    dims = [(4 * w, 4 * wm)] * 2 + [(4 * wm, 4 * wm)] * 4
    for i in range(cfg["stack_cnt"]):
        std = math.sqrt(2.0 / (4 * wm * wm + wm * wm))
        specs.append((f"blocks/{i}/weight", (4, wm, wm), math.sqrt(3.0) * std))
        specs += linear(f"blocks/{i}/forecast", wm, wm)
        specs += linear(f"blocks/{i}/forecast_result", wm, w)
        if i == 0:
            specs += linear(f"blocks/{i}/backcast", wm, w)
        specs += linear(f"blocks/{i}/backcast_short_cut", w, w)
        for j, (d_in, d_out) in enumerate(dims):
            specs += linear(f"blocks/{i}/glu/{j}/left", d_in, d_out)
            specs += linear(f"blocks/{i}/glu/{j}/right", d_in, d_out)
    specs += linear("fc1", w, w) + linear("fc2", w, h)
    return specs


def weights(cfg: dict, seed: int, device) -> dict:
    """{name: f32 tensor on `device`}: one uniform draw for every leaf from a
    generator on the device, scaled leaf by leaf in one product."""
    specs = leaf_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    bounds = torch.tensor([b for _, _, b in specs], dtype=torch.float32, device=device)
    scale = torch.repeat_interleave(bounds, torch.tensor(sizes, device=device))
    flat = (2.0 * u - 1.0) * scale
    return {name: part.view(shape) for (name, shape, _), part
            in zip(specs, torch.split(flat, sizes))}


def series(cfg: dict, rows: int, seed: int, index: int = 0) -> np.ndarray:
    """A raw multivariate series [rows, N] (float64): for each node two
    sinusoids of random period and phase and Gaussian noise, the node's
    level and scale random too. `index` numbers several series of one run."""
    n = cfg["units"]
    rng = np.random.default_rng([sub_seed(seed, SERIES), index])
    t = np.arange(rows, dtype=np.float64)[:, None]
    period = rng.uniform(8.0, 200.0, size=(2, n))
    phase = rng.uniform(0.0, 2 * np.pi, size=(2, n))
    amp = rng.uniform(0.2, 1.0, size=(2, n))
    raw = (amp[0] * np.sin(2 * np.pi * t / period[0] + phase[0])
           + amp[1] * np.sin(2 * np.pi * t / period[1] + phase[1])
           + 0.3 * rng.standard_normal((rows, n)))
    return raw * rng.uniform(0.5, 5.0, size=n) + rng.uniform(-10.0, 10.0, size=n)


def window_ends(rows: int, window: int, horizon: int) -> np.ndarray:
    """Every window end index hi of a series of `rows` rows: x = [hi-W, hi),
    y = [hi, hi + horizon) (forecast_dataloader.py:68-73)."""
    return np.arange(window, rows - horizon + 1, dtype=np.int64)
