"""Training traffic: the port's chunked train program, as `train` runs it.

Parameters (`traffic/<name>.json`, kind "train"): `series_rows` of the
seeded series the windows are cut from; `chunk_steps`, the steps of one
dispatch of `make_epoch_fn` (one CUDA graph on the card); `pool_dispatches`,
the window-end matrices drawn in set-up, each [chunk_steps, batch] of
distinct windows, which the dispatches cycle through; `warm_dispatches`
after the first; `trace_dispatches`, the stretch a traced run profiles;
`single_steps`, the first steps, which set-up takes one to a call of the
same epoch function; `followed_chunk_steps`, the steps of the first chunk
that the check follows.

Set-up builds the one training object (parameters, RMSprop, the epoch
function, the dropout generator on the device) and drives it from the
seed: `single_steps` calls of one step each (reading RMSprop's state after
the first, from which each leaf's first gradient follows, and the
parameters after the last), then the first chunk, then the warm chunks,
and hands the same object to the window. Every window of these steps
differs. The window dispatches chunks until its seconds are up, with at
most two dispatches in flight, and ends with a synchronize: every window of
every step it ran counts.

The check follows the program's first `single_steps` +
`followed_chunk_steps` steps with the plain reference
(`reference/stemgnn.py`) from the same weights, series, windows and dropout
seed (`compare`).
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import inputs
from portbench.reference import stemgnn as ref

# a leaf whose first gradient in the reference is below this share of the
# median leaf's moves by round-off alone, and its change is not compared
ROUNDOFF_GRAD = 1e-3
# the leaves of the kernel families whose gradients are a few thousandths of
# the median leaf's, each compared against its own norm
FAMILIES = {"gru": ("gru/w_ih", "gru/w_hh", "gru/b_ih", "gru/b_hh"),
            "attention": ("weight_key", "weight_query")}
NUMBERS = ("loss_gap", "grad_gap", "change_gap") + tuple(
    f"{fam}_{kind}_gap" for fam in FAMILIES for kind in ("grad", "change"))


def model_config(cfg: dict):
    from stemgnn_tpu_torch.config import StemGNNConfig

    return StemGNNConfig(units=cfg["units"], window_size=cfg["window_size"],
                         horizon=cfg["horizon"], multi_layer=cfg["multi_layer"],
                         stack_cnt=cfg["stack_cnt"], dropout_rate=cfg["dropout_rate"],
                         leaky_rate=cfg["leaky_rate"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def given_inputs(cell) -> SimpleNamespace:
    """What the benchmark hands both sides: the raw series, the weights, the
    window ends of the single steps (`singles` [single_steps, B]) and the
    pool of window-end matrices (`pool`; the first chunk's is `pool[0]`, no
    window of which a single step has) and the dropout stream's seed."""
    cfg, tr, dev, seed = cell.cfg, cell.traffic, cell.device, cell.seed
    w, h, b = cfg["window_size"], cfg["horizon"], cfg["batch_size"]
    chunk, rows, single = tr["chunk_steps"], tr["series_rows"], tr["single_steps"]
    ends = inputs.window_ends(rows, w, h)
    if (single + chunk) * b > len(ends):
        raise ValueError(f"{single + chunk} steps of {b} distinct windows need more than "
                         f"{len(ends)} windows")
    gen = torch.Generator(device=dev).manual_seed(inputs.sub_seed(seed, inputs.WINDOWS))
    keys = torch.rand((tr["pool_dispatches"], len(ends)), generator=gen, device=dev)
    order = torch.from_numpy(ends).to(dev)[keys.argsort(dim=1)]
    pool = order[:, single * b:(single + chunk) * b].reshape(-1, chunk, b)
    return SimpleNamespace(raw=inputs.series(cfg, rows, seed),
                           weights=inputs.weights(cfg, seed, dev), pool=pool,
                           singles=order[0, :single * b].view(single, b),
                           dropout_seed=inputs.sub_seed(seed, inputs.DROPOUT))


def setup(cell):
    from stemgnn_tpu_torch.data.pipeline import WindowDataset
    from stemgnn_tpu_torch.models.convert import unflatten_params
    from stemgnn_tpu_torch.train.engine import make_epoch_fn
    from stemgnn_tpu_torch.train.optim import make_optimizer

    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    w, h = cfg["window_size"], cfg["horizon"]
    given = given_inputs(cell)
    cell.mark("inputs made")
    raw, pool = given.raw, given.pool
    mcfg = model_config(cfg)
    data = torch.from_numpy(
        WindowDataset(raw, w, h, normalize_method=cfg["norm_method"]).data).to(dev)
    cell.mark("series normalized and on the device")
    flat = {k: v.clone().requires_grad_(True) for k, v in given.weights.items()}
    params = unflatten_params(flat)
    opt = make_optimizer(cfg["optimizer"], flat.values(), cfg["lr"])
    cell.mark("optimizer built")
    epoch_fn = make_epoch_fn(mcfg, opt, flat.values(), compute_dtype=cfg["compute_dtype"])
    dropout = torch.Generator(device=dev).manual_seed(given.dropout_seed)
    st = SimpleNamespace(cell=cell, given=given, mcfg=mcfg, data=data, flat=flat,
                         params=params, opt=opt, epoch_fn=epoch_fn, dropout=dropout,
                         pool=pool, next=0, losses=[])

    cell.mark("program built")
    losses = []
    for i in range(tr["single_steps"]):
        losses.append(st.epoch_fn(st.params, st.data, given.singles[i:i + 1], st.dropout))
        if i == 0:
            # RMSprop's state after one step is (1 - alpha) g^2 (a state the
            # optimizer never made is zero, as it starts)
            grads = {k: float(torch.sqrt(opt.state[p].get("square_avg", torch.zeros_like(p))
                                         .double() / (1 - cfg["rmsprop_alpha"])).norm())
                     for k, p in flat.items()}
    after = {k: v.detach().clone() for k, v in flat.items()}
    cell.mark(f"{tr['single_steps']} single steps")
    losses.append(dispatch(st)[:tr["followed_chunk_steps"]])
    _sync(dev)
    cell.mark("first dispatch (capture, replay)")
    st.judged = SimpleNamespace(losses=torch.cat(losses).double().cpu().numpy(),
                                grads=grads, after=after)
    for _ in range(tr["warm_dispatches"]):
        dispatch(st)
    _sync(dev)
    return st


def dispatch(st):
    """One call of the epoch function on the next window-end matrix."""
    hi = st.pool[st.next % st.pool.shape[0]]
    st.next += 1
    with torch.profiler.record_function("portbench.train.dispatch"):
        return st.epoch_fn(st.params, st.data, hi, st.dropout)


def window(st, seconds: float, profile=None):
    """Dispatch for `seconds`; with `profile` (`trace.profile`), the first
    `trace_dispatches` of them are traced. Returns the end-to-end counts."""
    dev, tr = st.cell.device, st.cell.traffic
    b = st.cell.cfg["batch_size"]
    n_trace = tr["trace_dispatches"]

    def stretch():
        for _ in range(n_trace):
            st.losses.append(dispatch(st))
        _sync(dev)

    st.stretch, st.trace = stretch, None
    in_flight = collections.deque()
    t0 = time.perf_counter()
    if profile is not None:
        st.trace = profile(stretch)
    while time.perf_counter() - t0 < seconds:
        st.losses.append(dispatch(st))
        if dev.type == "cuda":
            in_flight.append(torch.cuda.Event())
            in_flight[-1].record()
            if len(in_flight) > 2:
                in_flight.popleft().synchronize()
    _sync(dev)
    elapsed = time.perf_counter() - t0
    losses = torch.cat(st.losses)
    steps = int(losses.numel())
    return {"attempted": steps, "failed": int((~torch.isfinite(losses)).sum()),
            "seconds": elapsed, "train_windows_per_s": steps * b / elapsed}


def stretch_units(st, trace) -> None:
    """Fill in what one unit of the traced stretch is: a train step."""
    n = st.cell.traffic["trace_dispatches"] * st.cell.traffic["chunk_steps"]
    trace.units = n
    trace.batches = [st.cell.cfg["batch_size"]] * n


def step_kernels(st, kernels_of_graph):
    """The kernels of one train step, by the nodes of a CUDA graph that
    captures one (the program's `make_train_step`, as each step of a
    dispatch runs it), multiplied out to the traced stretch's steps; None
    where the graph cannot be read."""
    from collections import Counter

    from stemgnn_tpu_torch.train.engine import make_train_step

    from portbench.trace import base_name

    step = make_train_step(st.mcfg, st.opt, st.flat.values(),
                           compute_dtype=st.cell.cfg["compute_dtype"])
    b = st.cell.cfg["batch_size"]
    n = st.cell.cfg["units"]
    mask = torch.ones((b, n, n), dtype=torch.bool, device=st.data.device)
    hi = st.pool[0, 0]
    step(st.params, st.data, hi, dropout_mask=mask)
    torch.cuda.synchronize()
    names = kernels_of_graph(lambda: step(st.params, st.data, hi, dropout_mask=mask))
    if names is None:
        return None
    units = st.cell.traffic["trace_dispatches"] * st.cell.traffic["chunk_steps"]
    return Counter({k: v * units for k, v in Counter(map(base_name, names)).items()})


def free(st) -> SimpleNamespace:
    """Drop the program's state; return what the check needs."""
    kept = SimpleNamespace(given=st.given, judged=st.judged)
    st.__dict__.clear()
    return kept


def reference(cell, kept, fault=None) -> SimpleNamespace:
    """The plain reference's first steps on the inputs the program had: the
    losses of the steps the check follows, each leaf's first gradient norm
    and the parameters after the single steps. `fault`:
    `reference.stemgnn.train_steps`."""
    cfg, tr, dev, given = cell.cfg, cell.traffic, cell.device, kept.given
    data = torch.from_numpy(ref.normalize(given.raw)).to(dev)
    model = ref.StemGNN(cfg, given.weights, dev)
    opt = ref.RMSprop(model.leaves(), cfg["lr"], cfg["rmsprop_alpha"], cfg["rmsprop_eps"])
    keep = 1.0 - cfg["dropout_rate"]
    shape = (cfg["batch_size"], cfg["units"], cfg["units"])
    masks = ref.draw_masks(given.dropout_seed, shape, keep, dev)
    hi = torch.cat([given.singles, given.pool[0, :tr["followed_chunk_steps"]]])
    losses, grads, after = ref.train_steps(model, opt, data, hi, masks, fault,
                                           keep_after=tr["single_steps"])
    return SimpleNamespace(losses=losses, grads=grads, after=after)


def _gaps(p: dict, r: dict, names, floor: float = 0.0) -> dict:
    """{leaf: |p - r| / max(r, floor)} of two sides' norms (a leaf both
    sides leave at 0 reads 0)."""
    return {k: (abs(p[k] - r[k]) / max(r[k], floor) if max(r[k], floor) > 0
                else (0.0 if p[k] == 0 else float("inf"))) for k in names}


def leaf_gaps(given, judged, truth) -> dict:
    """Each leaf's gap of the first gradient's norm ("grad") and of the norm
    of its change over the single steps ("change"), against the reference's
    norm of that leaf (`own`) or of the median leaf, whichever is larger
    (`floored`); the change over the leaves that `ROUNDOFF_GRAD` keeps."""
    names = sorted(truth.after)
    change = {side: {k: float((s.after[k].double() - given.weights[k].double()).norm())
                     for k in names} for side, s in (("p", judged), ("r", truth))}
    g_med = float(np.median([truth.grads[k] for k in names]))
    moved = [k for k in names if truth.grads[k] >= ROUNDOFF_GRAD * g_med]
    c_med = float(np.median([change["r"][k] for k in moved]))
    fam = {k for leaves in FAMILIES.values() for k in leaves}
    return {"grad": {"own": _gaps(judged.grads, truth.grads, sorted(fam & set(names))),
                     "floored": _gaps(judged.grads, truth.grads, names, g_med)},
            "change": {"own": _gaps(change["p"], change["r"], [k for k in moved if k in fam]),
                       "floored": _gaps(change["p"], change["r"], moved, c_med)}}


def compare(given, judged, truth) -> dict:
    """The numbers the check compares:
    - loss_gap: the worst |loss - reference| / reference over the steps
      followed (the single steps and the first chunk's first steps);
    - grad_gap: the worst leaf's gap between the program's and the
      reference's norm of the first gradient as RMSprop got it, against the
      reference's norm of that leaf or of the median leaf, whichever is
      larger; change_gap: the same of the norm of each leaf's change over
      the single steps, leaving out leaves whose first gradient is under
      ROUNDOFF_GRAD of the median leaf's;
    - <family>_grad_gap, <family>_change_gap: the same over a family's
      leaves (FAMILIES), each against its own norm."""
    if (judged.losses.shape != truth.losses.shape or set(judged.after) != set(truth.after)
            or set(judged.grads) != set(truth.grads)):
        return {k: float("inf") for k in NUMBERS}
    loss_gap = float(np.max(np.abs(judged.losses - truth.losses) / np.abs(truth.losses)))
    gaps = leaf_gaps(given, judged, truth)
    out = {"loss_gap": loss_gap, "grad_gap": max(gaps["grad"]["floored"].values()),
           "change_gap": max(gaps["change"]["floored"].values())}
    for fam, leaves in FAMILIES.items():
        for kind in ("grad", "change"):
            own = gaps[kind]["own"]
            out[f"{fam}_{kind}_gap"] = max((own[k] for k in leaves if k in own), default=0.0)
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}


def details(given, judged, truth) -> dict:
    """Where the numbers come from (control.py --detail): each step's loss
    gap, and the leaves with the widest gaps against their own norms."""
    gaps = leaf_gaps(given, judged, truth)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:6]  # noqa: E731
    return {"loss_gap_by_step": [float(abs(a - b) / abs(b))
                                 for a, b in zip(judged.losses, truth.losses)],
            "grads": truth.grads, "grad_top": top(gaps["grad"]["own"]),
            "change_top": top(gaps["change"]["own"])}
