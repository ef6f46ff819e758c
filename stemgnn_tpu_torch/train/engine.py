"""Training and eval engine: the reference handler's train / inference /
validate / test (models/handler.py:41-207), as stemgnn_tpu/train/engine.py
has them, with the same console lines, checkpoints, metrics.jsonl events
and CSV artifacts.

The normalized split moves to the device once as one [T, N] tensor and each
batch is gathered there from its [B] window end indices. Every batch runs
at its true size: the short last batch is not padded, because the latent
adjacency depends on batch statistics.

Training runs in chunks, as the JAX package's `lax.scan` over batches does:
an epoch's full batches are cut greedily into chunks of `CHUNK_SIZES` steps,
and `make_epoch_fn` runs a chunk as one device program. On the card that is a
CUDA graph of n train steps, captured once per chunk size and replayed; on
the CPU it is the loop of eager steps. The full batches no chunk takes and
the short last batch go through the eager `make_train_step` step. A chunk and
the same steps taken eagerly give the same bits: the dropout masks of a chunk
are drawn before it, in step order, from the generator the eager steps draw
from. Evaluation has the same shape (`make_eval_epoch_fn`).

`compute_dtype` (TrainConfig.compute_dtype, the JAX engine's `precision`)
goes into every step and eval program the `make_*` functions build, and from
them to the model's forward; `inference`, `inference_batched` and `validate`
run the eval step they are given, so it carries the policy to them.
`param_dtype` "bfloat16" casts the parameters after init (the JAX engine's
cast); a train step over bf16 parameters hands each leaf's gradient to the
optimizer in the dtype the JAX package's Pallas path gives it
(`make_train_step`).

The per-epoch shuffle comes from `np.random.default_rng([shuffle root,
epoch])` as in the JAX engine, so both engines see the same batches; the
dropout generator is re-seeded from (dropout root, epoch) at each epoch.
Neither is a carried chain, so a `--resume` run reproduces the uninterrupted
run bitwise. The loss is read back once per epoch, not per step.

On a ('data', 'graph') mesh (`build_mesh`: --data_axis x --graph_axis ranks,
`parallel/mesh.py`) every rank runs this same code on the same host data:
each batch is sharded over 'data' (a batch size 'data' does not divide stays
replicated, as the JAX engine keeps it), the nodes over 'graph' where it
divides N (`stemgnn.forward`; --use_ring takes a dense model's
partition, `parallel/ring.py`), the gradients are summed over the mesh before a
replicated optimizer step, and the eval programs gather the forecasts, so
every rank computes and prints the same metrics. Only the lead rank
(`parallel.mesh.is_lead`) writes files: norm_stat.json, checkpoints, CSVs and
metrics.jsonl.
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stemgnn_tpu_torch.config import StemGNNConfig, TrainConfig
from stemgnn_tpu_torch.data.pipeline import (
    WindowDataset,
    compute_norm_stats,
    de_normalized,
)
from stemgnn_tpu_torch.device import resolve_device
from stemgnn_tpu_torch import ops
from stemgnn_tpu_torch.metrics import evaluate
from stemgnn_tpu_torch.models import stemgnn
from stemgnn_tpu_torch.models.convert import (
    flatten_params,
    param_count,
    unflatten_params,
)
from stemgnn_tpu_torch.models.initializers import init_params, init_params_threefry
from stemgnn_tpu_torch.ops.torch_impl import operand_dtype
from stemgnn_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce_flat,
    is_lead,
    make_mesh,
)
from stemgnn_tpu_torch.train import checkpoint as ckpt
from stemgnn_tpu_torch.train.optim import decayed_lr, make_optimizer, set_lr
from stemgnn_tpu_torch.utils.logging import JsonlLogger


def gather_windows(data, hi, window_size: int, horizon: int):
    """(x [B,W,N], y [B,h,N]) from window end indices, on data's device.

    Mirrors ForecastDataset.__getitem__ (forecast_dataloader.py:56-63):
    x = data[hi-W:hi], y = data[hi:hi+horizon].
    """
    x_idx = hi[:, None] + torch.arange(-window_size, 0, device=hi.device)[None, :]
    y_idx = hi[:, None] + torch.arange(horizon, device=hi.device)[None, :]
    return data[x_idx], data[y_idx]


def build_mesh(cfg: TrainConfig):
    """The ('data', 'graph') mesh of --data_axis x --graph_axis ranks over the
    initialised process group, or None for the 1x1 default (the single-device
    path, with no collective; stemgnn_tpu/train/engine.py:46-55)."""
    if cfg.data_axis * cfg.graph_axis <= 1:
        return None
    return make_mesh(cfg.data_axis, cfg.graph_axis)


def _use_ring(cfg: TrainConfig, mesh) -> bool:
    """--use_ring takes effect only on a mesh whose 'graph' axis is > 1
    (stemgnn_tpu/train/engine.py:476)."""
    return cfg.use_ring and mesh is not None and cfg.graph_axis > 1


def _mesh_loss(forecast, y, mcfg: StemGNNConfig, mesh, batch_sharded: bool):
    """This rank's share of the step's MSE: the mean over its rows (and, where
    the forecast is its node block, its nodes) times the share of the batch's
    entries it holds, so that the shares of the ranks whose gradients are
    summed add up to the batch's MSE. Where 'graph' > 1 does not divide N,
    the ranks of a 'graph' group each compute the whole loss of their rows
    (`stemgnn.node_sharded` False), and each holds 1 / graph of it too."""
    share = mesh.graph
    if batch_sharded:
        share *= mesh.data
    if stemgnn.node_sharded(mcfg, mesh):
        y = y[:, :, mesh.node_block(mcfg.units)]
    loss = torch.mean((forecast - y) ** 2)
    return loss if share == 1 else loss * (1.0 / share)


def make_train_step(mcfg: StemGNNConfig, opt: torch.optim.Optimizer, leaves,
                    check_finite: bool = False, compute_dtype: str = "float32",
                    mesh=None, shard_batch: bool = True, use_ring: bool = False):
    """train_step(params, data, hi, dropout_generator=None, dropout_mask=None)
    -> loss (a 0-d tensor on the device, not read back). One forward, backward
    and optimizer step on the batch whose window end indices are `hi`; the
    dropout mask is `dropout_mask` (bool, of `stemgnn.dropout_shape`: [B,N,N],
    or [N,k] on the stretch path) or drawn from `dropout_generator`.

    `leaves` are the parameter tensors `opt` updates (in place). A parameter
    the loss does not reach (stack 1's backcast_short_cut) gets a zero
    gradient, as jax.grad gives it, so its optimizer state exists and the
    checkpoints line up with the JAX package's. With `check_finite` the step
    reads the loss and the gradients back and raises FloatingPointError on a
    value that is not finite, before the optimizer moves anything.
    `compute_dtype` is the forward's (`stemgnn.forward`).

    Over bf16 parameters (param_dtype "bfloat16"; `opt` from `make_optimizer`,
    a leafwise optimizer) the forward runs on f32 copies of the leaves that go
    into a kernel's autograd.Function as they are
    (`stemgnn.kernel_grad_leaf`), so their gradients stay f32 as the JAX
    package's custom_vjp return them, and on the other leaves promoted (their
    gradients bf16); `opt.step` takes that list of gradients.

    With a `mesh` the step is one rank's share of a sharded step
    (stemgnn_tpu/parallel/train.py): `hi` and the dropout mask are the whole
    batch's, the same on every rank; with `shard_batch` (and 'data' > 1) the
    rank takes its B / data rows of it, which B must allow. The loss is this
    rank's share (`_mesh_loss`); the gradients are summed over the mesh (over
    'graph' alone where the batch is replicated over 'data', whose ranks then
    compute the same), one flat buffer per dtype in leaf order
    (`parallel.mesh.all_reduce_flat`), before the replicated optimizer step;
    the returned loss is summed likewise, the batch's MSE on every rank.
    `use_ring`: the forward's (`stemgnn.forward`).
    """
    w, h = mcfg.window_size, mcfg.horizon
    leaves = list(leaves)
    mixed = any(p.dtype == torch.bfloat16 for p in leaves)
    batch_sharded = mesh is not None and shard_batch and mesh.data > 1
    grad_group = None
    if mesh is not None:
        grad_group = mesh.world_group if batch_sharded else mesh.graph_group

    def train_step(params, data, hi, dropout_generator=None, dropout_mask=None):
        if batch_sharded:
            hi = hi[mesh.batch_rows(hi.shape[0])]
        x, y = gather_windows(data, hi, w, h)
        opt.zero_grad(set_to_none=True)
        flat = flatten_params(params)
        copies = {}
        if mixed:
            copies = {k: p.detach().to(torch.float32).requires_grad_(True)
                      for k, p in flat.items() if stemgnn.kernel_grad_leaf(k, mcfg)}
            params = unflatten_params({k: copies.get(k, p) for k, p in flat.items()})
        forecast, _ = stemgnn.forward(
            params, mcfg, x, training=True, dropout_generator=dropout_generator,
            dropout_mask=dropout_mask, compute_dtype=compute_dtype, mesh=mesh,
            batch_sharded=batch_sharded, use_ring=use_ring)
        if mesh is None:
            loss = torch.mean((forecast - y) ** 2)  # nn.MSELoss (handler.py:140)
        else:
            loss = _mesh_loss(forecast, y, mcfg, mesh, batch_sharded)
        loss.backward()
        # each leaf's gradient: its f32 copy's where it has one, else its own;
        # zeros where the loss does not reach it
        grads = {}
        for k, p in flat.items():
            src = copies.get(k, p)
            if src.grad is None:
                src.grad = torch.zeros_like(src)
            grads[k] = src.grad
        loss = loss.detach()
        if mesh is not None:
            loss = loss.clone()
            all_reduce_flat(list(grads.values()) + [loss], grad_group)
        if check_finite:
            bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
            if bad or not torch.isfinite(loss):
                raise FloatingPointError(
                    f"loss {loss.item()}; gradients that are not finite: {bad}")
        if mixed:
            by_leaf = {id(p): grads[k] for k, p in flat.items()}
            opt.step([by_leaf[id(p)] for p in leaves])
        else:
            opt.step()
        return loss

    return train_step


# Steps per chunk, tried largest first. On the card each size is one captured
# CUDA graph, so an epoch of b batches costs a handful of replays.
CHUNK_SIZES = (64, 16, 4)
# eager steps on a side stream before the first capture: library handles,
# workspaces, cached constants and the optimizer's state all come to exist
WARM_STEPS = 3


def _static_inputs(data, n: int, batch: int, first_hi: int):
    """Buffers a captured graph reads, at fixed addresses: a copy of `data`
    and [n, batch] window end indices (all valid, for the warm-up)."""
    return SimpleNamespace(
        data=data.clone(),
        hi=torch.full((n, batch), first_hi, dtype=torch.int64, device=data.device))


def _warm(fn) -> None:
    """Run fn on a side stream, as a capture needs before it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


def fill_masks(masks, mcfg: StemGNNConfig, batch: int, mesh, batch_sharded: bool,
               dropout_generator=None, dropout_masks=None) -> None:
    """Write the rank's part (`stemgnn.mask_rows`) of each of n steps' dropout
    masks into masks [n, ...]: of `dropout_masks` (the n steps' whole masks),
    or of one draw of `stemgnn.dropout_shape` a step from
    `dropout_generator`, which is what the eager steps draw. Where the
    forward is node-sharded the rank so holds [n, B, N / graph, N] (over
    'data' also B / data rows), not every step's whole [B, N, N]."""
    if dropout_masks is not None:
        masks.copy_(stemgnn.mask_rows(mcfg, dropout_masks, mesh, batch_sharded))
        return
    keep = 1.0 - mcfg.dropout_rate
    for i in range(masks.shape[0]):
        whole = stemgnn.draw_dropout_mask(stemgnn.dropout_shape(mcfg, batch), keep,
                                          dropout_generator)
        masks[i] = stemgnn.mask_rows(mcfg, whole, mesh, batch_sharded)


def make_epoch_fn(mcfg: StemGNNConfig, opt: torch.optim.Optimizer, leaves,
                  compute_dtype: str = "float32", mesh=None, shard_batch: bool = True,
                  use_ring: bool = False):
    """epoch_fn(params, data, hi_matrix [n, B], dropout_generator=None,
    dropout_masks=None) -> losses [n]: n train steps as one device program
    (stemgnn_tpu/train/engine.py `make_epoch_fn`). The steps' dropout masks are
    `dropout_masks` ([n, B, N, N] bool; [n, N, k] on the stretch path) or
    drawn from `dropout_generator`.

    `params` must be the tree of `leaves`, the tensors `opt` updates in place.
    On CPU tensors the program is the loop of eager steps. On the card it is a
    CUDA graph of the n steps, captured at the first call with that n (and
    batch and data shape) and replayed from then on; `data`, `hi_matrix`, the
    n dropout masks and the losses live in static buffers that a call copies
    into and out of. The masks are drawn before the replay, one draw of
    `stemgnn.dropout_shape` per step from `dropout_generator`, which is what
    the eager steps draw: a chunk and the same steps taken eagerly give the
    same bits; the static buffer holds only the rank's part of them
    (`fill_masks`). The first capture is preceded by `WARM_STEPS` eager steps
    whose effect on the parameters and the optimizer state is undone.
    `compute_dtype`, `mesh`, `shard_batch` and `use_ring` are the steps'
    (`make_train_step`).
    On a mesh of cards the capture records each step's collectives (NCCL
    supports capture) with its kernels, by design: a chunk stays one replay a
    dispatch, and the warm-up steps have made the communicators before it.
    """
    leaves = list(leaves)
    train_step = make_train_step(mcfg, opt, leaves, compute_dtype=compute_dtype,
                                 mesh=mesh, shard_batch=shard_batch, use_ring=use_ring)
    w = mcfg.window_size
    dropout = mcfg.dropout_rate > 0.0
    batch_sharded = mesh is not None and shard_batch and mesh.data > 1
    graphs = {}

    def check_params(params):
        mine = list(flatten_params(params).values())
        if len(mine) != len(leaves) or any(a is not b for a, b in zip(mine, leaves)):
            raise ValueError("epoch_fn: params are not the tensors the optimizer updates")

    def eager(params, data, hi_matrix, dropout_generator, dropout_masks):
        return torch.stack([
            train_step(params, data, hi, dropout_generator,
                       None if dropout_masks is None else dropout_masks[i])
            for i, hi in enumerate(hi_matrix)])

    def warm_up(params, st):
        """WARM_STEPS eager steps, then parameters and optimizer state put back
        (state that the steps created is zeroed, which is how it starts)."""
        held = [p.detach().clone() for p in leaves]
        held_state = {p: {k: v.clone() for k, v in opt.state[p].items()}
                      for p in leaves if p in opt.state}
        mask = st.masks[0] if dropout else None
        _warm(lambda: [train_step(params, st.data, st.hi[0], dropout_mask=mask)
                       for _ in range(WARM_STEPS)])
        with torch.no_grad():
            for p, old in zip(leaves, held):
                p.copy_(old)
                for k, v in opt.state[p].items():
                    if p in held_state:
                        v.copy_(held_state[p][k])
                    else:
                        v.zero_()

    def capture(params, data, n, batch):
        st = _static_inputs(data, n, batch, w)
        st.masks = None
        if dropout:  # the rank's rows of the n steps' masks (`stemgnn.mask_rows`)
            whole = torch.empty((n, *stemgnn.dropout_shape(mcfg, batch)), device="meta")
            st.masks = torch.ones(stemgnn.mask_rows(mcfg, whole, mesh, batch_sharded).shape,
                                  dtype=torch.bool, device=data.device)
        st.losses = torch.zeros(n, dtype=data.dtype, device=data.device)
        if not graphs:
            warm_up(params, st)
        st.graph = torch.cuda.CUDAGraph()
        # thread_local: a checkpoint worker may be copying on its own stream
        with ops.counting_capture() as st.per_replay, torch.cuda.graph(
                st.graph, capture_error_mode="thread_local"):
            for i in range(n):
                st.losses[i] = train_step(
                    params, st.data, st.hi[i],
                    dropout_mask=st.masks[i] if dropout else None)
        return st

    def graphed(params, data, hi_matrix, dropout_generator, dropout_masks):
        n, batch = hi_matrix.shape
        key = (n, batch, tuple(data.shape))
        if key not in graphs:
            graphs[key] = capture(params, data, n, batch)
        st = graphs[key]
        st.data.copy_(data)
        st.hi.copy_(hi_matrix)
        if dropout:
            fill_masks(st.masks, mcfg, batch, mesh, batch_sharded, dropout_generator,
                       dropout_masks)
        st.graph.replay()
        ops.add_replayed(st.per_replay)
        return st.losses.clone()

    def epoch_fn(params, data, hi_matrix, dropout_generator=None, dropout_masks=None):
        check_params(params)
        if dropout and dropout_generator is None and dropout_masks is None:
            raise ValueError("training with dropout needs dropout_generator or "
                             "dropout_masks")
        fn = graphed if data.device.type == "cuda" else eager
        return fn(params, data, hi_matrix, dropout_generator, dropout_masks)

    return epoch_fn


def epoch_generator_seed(root: int, epoch: int) -> int:
    """Seed of the dropout generator for `epoch`, a function of (root, epoch)
    alone."""
    return int(np.random.SeedSequence([root, epoch]).generate_state(1, np.uint64)[0]
               & np.uint64(2**63 - 1))


def _forecast(params, mcfg: StemGNNConfig, x, compute_dtype: str, mesh,
              batch_sharded: bool, use_ring: bool = False):
    """The eval forward; on a mesh the rank's forecast block gathered over
    'graph' (where node-sharded) and 'data' (with `batch_sharded`, x this
    rank's rows), so that every rank holds the whole [B, horizon, N]."""
    forecast, _ = stemgnn.forward(params, mcfg, x, training=False,
                                  compute_dtype=compute_dtype, mesh=mesh,
                                  batch_sharded=batch_sharded, use_ring=use_ring)
    if stemgnn.node_sharded(mcfg, mesh):
        forecast = all_gather_cat(forecast, mesh.graph_group, dim=2)
    if batch_sharded:
        forecast = all_gather_cat(forecast, mesh.data_group, dim=0)
    return forecast


def make_eval_step(mcfg: StemGNNConfig, device="cuda", compute_dtype: str = "float32",
                   mesh=None, use_ring: bool = False):
    """eval_step(params, x) -> forecast [B, horizon, N] on `device`, the forward
    at `compute_dtype`. On a `mesh` the batch stays whole on every rank (the
    step serves batches of any size) and a node-sharded forecast is gathered;
    `use_ring` validates through the attention path a --use_ring run trains
    with (stemgnn_tpu/train/engine.py `make_eval_step`).

    x may be a numpy array or a tensor; it is moved to `device`."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(params, x):
        x = torch.as_tensor(x, device=dev)
        return _forecast(params, mcfg, x, compute_dtype, mesh, False, use_ring)

    return eval_step


def make_eval_epoch_fn(mcfg: StemGNNConfig, device="cuda",
                       compute_dtype: str = "float32", mesh=None, shard_batch: bool = True,
                       use_ring: bool = False):
    """eval_epoch(params, data, hi_matrix [n, B]) -> (forecasts [n, B, horizon,
    N], targets like them): n eval batches as one device program
    (stemgnn_tpu/train/engine.py `make_eval_epoch_fn`).

    On the CPU the loop of eager forwards; on the card a CUDA graph of the n
    forwards, captured at the first call with that n, batch, data shape and
    parameter tensors and replayed from then on, with `data` and `hi_matrix`
    copied into static buffers. The forwards run at `compute_dtype`. On a
    `mesh` each batch is sharded over 'data' with `shard_batch` (and 'data' >
    1) and every forecast gathered (`_forecast`, with `use_ring`); a capture
    records the collectives, as `make_epoch_fn`'s does."""
    dev = resolve_device(device)
    w, h = mcfg.window_size, mcfg.horizon
    batch_sharded = mesh is not None and shard_batch and mesh.data > 1
    graphs = {}

    def run(params, data, hi_matrix):
        fs, ys = [], []
        for hi in hi_matrix:
            x, y = gather_windows(data, hi, w, h)
            if batch_sharded:
                x = x[mesh.batch_rows(hi.shape[0])]
            with torch.inference_mode():
                fs.append(_forecast(params, mcfg, x, compute_dtype, mesh, batch_sharded,
                                    use_ring))
            ys.append(y)
        return torch.stack(fs), torch.stack(ys)

    def graphed(params, data, hi_matrix):
        n, batch = hi_matrix.shape
        # a graph reads the parameters where they lay at its capture
        key = (n, batch, tuple(data.shape),
               tuple(p.data_ptr() for p in flatten_params(params).values()))
        if key not in graphs:
            st = _static_inputs(data, n, batch, w)
            _warm(lambda: run(params, st.data, st.hi[:1]))
            st.graph = torch.cuda.CUDAGraph()
            with ops.counting_capture() as st.per_replay, torch.cuda.graph(
                    st.graph, capture_error_mode="thread_local"):
                st.out = run(params, st.data, st.hi)
            graphs[key] = st
        st = graphs[key]
        st.data.copy_(data)
        st.hi.copy_(hi_matrix)
        st.graph.replay()
        ops.add_replayed(st.per_replay)
        return st.out[0].clone(), st.out[1].clone()

    return graphed if dev.type == "cuda" else run


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
    eval_epoch_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device-side eval: one pass over the batches with the split on the
    device, forecasts and targets copied back once. Valid whenever the
    model emits the full horizon per call (stemgnn.forward always does).
    With `eval_epoch_fn` (`make_eval_epoch_fn`) the full batches run as one
    device program; the short last batch is its own call either way."""
    dev = resolve_device(device)
    data = torch.from_numpy(dataset.data).to(dev)
    batches = dataset.epoch_batches(batch_size, shuffle=False)
    fcs, tgs = [], []
    n_full = len(batches) - (1 if len(batches[-1]) < batch_size else 0)
    if eval_epoch_fn is not None and n_full:
        hi_matrix = torch.from_numpy(np.stack(batches[:n_full]).astype(np.int64)).to(dev)
        fs, ys = eval_epoch_fn(params, data, hi_matrix)
        fcs.append(fs.flatten(0, 1))
        tgs.append(ys.flatten(0, 1))
        batches = batches[n_full:]
    for hi_batch in batches:
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
    eval_epoch_fn=None,
) -> Dict:
    """handler.py:67-100: metrics on de-normalized forecasts + CSV artifacts.

    With `device` the batches are gathered on that device
    (`inference_batched`, the full batches through `eval_epoch_fn` if given);
    without it the host splice loop runs (`inference`)."""
    if device is not None:
        forecast_norm, target_norm = inference_batched(
            eval_step, params, dataset, batch_size, device, eval_epoch_fn)
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


def initial_params(cfg: TrainConfig, mcfg: StemGNNConfig, device) -> Dict:
    """The flattened parameters a run starts from, leaves that require a
    gradient: the draw of cfg.init_stream, `init_params(cfg.seed)` ("torch")
    or `init_params_threefry(cfg.seed)` ("threefry",
    stemgnn_tpu/train/engine.py:444-455), cast to cfg.param_dtype, as the
    JAX engine casts after init (to nearest, ties to even)."""
    if cfg.init_stream == "torch":
        tree = init_params(cfg.seed, mcfg, device=device)
    elif cfg.init_stream == "threefry":
        tree = init_params_threefry(cfg.seed, mcfg, device=device)
    else:
        raise ValueError(
            f"init_stream must be 'torch' or 'threefry', got {cfg.init_stream!r}")
    dtype = operand_dtype(cfg.param_dtype)
    return {k: v.to(dtype).requires_grad_(True) for k, v in flatten_params(tree).items()}


def train(
    train_data: np.ndarray,
    valid_data: np.ndarray,
    cfg: TrainConfig,
    result_file: str,
) -> Tuple[Dict, Optional[Dict]]:
    """handler.py:103-191 on cfg.device. Returns (the last validation's
    metrics, the train split's norm stats). With --data_axis x --graph_axis
    > 1, every rank of the initialised process group calls it (module
    docstring)."""
    device = resolve_device(cfg.device)
    node_cnt = train_data.shape[1]
    mcfg = cfg.model_config(node_cnt)
    if len(train_data) == 0:
        raise Exception("Cannot organize enough training data")
    if len(valid_data) == 0:
        raise Exception("Cannot organize enough validation data")

    # only the lead rank writes files; console lines stay on every rank
    lead = is_lead()
    normalize_statistic = compute_norm_stats(train_data, cfg.norm_method)
    if normalize_statistic is not None and lead:
        ckpt.save_norm_stat(result_file, normalize_statistic)

    flat = initial_params(cfg, mcfg, device)
    opt = make_optimizer(cfg.optimizer, flat.values(), cfg.lr)

    train_set = WindowDataset(
        train_data, cfg.window_size, cfg.horizon, cfg.norm_method, normalize_statistic
    )
    valid_set = WindowDataset(
        valid_data, cfg.window_size, cfg.horizon, cfg.norm_method, normalize_statistic
    )
    if len(train_set) == 0:
        raise Exception("Cannot organize enough training data")

    print(f"Total Trainable Params: {param_count(flat)}")

    mesh = build_mesh(cfg)
    use_ring = _use_ring(cfg, mesh)
    # batches can only be sharded over 'data' if their size divides evenly
    shard_batch = mesh is not None and cfg.batch_size % cfg.data_axis == 0
    if mesh is not None:
        print(f"mesh: data={cfg.data_axis} graph={cfg.graph_axis} "
              f"devices={mesh.size} batch_sharded={shard_batch} ring={use_ring}")
        if not shard_batch:
            print(f"WARNING: batch_size {cfg.batch_size} not divisible by "
                  f"data_axis {cfg.data_axis}; batches stay replicated "
                  f"(node-block graph partition still active)")

    logger = JsonlLogger(
        os.path.join(result_file, "metrics.jsonl") if cfg.log_jsonl and lead else None
    )

    start_epoch = 0
    best_validate_mae = np.inf
    validate_score_non_decrease_count = 0
    if cfg.resume:
        last = ckpt.latest_epoch(result_file)
        if last is not None:
            restored = ckpt.load(result_file, epoch=last, device=device)
            if restored is not None:
                loaded, opt_state, meta = restored
                with torch.no_grad():
                    for k, v in flatten_params(loaded).items():
                        flat[k].copy_(v)
                if opt_state is not None:
                    # the moments and step counts; the param groups stay this
                    # optimizer's own (its learning rate may be a tensor on
                    # the card, and the engine sets it every epoch)
                    opt.load_state_dict({
                        "state": opt_state["state"],
                        "param_groups": opt.state_dict()["param_groups"]})
                start_epoch = meta.get("epoch", last) + 1
                best_validate_mae = meta.get("best_validate_mae", np.inf)
                validate_score_non_decrease_count = meta.get("non_decrease_count", 0)
                print(f"Resumed from epoch {last}")

    saver = ckpt.AsyncCheckpointer() if cfg.ckpt_async and lead else None
    try:
        with torch.autograd.set_detect_anomaly(cfg.debug_nans):
            performance_metrics = _train_epochs(
                cfg, mcfg, flat, opt, device, train_set, valid_set,
                normalize_statistic, node_cnt, result_file, logger, start_epoch,
                best_validate_mae, validate_score_non_decrease_count, saver,
                mesh, shard_batch, lead, use_ring,
            )
    finally:
        if saver is not None:
            # every queued checkpoint on disk before returning; a failed
            # write must not hide an exception of the training itself
            training_exc = sys.exc_info()[1]
            try:
                saver.close()
            except Exception as ckpt_err:
                if training_exc is None:
                    raise
                print(f"WARNING: an asynchronous checkpoint write also failed "
                      f"during shutdown: {ckpt_err!r}")
    if mesh is not None:
        # the lead's checkpoints are on disk before any rank goes on to read them
        dist.barrier()
    return performance_metrics, normalize_statistic


def _train_epochs(
    cfg, mcfg, flat, opt, device, train_set, valid_set, normalize_statistic,
    node_cnt, result_file, logger, start_epoch, best_validate_mae,
    validate_score_non_decrease_count, saver=None, mesh=None, shard_batch=False,
    lead=True, use_ring=False,
) -> Dict:
    params = unflatten_params(flat)
    # debug_nans: every batch is an eager step that checks its loss and gradients
    train_step = make_train_step(mcfg, opt, flat.values(), check_finite=cfg.debug_nans,
                                 compute_dtype=cfg.compute_dtype, mesh=mesh,
                                 shard_batch=shard_batch, use_ring=use_ring)
    # the short last batch, of any size, stays replicated over 'data'
    train_step_tail = train_step
    if shard_batch:
        train_step_tail = make_train_step(mcfg, opt, flat.values(),
                                          check_finite=cfg.debug_nans,
                                          compute_dtype=cfg.compute_dtype, mesh=mesh,
                                          shard_batch=False, use_ring=use_ring)
    epoch_fn = make_epoch_fn(mcfg, opt, flat.values(), cfg.compute_dtype, mesh, shard_batch,
                             use_ring)
    chunk_sizes = () if cfg.debug_nans else CHUNK_SIZES
    eval_step = make_eval_step(mcfg, device, cfg.compute_dtype, mesh=mesh, use_ring=use_ring)
    eval_epoch_fn = make_eval_epoch_fn(mcfg, device, cfg.compute_dtype, mesh=mesh,
                                       shard_batch=shard_batch, use_ring=use_ring)
    data_dev = torch.from_numpy(train_set.data).to(device)
    n_windows = len(train_set)
    dropout_root = cfg.dropout_seed if cfg.dropout_seed >= 0 else cfg.seed
    shuffle_root = cfg.shuffle_seed if cfg.shuffle_seed >= 0 else cfg.seed
    generator = torch.Generator(device=device)

    def save_ckpt(epoch_arg, meta):
        if not lead:
            return
        # the asynchronous saver clones the state on the device before the
        # next step changes it in place
        save = saver.submit if saver is not None else ckpt.save
        save(result_file, params, opt.state_dict(), epoch=epoch_arg, meta=meta)

    performance_metrics: Dict = {}
    for epoch in range(start_epoch, cfg.epoch):
        lr = decayed_lr(cfg.lr, epoch, cfg.exponential_decay_step, cfg.decay_rate)
        set_lr(opt, lr)
        # trace the second epoch of this run (the first pays for the captures)
        # into <result_file>/profile
        prof = None
        if cfg.profile and result_file and lead and epoch == start_epoch + 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        epoch_start_time = time.time()
        # shuffle and dropout streams are functions of (root, epoch), not
        # carried chains: a --resume run at epoch k sees the uninterrupted
        # run's batches and masks
        batches = train_set.epoch_batches(
            cfg.batch_size, shuffle=True,
            rng=np.random.default_rng([shuffle_root, epoch]),
        )
        cnt = len(batches)
        n_full = cnt - (1 if len(batches[-1]) < cfg.batch_size else 0)
        generator.manual_seed(epoch_generator_seed(dropout_root, epoch))
        sizes = [len(b) for b in batches]
        hi_all = torch.from_numpy(np.concatenate(batches).astype(np.int64)).to(device)
        hi_full = hi_all[: n_full * cfg.batch_size].view(n_full, cfg.batch_size)
        losses = []
        lo = 0
        for size in chunk_sizes:  # greedy, largest chunk first
            while n_full - lo >= size:
                losses.append(epoch_fn(params, data_dev, hi_full[lo : lo + size],
                                       generator))
                lo += size
        # the full batches no chunk took, and the short last batch
        for hi in torch.split(hi_all, sizes)[lo:]:
            step = train_step if len(hi) == cfg.batch_size else train_step_tail
            losses.append(step(params, data_dev, hi, generator)[None])
        loss_total = float(torch.cat(losses).sum())  # one sync per epoch
        epoch_time = time.time() - epoch_start_time
        if prof is not None:
            prof.stop()
            profile_dir = os.path.join(result_file, "profile")
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"epoch_{epoch}.json"))
            print(f"profile trace written to {profile_dir}")
        print(
            "| end of epoch {:3d} | time: {:5.2f}s | train_total_loss {:5.4f}".format(
                epoch, epoch_time, loss_total / cnt
            )
        )
        meta = {
            "epoch": epoch,
            "best_validate_mae": float(best_validate_mae),
            "non_decrease_count": validate_score_non_decrease_count,
            "rng_seed": cfg.seed,
        }
        # per-epoch checkpoint (handler.py:169), at the configured cadence
        if (epoch + 1) % cfg.ckpt_every == 0 or epoch == cfg.epoch - 1:
            save_ckpt(epoch, meta)
        logger.log(
            {
                "event": "epoch",
                "epoch": epoch,
                "loss": loss_total / cnt,
                "lr": lr,
                "epoch_time_s": epoch_time,
                "windows_per_s": n_windows / epoch_time,
            }
        )
        if (epoch + 1) % cfg.validate_freq == 0:
            is_best_for_now = False
            print("------ validate on data: VALIDATE ------")
            performance_metrics = validate(
                eval_step,
                params,
                valid_set,
                cfg.norm_method,
                normalize_statistic,
                node_cnt,
                cfg.window_size,
                cfg.horizon,
                cfg.batch_size,
                result_file=result_file if lead else None,
                device=device,
                eval_epoch_fn=eval_epoch_fn,
            )
            if best_validate_mae > performance_metrics["mae"]:
                best_validate_mae = performance_metrics["mae"]
                is_best_for_now = True
                validate_score_non_decrease_count = 0
            else:
                validate_score_non_decrease_count += 1
            if is_best_for_now:
                save_ckpt(None, meta)
            logger.log({"event": "validate", "epoch": epoch, **{
                k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
                for k, v in performance_metrics.items()
            }})
        if cfg.early_stop and validate_score_non_decrease_count >= cfg.early_stop_step:
            # backstop: with ckpt_every > 1 this epoch may not have been
            # checkpointed yet; write it so --resume sees the final state
            if (epoch + 1) % cfg.ckpt_every != 0 and epoch != cfg.epoch - 1:
                save_ckpt(epoch, meta)
            break
    return performance_metrics


def test(
    test_data: np.ndarray,
    cfg: TrainConfig,
    result_train_file: str,
    result_test_file: str,
) -> Dict:
    """handler.py:194-207: restore the best checkpoint onto cfg.device and
    evaluate the test split with the TRAIN-split norm stats (on a mesh, as
    `train` evaluates; the lead rank writes the CSVs)."""
    device = resolve_device(cfg.device)
    normalize_statistic = ckpt.load_norm_stat(result_train_file)
    node_cnt = test_data.shape[1]
    mcfg = cfg.model_config(node_cnt)
    restored = ckpt.load(result_train_file, device=device)
    if restored is None:
        raise FileNotFoundError(f"no best checkpoint in {result_train_file}")
    params, _, _ = restored
    test_set = WindowDataset(
        test_data, cfg.window_size, cfg.horizon, cfg.norm_method, normalize_statistic
    )
    mesh = build_mesh(cfg)
    use_ring = _use_ring(cfg, mesh)
    shard_batch = mesh is not None and cfg.batch_size % cfg.data_axis == 0
    performance_metrics = validate(
        make_eval_step(mcfg, device, cfg.compute_dtype, mesh=mesh, use_ring=use_ring),
        params,
        test_set,
        cfg.norm_method,
        normalize_statistic,
        node_cnt,
        cfg.window_size,
        cfg.horizon,
        cfg.batch_size,
        result_file=result_test_file if is_lead() else None,
        device=device,
        eval_epoch_fn=make_eval_epoch_fn(mcfg, device, cfg.compute_dtype, mesh=mesh,
                                         shard_batch=shard_batch, use_ring=use_ring),
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
