"""The multi-device story on the CPU: n gloo processes, one rank each, run
the sharded train steps and are held loss-equal to one process (the port's
analogue of `__graft_entry__.py` `dryrun_multichip`).

    python -m stemgnn_tpu_torch.parallel.dryrun [n]     # n = 4 by default
    python -m stemgnn_tpu_torch.parallel.dryrun c8      # the C.8 study below

At N = 128, multi 5, batch 8 (flagship order of magnitude), a chunk of two
steps each: the dense model on meshes (n, 1) (data parallel), (1, n) and
(2, n/2) (the node partition over 'graph', `parallel/dense_shard.py`), and on
(1, n) with `use_ring` (`parallel/ring.py`); the stretch path with
sparse_k 16 (its hidden = N GRU) and with a 32-unit GRU over segments of 16
nodes, node-sharded on (1, n) and (2, n/2). Each run's losses must equal the
single process's within rtol 2e-4, atol 1e-6 (the JAX dryrun's tolerance).
Then the JAX dryrun's other checks (`__graft_entry__.py:117-186`): the eval
program with `use_ring` on (1, n) against the dense eval of one process
(forecasts within rtol 1e-3, atol 5e-4); one train step of a 4,096-node
stretch model (multi 2, sparse_k 32, a 64-unit GRU over segments of 512,
batch 4 unsharded) on (1, n), loss within rtol 2e-4 of one process's; one
train step of the 32,768-node stretch model (multi 2, sparse_k 32, a 64-unit
GRU over segments of 1024, batch 2) on (1, n), its loss finite. Prints one
summary line.

`c8` runs synthetic-32k-sharded's train step (the bench's row: 32,768 nodes,
multi 5, batch 2, sparse_k 64, a 64-unit GRU over segments of 1024) at f32 on
a (1, 2) group and in one process, and at f64 in one process, and prints each
step's top-64 set, its loss and, for weight_query, gru/w_ih and gru/w_hh,
the largest distance of each f32 step's gradient from the f64 step's
(ROADMAP C.8).

`run_ranks` starts such a group for any picklable function, here and in the
tests.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch


def _rank_main(fn, args, rank, world, rendezvous, results, device):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)  # a CUDA rank's card
    from stemgnn_tpu_torch.parallel.mesh import init_distributed

    import torch.distributed as dist

    try:
        init_distributed(device, rendezvous, rank, world)
        try:
            results.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the group
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(world: int, fn, args=(), timeout: float = 120.0, device="cpu") -> list:
    """fn(*args) in `world` spawned processes, each rank of a process group
    (file:// rendezvous in a temporary directory, one CPU thread each): gloo
    for device "cpu", NCCL for "cuda" with rank r on card r. Returns the
    ranks' results in rank order (pickled through a queue: numpy arrays, not
    tensors, whose storage a rank that has ended would no longer share). A
    rank that raises fails the group, and a group that has not finished
    within `timeout` seconds is killed: both raise in the caller."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, rendezvous, results, device), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world and not errors:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish "
                                       f"within {timeout} s")
                try:
                    rank, status, value = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died before it could report fails the group
                    errors += [f"rank {r} exited with code {p.exitcode}"
                               for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    continue
                if status == "ok":
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------

N_NODES, WINDOW, HORIZON, MULTI, BATCH, STEPS = 128, 12, 3, 5, 8, 2
MODELS = {
    "dense": {},
    "sparse_k16": dict(sparse_k=16),
    "sparse_k16_seggru": dict(sparse_k=16, gru_hidden=32, gru_segment=16),
}
# the JAX dryrun's stretch steps: 4,096 nodes held to one process, 32,768 finite
STRETCH_STEPS = {
    "stretch_equal_4096_sparse_shard": dict(units=4096, multi_layer=2, sparse_k=32,
                                            gru_hidden=64, gru_segment=512, batch=4),
    "stretch_32k_sparse_seg_gru": dict(units=32768, multi_layer=2, sparse_k=32,
                                       gru_hidden=64, gru_segment=1024, batch=2),
}


def _series(n: int, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)), rng


def chunk_losses(model: str, mesh_shape=None, use_ring: bool = False) -> np.ndarray:
    """The losses of a chunk of STEPS train steps (engine.make_epoch_fn) of
    MODELS[model] from init_params(0) on a seeded series, on the CPU; on the
    ('data', 'graph') mesh `mesh_shape` of the process group where given
    (`use_ring`: the JAX package's ring flag, `parallel/ring.py`)."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.models.initializers import init_params
    from stemgnn_tpu_torch.parallel.mesh import make_mesh
    from stemgnn_tpu_torch.train.engine import make_epoch_fn
    from stemgnn_tpu_torch.train.optim import make_optimizer

    cfg = StemGNNConfig(units=N_NODES, window_size=WINDOW, horizon=HORIZON,
                        multi_layer=MULTI, **MODELS[model])
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_params(init_params(0, cfg, device="cpu")).items()}
    opt = make_optimizer("RMSProp", flat.values(), 1e-4)
    data, rng = _series(N_NODES, 256)
    hi_matrix = torch.from_numpy(rng.integers(WINDOW, 256 - HORIZON, size=(STEPS, BATCH)))
    epoch_fn = make_epoch_fn(cfg, opt, flat.values(), mesh=mesh, use_ring=use_ring)
    losses = epoch_fn(unflatten_params(flat), data, hi_matrix,
                      torch.Generator().manual_seed(1))
    return losses.numpy()


def eval_forecasts(mesh_shape=None, use_ring: bool = False) -> np.ndarray:
    """The dense model's eval program (engine.make_eval_epoch_fn) on the
    chunk's windows, from init_params(0), on the mesh where given."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models.initializers import init_params
    from stemgnn_tpu_torch.parallel.mesh import make_mesh
    from stemgnn_tpu_torch.train.engine import make_eval_epoch_fn

    cfg = StemGNNConfig(units=N_NODES, window_size=WINDOW, horizon=HORIZON, multi_layer=MULTI)
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    data, rng = _series(N_NODES, 256)
    hi_matrix = torch.from_numpy(rng.integers(WINDOW, 256 - HORIZON, size=(STEPS, BATCH)))
    fs, _ = make_eval_epoch_fn(cfg, "cpu", mesh=mesh, use_ring=use_ring)(
        init_params(0, cfg, device="cpu"), data, hi_matrix)
    return fs.numpy()


def stretch_step_loss(name: str, mesh_shape=None) -> float:
    """One train step's loss of STRETCH_STEPS[name] from init_params(2) (the
    JAX dryrun's key) on a seeded series, its batch unsharded; on the mesh
    where given."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.models.initializers import init_params
    from stemgnn_tpu_torch.parallel.mesh import make_mesh
    from stemgnn_tpu_torch.train.engine import make_train_step
    from stemgnn_tpu_torch.train.optim import make_optimizer

    kw = dict(STRETCH_STEPS[name])
    batch = kw.pop("batch")
    cfg = StemGNNConfig(window_size=WINDOW, horizon=HORIZON, **kw)
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    flat = {k: v.requires_grad_(True)
            for k, v in flatten_params(init_params(2, cfg, device="cpu")).items()}
    opt = make_optimizer("RMSProp", flat.values(), 1e-4)
    data, rng = _series(cfg.units, 64, 1)
    hi = torch.from_numpy(rng.integers(WINDOW, 64 - HORIZON, size=batch))
    step = make_train_step(cfg, opt, flat.values(), mesh=mesh, shard_batch=False)
    return float(step(unflatten_params(flat), data, hi, torch.Generator().manual_seed(7)))


def dryrun(n: int = 4) -> dict:
    """The checks of the module docstring on n ranks; returns {check: verdict}."""
    if n < 2 or n % 2:
        raise ValueError(f"the dryrun takes an even number of ranks >= 2, got {n}")
    torch.set_num_threads(1)
    runs = [("dense", (n, 1), False), ("dense", (1, n), False), ("dense", (2, n // 2), False),
            ("dense", (1, n), True)]
    for model in ("sparse_k16", "sparse_k16_seggru"):
        runs += [(model, (1, n), False), (model, (2, n // 2), False)]
    checks = {}
    goldens = {}
    for model, shape, ring in runs:
        if model not in goldens:
            goldens[model] = chunk_losses(model)
            if not np.all(np.isfinite(goldens[model])):
                raise FloatingPointError(f"{model}: losses {goldens[model]}")
        per_rank = run_ranks(n, chunk_losses, (model, shape, ring), timeout=600.0)
        for rank, losses in enumerate(per_rank):
            np.testing.assert_array_equal(losses, per_rank[0], err_msg=f"rank {rank}")
        np.testing.assert_allclose(per_rank[0], goldens[model], rtol=2e-4, atol=1e-6,
                                   err_msg=f"{model} on mesh {shape} (ring {ring}) != one "
                                           "process")
        if model == "dense" and shape[0] == 1 and ring:
            checks[f"ring_1x{n}"] = "loss_equal"
        elif model == "dense" and shape[0] > 1 and shape[1] == 1:
            checks[f"dense_{n}x1"] = "loss_equal"
        elif model == "dense":
            checks[f"mesh_{shape[0]}x{shape[1]}"] = "loss_equal"
        else:
            checks[f"{model}_{shape[0]}x{shape[1]}"] = "loss_equal"
    dense_eval = eval_forecasts()
    for rank, fs in enumerate(run_ranks(n, eval_forecasts, ((1, n), True), timeout=600.0)):
        np.testing.assert_allclose(fs, dense_eval, rtol=1e-3, atol=5e-4,
                                   err_msg=f"ring eval on rank {rank} != dense eval")
    checks[f"ring_eval_1x{n}"] = "forecast_equal"
    name = "stretch_equal_4096_sparse_shard"
    single = stretch_step_loss(name)
    for loss in run_ranks(n, stretch_step_loss, (name, (1, n)), timeout=600.0):
        np.testing.assert_allclose(loss, single, rtol=2e-4, err_msg=name)
    checks[name] = "loss_equal"
    name = "stretch_32k_sparse_seg_gru"
    losses = run_ranks(n, stretch_step_loss, (name, (1, n)), timeout=900.0)
    if not all(np.isfinite(loss) for loss in losses):
        raise FloatingPointError(f"{name}: losses {losses}")
    checks[name] = "finite"
    return checks


# ---------------------------------------------------------------------------
# C.8: the node-sharded 32k step's gradients upstream of the top-k
# ---------------------------------------------------------------------------

C8_LEAVES = ("weight_query", "gru/w_ih", "gru/w_hh")


def c8_step(mesh_shape=None, dtype: str = "float32", threads: int = 4) -> dict:
    """synthetic-32k-sharded's train step at `dtype` (init_params(0), a seeded
    series, the first batch's windows and [N, k] mask, as chip_smoke.py's
    phase 9 builds them), on the (1, 2) mesh where given: the top-64 index
    set, the loss (summed over the mesh) and the gradients of C8_LEAVES
    (summed over the mesh, as the engine sums them)."""
    from stemgnn_tpu_torch import bench
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.data import WindowDataset, compute_norm_stats
    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.models.convert import flatten_params, unflatten_params
    from stemgnn_tpu_torch.models.initializers import init_params
    from stemgnn_tpu_torch.parallel.mesh import all_reduce_flat, make_mesh
    from stemgnn_tpu_torch.train import engine

    torch.set_num_threads(threads)
    kw = bench.config_kwargs("synthetic-32k-sharded")
    cfg = StemGNNConfig(units=kw["n_nodes"], window_size=kw["window"], horizon=kw["horizon"],
                        multi_layer=kw["multi"], sparse_k=kw["sparse_k"],
                        gru_hidden=kw["gru_hidden"], gru_segment=kw["gru_segment"],
                        force_sparse_shard=True)
    series = np.random.default_rng(15).standard_normal(
        (kw["window"] + kw["horizon"] + kw["batch"] - 1, kw["n_nodes"]))
    data_set = WindowDataset(series, kw["window"], kw["horizon"], "z_score",
                             compute_norm_stats(series, "z_score"))
    mask = torch.from_numpy(np.random.default_rng(16).random((cfg.units, cfg.sparse_k))
                            < 1.0 - cfg.dropout_rate)
    dt = getattr(torch, dtype)
    hi = torch.from_numpy(data_set.epoch_batches(len(data_set), shuffle=False)[0]).long()
    x, y = engine.gather_windows(torch.from_numpy(data_set.data).to(dt), hi, cfg.window_size,
                                 cfg.horizon)
    flat = {k: v.to(dt).requires_grad_(True)
            for k, v in flatten_params(init_params(0, cfg, device="cpu")).items()}
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    forecast, g = stemgnn.forward(unflatten_params(flat), cfg, x, training=True,
                                  dropout_mask=mask, mesh=mesh)
    loss = (torch.mean((forecast - y) ** 2) if mesh is None
            else engine._mesh_loss(forecast, y, cfg, mesh, False))
    loss.backward()
    grads = [flat[k].grad for k in C8_LEAVES]
    loss = loss.detach().clone()
    if mesh is not None:
        all_reduce_flat(grads + [loss], mesh.graph_group)
    return {"idx": sorted(g.idx.tolist()), "loss": float(loss),
            "grads": {k: v.double().numpy() for k, v in zip(C8_LEAVES, grads)}}


def c8() -> dict:
    """The C.8 study (module docstring): prints and returns its figures."""
    threads = os.cpu_count() or 1
    t0 = time.monotonic()
    f64 = c8_step(dtype="float64", threads=threads)
    f32 = c8_step(threads=threads)
    two = run_ranks(2, c8_step, ((1, 2), "float32", max(1, threads // 2)), timeout=3000.0)
    out = {"top64_f32_equal_f64": f32["idx"] == f64["idx"],
           "top64_2rank_equal_1rank": two[0]["idx"] == f32["idx"] == two[1]["idx"],
           "loss": {"f64": f64["loss"], "f32": f32["loss"], "f32_1x2": two[0]["loss"]}}
    for k in C8_LEAVES:
        ref = f64["grads"][k]
        out[k] = {"largest_f64": float(np.abs(ref).max()),
                  "f32_1rank": float(np.abs(f32["grads"][k] - ref).max()),
                  "f32_1x2": float(np.abs(two[0]["grads"][k] - ref).max()),
                  "1x2_vs_1rank": float(np.abs(two[0]["grads"][k] - f32["grads"][k]).max()),
                  "l2_f32_1rank": float(np.linalg.norm(f32["grads"][k] - ref)),
                  "l2_f32_1x2": float(np.linalg.norm(two[0]["grads"][k] - ref))}
    out["seconds"] = round(time.monotonic() - t0, 1)
    print(f"c8: {out}")
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["c8"]:
        c8()
        return
    n = int(argv[0]) if argv else 4
    checks = dryrun(n)
    print(f"dryrun_multichip ok: ranks={n} N={N_NODES} multi={MULTI} batch={BATCH} "
          f"checks={checks}")


if __name__ == "__main__":
    main()
