"""The multi-device story on the CPU: n gloo processes, one rank each, run
the sharded train steps and are held loss-equal to one process (the port's
analogue of `__graft_entry__.py` `dryrun_multichip`).

    python -m stemgnn_tpu_torch.parallel.dryrun [n]     # n = 4 by default

Meshes (n, 1), (1, n) and (2, n/2) at N = 128, multi 5, batch 8 (flagship
order of magnitude): the dense model's data-parallel chunk of two steps on
(n, 1) (a dense model on 'graph' > 1 is not ported, ROADMAP A.4), and the
stretch path with sparse_k 16 (its hidden = N GRU) and with a 32-unit GRU
over segments of 16 nodes, node-sharded on (1, n) and (2, n/2). Each run's
losses must equal the single process's within rtol 2e-4 (the JAX dryrun's
tolerance). Prints one summary line.

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


def chunk_losses(model: str, mesh_shape=None) -> np.ndarray:
    """The losses of a chunk of STEPS train steps (engine.make_epoch_fn) of
    MODELS[model] from init_params(0) on a seeded series, on the CPU; on the
    ('data', 'graph') mesh `mesh_shape` of the process group where given."""
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
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((256, N_NODES)).astype(np.float32))
    hi_matrix = torch.from_numpy(rng.integers(WINDOW, 256 - HORIZON, size=(STEPS, BATCH)))
    epoch_fn = make_epoch_fn(cfg, opt, flat.values(), mesh=mesh)
    losses = epoch_fn(unflatten_params(flat), data, hi_matrix,
                      torch.Generator().manual_seed(1))
    return losses.numpy()


def dryrun(n: int = 4) -> dict:
    """The checks of the module docstring on n ranks; returns {check: "loss_equal"}."""
    if n < 2 or n % 2:
        raise ValueError(f"the dryrun takes an even number of ranks >= 2, got {n}")
    torch.set_num_threads(1)
    runs = [("dense", (n, 1))]
    for model in ("sparse_k16", "sparse_k16_seggru"):
        runs += [(model, (1, n)), (model, (2, n // 2))]
    checks = {}
    for model, shape in runs:
        golden = chunk_losses(model)
        if not np.all(np.isfinite(golden)):
            raise FloatingPointError(f"{model}: losses {golden}")
        per_rank = run_ranks(n, chunk_losses, (model, shape), timeout=600.0)
        for rank, losses in enumerate(per_rank):
            np.testing.assert_array_equal(losses, per_rank[0], err_msg=f"rank {rank}")
        np.testing.assert_allclose(per_rank[0], golden, rtol=2e-4, atol=1e-6,
                                   err_msg=f"{model} on mesh {shape} != one process")
        checks[f"{model}_{shape[0]}x{shape[1]}"] = "loss_equal"
    return checks


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    checks = dryrun(n)
    print(f"dryrun_multichip ok: ranks={n} N={N_NODES} multi={MULTI} batch={BATCH} "
          f"checks={checks}")


if __name__ == "__main__":
    main()
