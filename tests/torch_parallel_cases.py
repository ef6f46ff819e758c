"""What each rank computes in tests/test_torch_port_parallel.py: functions
that `stemgnn_tpu_torch.parallel.dryrun.run_ranks` runs in spawned gloo
processes. Port only: this module imports neither jax nor stemgnn_tpu, so a
rank starts in a few seconds. Inputs come from the test as numpy arrays, and
the results go back as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy().copy()


def _mesh(shape):
    from stemgnn_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(*shape)


def bundle(calls):
    """[the result of each (name of a function here, args) of `calls`]: one
    group runs several cases."""
    return [globals()[name](*args) for name, args in calls]


def mesh_places():
    """The messages of make_mesh on a world too small and too large for the
    mesh, and this rank's place on a (2, 1) and a (1, 2) mesh: (data index,
    graph index) of each, its rows of a batch of 16 and its block of 16 nodes."""
    errors = []
    for shape in ((2, 2), (1, 1)):
        try:
            _mesh(shape)
        except ValueError as e:
            errors.append(str(e))
    dp, gp = _mesh((2, 1)), _mesh((1, 2))
    rows, block = dp.batch_rows(16), gp.node_block(16)
    return errors, (dp.data_index, dp.graph_index, gp.data_index, gp.graph_index,
                    (rows.start, rows.stop), (block.start, block.stop))


def sharded_graph(mesh_shape, key, query, alpha, k, mask=None, rate=0.0):
    """This rank's sharded graph of the [N] key and query: idx and its row
    blocks of c, degree and inv_sqrt (with the global [N, k] `mask`)."""
    from stemgnn_tpu_torch.parallel import sparse_shard

    mesh = _mesh(mesh_shape)
    blk = mesh.node_block(len(query))
    g = sparse_shard.build_sharded_graph(
        mesh, _t(key)[blk], _t(query)[blk], alpha, k,
        dropout_mask=None if mask is None else _t(mask), dropout_rate=rate)
    return {"idx": _np(g.idx), "c": _np(g.c), "degree": _np(g.degree),
            "inv_sqrt": _np(g.inv_sqrt)}


def sharded_cheb(mesh_shape, key, query, x, gout, alpha, k):
    """sum(sharded_sparse_cheb_conv(build_sharded_graph(key, query), x) * gout)
    on this rank's blocks: the output block and the gradients of the key,
    query and x blocks."""
    from stemgnn_tpu_torch.parallel import sparse_shard

    mesh = _mesh(mesh_shape)
    blk = mesh.node_block(len(query))
    kb, qb = _t(key)[blk].requires_grad_(True), _t(query)[blk].requires_grad_(True)
    xb = _t(x)[:, blk].requires_grad_(True)
    g = sparse_shard.build_sharded_graph(mesh, kb, qb, alpha, k)
    out = sparse_shard.sharded_sparse_cheb_conv(mesh, g, xb)
    torch.sum(out * _t(gout)[:, :, blk]).backward()
    return {"out": _np(out), "key": _np(kb.grad), "query": _np(qb.grad), "x": _np(xb.grad)}


def train_step(mesh_shape, cfg_kw, flat_params, data, hi, mask, shard_batch=True,
               lr=1e-3, use_ring=False, rank_mask=False):
    """One RMSProp step of `engine.make_train_step` on the mesh (None: one
    process, no process group; `use_ring`: the JAX package's ring flag;
    `rank_mask`: the step handed only the rank's part of the whole mask,
    `stemgnn.mask_rows`, as the engine's chunk hands it): the loss, every
    gradient (after the sum over the mesh) and every parameter after the
    step, flat by name."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.models.convert import unflatten_params
    from stemgnn_tpu_torch.parallel.train import make_sharded_train_step
    from stemgnn_tpu_torch.train import engine
    from stemgnn_tpu_torch.train.optim import make_optimizer

    cfg = StemGNNConfig(**cfg_kw)
    flat = {k: _t(v).requires_grad_(True) for k, v in flat_params.items()}
    opt = make_optimizer("RMSProp", flat.values(), lr)
    if mesh_shape is None:
        step = engine.make_train_step(cfg, opt, flat.values())
    else:
        mesh = _mesh(mesh_shape)
        step = make_sharded_train_step(cfg, opt, flat.values(), mesh,
                                       shard_batch=shard_batch, use_ring=use_ring)
    mask = _t(mask)
    if rank_mask:
        mask = stemgnn.mask_rows(cfg, mask, mesh, shard_batch and mesh.data > 1).clone()
    loss = step(unflatten_params(flat), _t(data), _t(hi), dropout_mask=mask)
    return {"loss": float(loss), "grads": {k: _np(v.grad) for k, v in flat.items()},
            "params": {k: _np(v) for k, v in flat.items()}}


def eval_forecasts(mesh_shape, cfg_kw, flat_params, data, hi_matrix, use_ring=False):
    """The engine's eval step on the first batch of `hi_matrix` and its eval
    program on all of them (each batch sharded over 'data'); `use_ring`: the
    JAX package's ring flag."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models.convert import unflatten_params
    from stemgnn_tpu_torch.train import engine

    cfg = StemGNNConfig(**cfg_kw)
    mesh = None if mesh_shape is None else _mesh(mesh_shape)
    params = unflatten_params({k: _t(v) for k, v in flat_params.items()})
    data, hi_matrix = _t(data), _t(hi_matrix)
    x, _ = engine.gather_windows(data, hi_matrix[0], cfg.window_size, cfg.horizon)
    step = engine.make_eval_step(cfg, "cpu", mesh=mesh, use_ring=use_ring)(params, x)
    fs, _ = engine.make_eval_epoch_fn(cfg, "cpu", mesh=mesh, use_ring=use_ring)(
        params, data, hi_matrix)
    return {"step": _np(step), "epoch": _np(fs)}


def forced_shard_spy(cfg_kw, flat_params, x):
    """The eval forward on a (1, 1) mesh with force_sparse_shard, counting the
    calls of the sharded graph build and conv, and the forward without a mesh."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.models.convert import unflatten_params

    cfg = StemGNNConfig(**cfg_kw)
    params = unflatten_params({k: _t(v) for k, v in flat_params.items()})
    calls = {"build": 0, "conv": 0}
    build, conv = stemgnn.build_sharded_graph, stemgnn.sharded_sparse_cheb_conv

    def spy_build(*a, **kw):
        calls["build"] += 1
        return build(*a, **kw)

    def spy_conv(*a, **kw):
        calls["conv"] += 1
        return conv(*a, **kw)

    stemgnn.build_sharded_graph, stemgnn.sharded_sparse_cheb_conv = spy_build, spy_conv
    try:
        with torch.inference_mode():
            ref, _ = stemgnn.forward(params, cfg, _t(x))
            unsharded_calls = dict(calls)
            got, _ = stemgnn.forward(params, cfg, _t(x), mesh=_mesh((1, 1)))
    finally:
        stemgnn.build_sharded_graph, stemgnn.sharded_sparse_cheb_conv = build, conv
    return {"unsharded_calls": unsharded_calls, "calls": calls, "ref": _np(ref),
            "got": _np(got)}


def engine_train(tcfg_kw, train, valid, out_dir):
    """engine.train on the CPU into `out_dir`/rank<r> (the mesh of tcfg_kw's
    data_axis x graph_axis over the process group): the last validation's
    MAE, RMSE and MAPE, and the files each rank wrote."""
    import os

    import torch.distributed as dist

    from stemgnn_tpu_torch.config import TrainConfig
    from stemgnn_tpu_torch.train import engine

    rank = dist.get_rank() if dist.is_initialized() else 0
    result = os.path.join(out_dir, f"rank{rank}")
    metrics, _ = engine.train(train, valid, TrainConfig(**tcfg_kw), result)
    files = sorted(os.path.relpath(os.path.join(d, f), result)
                   for d, _, fs in os.walk(result) for f in fs)
    return {"mae": metrics["mae"], "rmse": metrics["rmse"], "mape": metrics["mape"],
            "files": files}


def ring_rows(mesh_shape, enc, wk, wq, gout, alpha):
    """This rank's rows of `parallel.ring.ring_attention` on the [B, N, N]
    encoding, and the gradients of sum(rows * gout's rows) with respect to
    the encoding and both weights (each rank's share, summed over the group
    as the engine sums gradients)."""
    import torch.distributed as dist

    from stemgnn_tpu_torch.parallel.ring import ring_attention

    mesh = _mesh(mesh_shape)
    leaves = [_t(a).requires_grad_(True) for a in (enc, wk, wq)]
    rows = ring_attention(mesh, *leaves, alpha)
    blk = mesh.node_block(len(wk))
    torch.sum(rows * _t(gout)[:, blk]).backward()
    grads = [leaf.grad.contiguous() for leaf in leaves]
    for g in grads:
        dist.all_reduce(g, group=mesh.graph_group)
    return {"rows": _np(rows), "enc": _np(grads[0]), "wk": _np(grads[1]),
            "wq": _np(grads[2])}


def ring_refusal(mesh_shape, cfg_kw, flat_params, data, hi, mask):
    """The message of a train step with use_ring where 'graph' does not
    divide N (the ring needs whole node blocks), or None."""
    try:
        train_step(mesh_shape, cfg_kw, flat_params, data, hi, mask, use_ring=True)
    except ValueError as e:
        return str(e)
    return None


def sparse_topk(mesh_shape, cfg_kw, flat_params, data, hi, mask):
    """One training forward of the stretch model (f32, the step's [N, k] mask)
    on the mesh (None: one process): the top-k index set of its graph and
    its loss, and the gradients of weight_query, gru/w_ih and gru/w_hh after
    the engine's sum over the mesh."""
    from stemgnn_tpu_torch.config import StemGNNConfig
    from stemgnn_tpu_torch.models import stemgnn
    from stemgnn_tpu_torch.models.convert import unflatten_params
    from stemgnn_tpu_torch.parallel.mesh import all_reduce_flat
    from stemgnn_tpu_torch.train import engine

    cfg = StemGNNConfig(**cfg_kw)
    mesh = None if mesh_shape is None else _mesh(mesh_shape)
    flat = {k: _t(v).requires_grad_(True) for k, v in flat_params.items()}
    x, y = engine.gather_windows(_t(data), _t(hi), cfg.window_size, cfg.horizon)
    forecast, g = stemgnn.forward(unflatten_params(flat), cfg, x, training=True,
                                  dropout_mask=_t(mask), mesh=mesh)
    loss = (torch.mean((forecast - y) ** 2) if mesh is None
            else engine._mesh_loss(forecast, y, cfg, mesh, False))
    loss.backward()
    names = ("weight_query", "gru/w_ih", "gru/w_hh")
    grads = [flat[k].grad for k in names]
    if mesh is not None:
        all_reduce_flat(grads, mesh.graph_group)
    return {"idx": sorted(g.idx.tolist()), "grads": {k: _np(v) for k, v in zip(names, grads)}}
