"""The ('data', 'graph') mesh over a torch.distributed process group, and the
differentiable collectives the sharded paths run on it
(stemgnn_tpu/parallel/mesh.py).

- 'data' is batch data parallelism: each rank takes B / data rows of a batch.
- 'graph' partitions the node axis N: each rank holds one block of N / graph
  nodes, of the stretch path's sparse latent graph (`parallel/sparse_shard.py`)
  or of the dense path's attention rows and Chebyshev stack
  (`parallel/dense_shard.py`).

One process is one device. Rank r sits at (r // graph, r % graph), the JAX
package's row-major device grid. Its 'graph' group is the ranks of its data
coordinate and its 'data' group the ranks of its graph coordinate. The
collectives go over NCCL on the card and gloo on the CPU (`init_distributed`).

Where the JAX package lets GSPMD insert the collectives, the port states them.
A sharded step's loss is the sum of the ranks' local losses
(`train/engine.py` `_mesh_loss`), and each rank's backward starts from its own. So the
cotangent a rank holds at a collective's output is its own loss's share, and
the backward of every collective here sums those shares over the group: the
backward of a sum over ranks is a sum over ranks, and the backward of an
all-gather is the sum of the ranks' cotangents, cut to the rank's own block.
No rank ever holds the whole cotangent of a replicated value, so nothing is
counted twice. The all-to-all of blocks moves each of a rank's blocks to
one other rank and makes no replica: the cotangent a rank holds at its
output is the whole of it, and the backward sends it back where the value
came from.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a data x graph mesh and the groups it sums over."""

    data: int  # mesh size along 'data'
    graph: int  # mesh size along 'graph'
    rank: int
    data_group: object  # the ranks of this rank's graph coordinate
    graph_group: object  # the ranks of this rank's data coordinate
    world_group: object  # every rank of the mesh

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def data_index(self) -> int:
        return self.rank // self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a batch sharded over 'data'."""
        if batch % self.data:
            raise ValueError(f"batch {batch} not divisible by data axis {self.data}")
        rows = batch // self.data
        return slice(self.data_index * rows, (self.data_index + 1) * rows)

    def node_block(self, n: int) -> slice:
        """This rank's block of an N-node axis partitioned over 'graph'."""
        if n % self.graph:
            raise ValueError(f"N={n} not divisible by graph axis {self.graph}")
        nl = n // self.graph
        return slice(self.graph_index * nl, (self.graph_index + 1) * nl)


def make_mesh(data_axis: int = 1, graph_axis: int = 1) -> Mesh:
    """A ('data', 'graph') mesh over the initialised process group, whose world
    must be data_axis * graph_axis ranks. Every rank calls it (it creates the
    sub-groups, which every rank creates in the same order)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_distributed, or torchrun)")
    world = dist.get_world_size()
    n = data_axis * graph_axis
    if n > world:
        raise ValueError(f"mesh {data_axis}x{graph_axis} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {data_axis}x{graph_axis} covers {n} of {world} ranks")
    rank = dist.get_rank()
    graph_groups = [dist.new_group([d * graph_axis + g for g in range(graph_axis)])
                    for d in range(data_axis)]
    data_groups = [dist.new_group([d * graph_axis + g for d in range(data_axis)])
                   for g in range(graph_axis)]
    return Mesh(data=data_axis, graph=graph_axis, rank=rank,
                data_group=data_groups[rank % graph_axis],
                graph_group=graph_groups[rank // graph_axis],
                world_group=dist.group.WORLD)


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Split n devices into (data, graph) — graph axis gets the larger
    factor (the N^2 terms dominate scaling; SURVEY.md section 3.3)."""
    data = 1
    graph = n_devices
    # prefer a 2 x (n/2) split when possible so both axes are exercised
    if n_devices % 2 == 0 and n_devices > 2:
        data, graph = 2, n_devices // 2
    return data, graph


def init_distributed(device="cuda", init_method: str = "env://", rank=None,
                     world_size=None) -> torch.device:
    """Initialise the process group, NCCL for a CUDA device and gloo for the
    CPU, and return this rank's device. By default the rendezvous is env://,
    as torchrun sets it (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT); `init_method`, `rank` and `world_size` name another one
    (file:// for a FileStore). A CUDA rank takes card LOCAL_RANK. A request for
    NCCL with no card raises: nothing falls back to gloo."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: NCCL needs a card, and "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, **kw)
    return dev


@contextlib.contextmanager
def world_of_one(device="cuda"):
    """A process group of this process alone, from a FileStore in a temporary
    directory, for as long as the block runs; an existing group is kept as it
    is. Yields this rank's device."""
    if dist.is_initialized():
        yield torch.device(device)
        return
    with tempfile.TemporaryDirectory() as tmp:
        dev = init_distributed(device, f"file://{os.path.join(tmp, 'rendezvous')}", 0, 1)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def is_lead() -> bool:
    """True on the rank that writes files (stemgnn_tpu/train/engine.py:428-430):
    rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the group of each rank's x. Backward: each rank's x
    reaches every rank's y, so dx is the sum over the group of the ranks' dy
    (the ranks' shares of the loss's cotangent, module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """y = the ranks' x joined in rank order along `dim`. Backward: the sum over
    the group of the ranks' dy, cut to this rank's block of `dim`."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None


class _AllToAllBlocks(torch.autograd.Function):
    """x [P, ...]: block s goes to the group's rank s, and y [P, ...] holds in
    block s what rank s sent this rank. Backward: the same exchange of the
    cotangents, each back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(y, x.contiguous(), group=group)
    return y


def all_reduce_sum(x, group):
    """The sum over `group` of each rank's x, differentiable (`_AllReduceSum`)."""
    return _AllReduceSum.apply(x, group)


def all_gather(x, group, dim: int = 0):
    """The ranks' x joined in rank order along `dim`, differentiable (`_AllGather`)."""
    return _AllGather.apply(x, group, dim)


def all_to_all_blocks(x, group):
    """x [P, ...] over a group of P ranks: block s to rank s; returns in block
    s what rank s sent. Differentiable (`_AllToAllBlocks`)."""
    return _AllToAllBlocks.apply(x, group)


def all_gather_cat(x, group, dim: int = 0):
    """The ranks' x joined in rank order along `dim`, not differentiable (for
    indices and for forecasts that leave the model)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def batch_mean(t, mesh, batch_sharded: bool):
    """t.mean(dim=0) over the step's whole batch: with `batch_sharded` (over a
    'data' axis > 1) each rank holds B / data rows, whose sums are added over
    'data'."""
    if not batch_sharded:
        return t.mean(dim=0)
    return all_reduce_sum(t.sum(dim=0), mesh.data_group) / (t.shape[0] * mesh.data)


def all_reduce_flat(tensors, group) -> None:
    """Sum each tensor over `group` in place: the tensors of one dtype are
    joined, in their order, into one flat buffer that one all-reduce sums, so
    the sum order is fixed and a rerun gives the same bits."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()
