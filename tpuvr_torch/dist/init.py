"""Process groups and the collectives of the distributed paths.

The JAX package runs one process over a ``Mesh`` of devices. The port runs
one process per card (SPMD): every rank calls the same entry point with
the same arguments, and :class:`DataMesh` (the 1-D ``'data'`` mesh) or
:class:`GridMesh` (the 2-D ``('data', 'z')`` mesh of the z-sharded grid)
stands where that package's ``Mesh`` stood, so code written against the
JAX names (``mesh.shape["data"]``, ``mesh.axis_names``) reads the same.

Every collective the port issues goes through a function here
(:func:`all_reduce`, :func:`broadcast`, :func:`all_to_all`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`exchange`) and is
counted in :data:`collectives`, so a run can show what it put on the
wire. Each of them takes one route over gloo and NCCL, for CPU and CUDA
tensors alike.

The distributed renders are differentiable through
``torch.autograd.Function``s whose forward is the counted collective and
whose backward is its transpose, counted the same way: :func:`all_gather`
(its backward a :func:`reduce_scatter`), :func:`all_to_all` (its own
transpose), :func:`exchange` (the reversed pairs), :func:`gather_tiles`
(the rank's own tile of the cotangent) and :func:`replicated` (an identity
whose backward all-reduces the cotangent). On tensors that need no
gradient they are the plain collectives.

The gradient contract. The port is SPMD, and under the JAX package's
``shard_map`` a render has one global loss: here **every rank takes the
same loss of the same image and differentiates it**. The image comes out
of :func:`gather_tiles`, whole and equal on every rank; the cotangent
every rank then holds for it is the global one, so the backward of the
gather is the rank's own tile, with no sum (a sum would make the gradient
n times too large, the fault of the JAX package's mesh train step,
ROADMAP C). An input that every rank holds whole but uses for its own
part of the work (the grid of ``render_view_dp``, a slab shared by the
``'data'`` ranks) goes through :func:`replicated`, whose all-reduce is
JAX's transpose of an input invariant over the axis. A loss that differs
from rank to rank is outside the contract, and a backward run on only
some ranks hangs: its collectives wait for ranks that never start them.
Every rank must run the same graph's backward, which runs the same
collectives in the same order.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import ClassVar, Optional

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from tpuvr_torch.utils import trace

# Collectives issued so far, by kind ("all_reduce", "broadcast",
# "all_to_all", "all_gather", "reduce_scatter", "exchange").
collectives: collections.Counter[str] = collections.Counter()
trace.counter(lambda: {f"collective_{k}": n for k, n in collectives.items()})


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh of ranks: axis "data" shards rays, the grid is
    replicated. ``group`` is the process group (None: the default one)."""

    group: Optional[object]
    rank: int
    world: int
    axis_names: ClassVar[tuple] = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": self.world}


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """The 2-D ``('data', 'z')`` mesh of the z-sharded grid (the JAX
    package's ``grid_mesh``): rays row-sharded over ``'data'``, the grid
    slab-sharded over ``'z'``. Rank ``r = i * n_z + d`` sits at data index
    ``i`` and z index ``d`` (that package's ``devices.reshape(n_data,
    n_z)`` order). ``data`` is the :class:`DataMesh` of the ranks sharing
    ``d`` (one per slab), ``z`` the one of the ranks sharing ``i``; ``flat``
    spans every rank in rank order."""

    n_data: int
    n_z: int
    rank: int
    data: DataMesh
    z: DataMesh
    flat: DataMesh
    axis_names: ClassVar[tuple] = ("data", "z")

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "z": self.n_z}

    @property
    def world(self) -> int:
        return self.n_data * self.n_z


def grid_mesh(n_data: int = 1, n_z: int = 1) -> GridMesh:
    """The ``('data', 'z')`` mesh over every rank of the default group,
    made once ``torch.distributed`` is up (a ValueError unless the world
    has ``n_data * n_z`` ranks). Creating a process group is collective:
    every rank creates every group, the n_z ``'data'`` groups and then the
    n_data ``'z'`` groups, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "tpuvr_torch.dist.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_z:
        raise ValueError(f"a {n_data}x{n_z} mesh needs {n_data * n_z} "
                         f"ranks, the world has {world}")
    i, d = divmod(rank, n_z)
    data_groups = [dist.new_group([k * n_z + dd for k in range(n_data)])
                   for dd in range(n_z)]
    z_groups = [dist.new_group([ii * n_z + k for k in range(n_z)])
                for ii in range(n_data)]
    return GridMesh(n_data, n_z, rank,
                    data=DataMesh(data_groups[d], i, n_data),
                    z=DataMesh(z_groups[i], d, n_z),
                    flat=DataMesh(None, rank, world))


def data_mesh(group=None) -> DataMesh:
    """The mesh of ``group`` (None: every rank of the default group), made
    once ``torch.distributed`` is up."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "tpuvr_torch.dist.initialize first")
    return DataMesh(group, dist.get_rank(group), dist.get_world_size(group))


def initialize(backend: str, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None, store=None,
               device: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Bring up ``torch.distributed`` with ``backend`` ("nccl", "gloo").

    Rank and world size come from the arguments or, as torchrun sets them,
    from ``RANK`` and ``WORLD_SIZE`` (and ``MASTER_ADDR``/``MASTER_PORT``
    for the default ``env://`` rendezvous); ``store`` (a
    ``torch.distributed.Store``) replaces the rendezvous. With
    ``device="cuda"`` the rank first takes card ``LOCAL_RANK`` (else its
    rank) modulo the cards it sees as its current device, before any
    tensor is made. The backend is used as given: a failure raises.
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)


def all_reduce(t: torch.Tensor, mesh: DataMesh, async_op: bool = False):
    """Sum ``t`` over the mesh, in place (``t`` contiguous). Returns the
    work handle with ``async_op``: wait on it before reading ``t``."""
    collectives["all_reduce"] += 1
    return dist.all_reduce(t, group=mesh.group, async_op=async_op)


def broadcast(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Overwrite ``t`` with the mesh's first rank's copy, in place."""
    collectives["broadcast"] += 1
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(t, src=src, group=mesh.group)
    return t


def bucketed_all_reduce(grads: torch.Tensor, mesh: DataMesh,
                        n_buckets: int = 4) -> torch.Tensor:
    """All-reduce a gradient in ``n_buckets`` slabs along dim 0, in place
    (the JAX package's ``bucketed_psum_grads``): equal to one all-reduce.
    The buckets go out together and are waited on at the end."""
    s = grads.shape[0]
    if n_buckets <= 1 or s < n_buckets:
        all_reduce(grads, mesh)
        return grads
    bounds = [s * i // n_buckets for i in range(n_buckets + 1)]
    works = [all_reduce(grads[lo:hi], mesh, async_op=True)
             for lo, hi in zip(bounds, bounds[1:])]
    for work in works:
        work.wait()
    return grads


def _gather_tiles(tile: torch.Tensor, mesh: DataMesh, dim: int):
    """:func:`gather_tiles`' forward: one all-reduce of the tiles
    zero-padded to the whole, which is exact (x + 0 = x) and takes the same
    route over gloo and NCCL, for CPU and CUDA tensors alike."""
    n = tile.shape[dim]
    shape = list(tile.shape)
    shape[dim] = n * mesh.world
    full = tile.new_zeros(shape)
    full.narrow(dim, mesh.rank * n, n).copy_(tile)
    all_reduce(full, mesh)
    return full


def _all_to_all(chunks: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    collectives["all_to_all"] += 1
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.group)
    return out


def _all_gather(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    collectives["all_gather"] += 1
    outs = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(outs, t.contiguous(), group=mesh.group)
    return torch.stack(outs)


def _exchange(t: torch.Tensor, pairs, mesh: DataMesh) -> torch.Tensor:
    """:func:`exchange`'s forward: one ``all_to_all_single`` with one
    non-empty split each way, so only the pairs' bytes move."""
    collectives["exchange"] += 1
    dst = dict(pairs).get(mesh.rank)
    src = {b: a for a, b in pairs}.get(mesh.rank)
    n = t.numel()
    flat = t.contiguous().reshape(-1)
    send = flat if dst is not None else flat[:0]
    recv = torch.zeros(n if src is not None else 0, dtype=t.dtype,
                       device=t.device)
    dist.all_to_all_single(
        recv, send,
        output_split_sizes=[n if j == src else 0 for j in range(mesh.world)],
        input_split_sizes=[n if j == dst else 0 for j in range(mesh.world)],
        group=mesh.group)
    return recv.reshape(t.shape) if src is not None else torch.zeros_like(t)


def reduce_scatter(stack: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum over the mesh's ranks of their ``stack[rank]`` ((n, ...),
    leading dim the mesh's size), on this rank: one
    ``reduce_scatter_tensor``. Not differentiable: it is
    :func:`all_gather`'s backward."""
    collectives["reduce_scatter"] += 1
    stack = stack.contiguous()
    out = stack.new_empty(stack.shape[1:])
    dist.reduce_scatter_tensor(out.reshape(-1), stack.reshape(-1),
                               group=mesh.group)
    return out


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tile, mesh, dim):
        ctx.span = (dim, mesh.rank * tile.shape[dim], tile.shape[dim])
        return _gather_tiles(tile, mesh, dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return grad.narrow(*ctx.span), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunks, mesh):
        ctx.mesh = mesh
        return _all_to_all(chunks, mesh)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_gather(t, mesh)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pairs, mesh):
        ctx.pairs, ctx.mesh = pairs, mesh
        return _exchange(t, pairs, mesh)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        back = [(dst, src) for src, dst in ctx.pairs]
        return _exchange(grad, back, ctx.mesh), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        all_reduce(grad, ctx.mesh)
        return grad, None


def gather_tiles(tile: torch.Tensor, mesh: DataMesh, dim: int):
    """Every rank's equal ``tile``, concatenated along ``dim`` in rank
    order, on every rank (one all-reduce). Its backward is the rank's own
    tile of the cotangent, with no sum and no collective: under the
    module's gradient contract every rank holds the same cotangent of the
    whole."""
    return _GatherTiles.apply(tile, mesh, dim)


def all_to_all(chunks: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``chunks[j]`` (leading dim = the mesh's size) goes to rank j; returns
    what every rank sent this one, ``out[j]`` from rank j (the JAX
    package's tiled ``all_to_all``). Its own transpose: the backward is the
    same ``all_to_all`` of the cotangent."""
    return _AllToAll.apply(chunks, mesh)


def all_gather(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's equal ``t``, stacked on a new leading dim in rank
    order, on every rank. Backward: rank d's gradient is the sum over the
    ranks k of rank k's cotangent of slot d (one :func:`reduce_scatter`)."""
    return _AllGather.apply(t, mesh)


def exchange(t: torch.Tensor, pairs, mesh: DataMesh) -> torch.Tensor:
    """The JAX package's ``ppermute``: for each ``(src, dst)`` of ``pairs``
    (mesh ranks, each at most once a source and once a destination), rank
    ``dst`` receives rank ``src``'s ``t``; a rank that is no destination
    receives zeros. Every rank calls it with the same ``pairs`` and an
    equal ``t``. Backward: the cotangent goes back over the reversed pairs
    (one more exchange); a rank that was no source gets zeros."""
    return _Exchange.apply(t, pairs, mesh)


def replicated(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` unchanged, for an input every rank of ``mesh`` holds whole and
    uses for its own part of the work: the backward all-reduces the
    cotangent over the mesh (the JAX package's transpose of an input
    invariant over an axis). On a mesh of one rank, ``t`` itself."""
    return t if mesh.world == 1 else _Replicated.apply(t, mesh)
