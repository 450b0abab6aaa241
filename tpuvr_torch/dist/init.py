"""Process groups and the collectives of the distributed paths.

The JAX package runs one process over a ``Mesh`` of devices. The port runs
one process per card (SPMD): every rank calls the same entry point with
the same arguments, and :class:`DataMesh` stands where that package's
``Mesh`` stood, so code written against the JAX names (``mesh.shape
["data"]``, ``mesh.axis_names``) reads the same.

Every collective the port issues goes through :func:`all_reduce` or
:func:`broadcast` here and is counted in :data:`collectives`, so a run can
show what it put on the wire.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import ClassVar, Optional

import torch
import torch.distributed as dist

# Collectives issued so far, by kind ("all_reduce", "broadcast").
collectives: collections.Counter[str] = collections.Counter()


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


def gather_tiles(tile: torch.Tensor, mesh: DataMesh, dim: int):
    """Every rank's equal ``tile``, concatenated along ``dim`` in rank
    order, on every rank: one all-reduce of the tiles zero-padded to the
    whole, which is exact (x + 0 = x) and takes the same route over gloo
    and NCCL, for CPU and CUDA tensors alike."""
    n = tile.shape[dim]
    shape = list(tile.shape)
    shape[dim] = n * mesh.world
    full = tile.new_zeros(shape)
    full.narrow(dim, mesh.rank * n, n).copy_(tile)
    all_reduce(full, mesh)
    return full
