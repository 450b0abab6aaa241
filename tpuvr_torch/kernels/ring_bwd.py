"""The ring backward: the view-batched backward sweep marched slab by slab,
each slab's grid gradient all-reduced while the next slab's backward runs.

Replaces the JAX package's ``_sweep_bwd_ring_kernel``
(``tpuvr/kernels/ring_bwd.py:183``, B11). That kernel is B4's dense
view-batched backward in one ``pallas_call`` whose grid marches every
slice; each finished slab of its gradient is all-reduced by a ring of
remote DMAs issued between the kernel's own grid steps, staged through
receive buffers because Mosaic has no accumulating DMA, and the reduced
(S, 4, Y, X) gradient comes out in place.

On Hopper, remote copies from inside a kernel become collectives outside
it. The compute stays K6 (``csrc/sweep_bwd.cu``, B4's port): it runs on
the compute stream once per slab, in traversal order, threading the
(T, q) carry, and writes the slab into its place in one preallocated
(S, 4, Y, X) buffer. Right after slab g's K6 is enqueued, its all-reduce
is issued asynchronously: NCCL runs it on its own stream, ordered after
K6(g), while K6(g + 1) computes. The wrapper waits on every work handle
before it returns (with NCCL that orders the caller's stream after the
reductions without blocking the host), so only the last slab's reduction
is exposed, as in the TPU kernel. The additions of the reduction happen
inside NCCL (or gloo), the card's counterpart of the TPU's remote copies.

What bounds it: the all-reduce's bytes. At c4 (256^3, 268 MB of f32
gradient) over n ranks each rank moves 2 (n - 1) / n x 268 MB, about 0.9
ms over NVLink's 450 GB/s each way at n = 4, while K6 over a rank's
quarter of the rows is bound near 0.16 ms by the grid's bytes. The
design's answer is overlap: with ``ring_chunks`` slabs, all but the last
slab's reduction can hide behind the next slab's backward.
"""

from __future__ import annotations

import torch

from tpuvr_torch.dist.init import all_reduce
from tpuvr_torch.kernels import sweep_bwd as kbwd
from tpuvr_torch.kernels.sweep_torch import (
    sweep_bwd_torch,
    sweep_bwd_views_torch,
)
from tpuvr_torch.utils import trace

# Ring backward calls that launched K6 on the card (each launches K6
# ``ring_chunks`` times, counted by the K6 wrapper); a run reads it to show
# that it went through the ring.
launches = 0
trace.counter(lambda: {"sweep_bwd_ring": launches})


def check_ring_size(ring_size: int, mesh) -> None:
    """The JAX wrapper's ring-size rule, and the ring must be the mesh."""
    if ring_size < 2:
        raise ValueError("sweep_bwd_ring needs ring_size >= 2; use "
                         "sweep_bwd and one all-reduce on a single rank")
    if mesh is None:
        raise ValueError("the ring needs a mesh: ring=(mesh, size, chunks)")
    if mesh.world != ring_size:
        raise ValueError(f"ring_size {ring_size} is not the mesh's "
                         f"{mesh.world} ranks")


def check_ring(s: int, ring_size: int, ring_chunks: int, mesh) -> int:
    """Validate a ring over ``s`` slices as the JAX wrapper does (its grid
    steps are blocks of 2 slices when S is even, else 1), so that both
    packages accept the same configurations. Returns the slab height."""
    check_ring_size(ring_size, mesh)
    n_steps = s // (2 if s % 2 == 0 else 1)
    if (ring_chunks < 1 or s % ring_chunks
            or (s // ring_chunks) % ring_size or n_steps % ring_chunks):
        raise ValueError(
            f"ring_chunks {ring_chunks} must divide slices {s} into slabs "
            f"divisible by ring_size {ring_size} and grid steps {n_steps}")
    return s // ring_chunks


def _twin_bwd(*args, views=1, out, **kw):
    """The plain twin of one slab's backward, written into ``out``."""
    if views > 1:
        grad, carry = sweep_bwd_views_torch(*args, views=views, **kw)
    else:
        grad, carry = sweep_bwd_torch(*args, **kw)
    return out.copy_(grad), carry


def _ring(bwd_fn, grid_sc, coeffs, enables, dt_map, c_final, t_final,
          d_color, d_trans, *, mesh, ring_chunks, reverse, **kw):
    """The slab loop: slabs follow traversal order (slab 0 holds the first
    slices the rays hit) so the carry threads forward; slab g goes to its
    grid-order place in the output and is all-reduced right after its
    backward is issued; every reduction is waited on at the end. The
    traversal range is cut on the last dim of the coefficients and
    enables, so (S,) and a view batch's (views, S) both work."""
    s = grid_sc.shape[0]
    sc = s // ring_chunks
    n_v, n_u = dt_map.shape
    out = torch.empty_like(grid_sc, memory_format=torch.contiguous_format)
    carry = (torch.ones((n_v, n_u), dtype=grid_sc.dtype,
                        device=grid_sc.device),
             torch.zeros((n_v, n_u), dtype=grid_sc.dtype,
                         device=grid_sc.device))
    works = []
    for g in range(ring_chunks):
        tr = slice(g * sc, (g + 1) * sc)  # traversal-step range
        g_lo = (s - (g + 1) * sc) if reverse else g * sc
        slab = out[g_lo:g_lo + sc]
        _, carry = bwd_fn(
            grid_sc[g_lo:g_lo + sc], tuple(c[..., tr] for c in coeffs),
            enables[..., tr], dt_map, c_final, t_final, d_color, d_trans,
            carry=carry, out=slab, reverse=reverse, **kw)
        works.append(all_reduce(slab, mesh, async_op=True))
    for work in works:
        work.wait()
    return out


def sweep_bwd_ring_torch(
    grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color, d_trans,
    *, mesh, ring_size, ring_chunks=4, **kw,
):
    """The plain version of :func:`sweep_bwd_ring`: the same slab loop and
    all-reduces over the plain twin of the backward sweep, on any
    device."""
    check_ring(grid_sc.shape[0], ring_size, ring_chunks, mesh)
    return _ring(_twin_bwd, grid_sc, coeffs, enables, dt_map, c_final,
                 t_final, d_color, d_trans, mesh=mesh,
                 ring_chunks=ring_chunks, **kw)


def sweep_bwd_ring(
    grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color, d_trans,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False, views=1, row0=0, mesh, ring_size,
    ring_chunks=4,
):
    """Gradient of the forward sweep with respect to ``grid_sc``, summed
    over the mesh's ranks: each rank passes its own rays (its row tile of
    every view, with its ``row0``, as
    :func:`~tpuvr_torch.kernels.sweep_bwd.sweep_bwd` takes them), and
    every rank gets the same (S, 4, Y, X) sum.

    ``ring_chunks`` slabs the slice axis; ``ring_chunks * ring_size`` must
    divide the slice count and ``ring_chunks`` the JAX kernel's grid-step
    count, and ``ring_size`` (>= 2) is the mesh's rank count. Every rank
    must make the same call: each issues ``ring_chunks`` all-reduces.
    For CUDA tensors it launches K6 per slab (or raises); for CPU tensors
    it runs :func:`sweep_bwd_ring_torch`.
    """
    global launches
    kw = dict(reverse=reverse, sigma_scale=sigma_scale,
              early_stop_eps=early_stop_eps, precision=precision,
              softplus=softplus, views=views, row0=row0)
    args = (grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color,
            d_trans)
    if not grid_sc.is_cuda:
        return sweep_bwd_ring_torch(*args, mesh=mesh, ring_size=ring_size,
                                    ring_chunks=ring_chunks, **kw)
    check_ring(grid_sc.shape[0], ring_size, ring_chunks, mesh)
    out = _ring(kbwd.sweep_bwd, *args, mesh=mesh, ring_chunks=ring_chunks,
                **kw)
    launches += 1
    return out
