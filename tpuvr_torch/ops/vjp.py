"""The differentiable sweep op and row chunking.

``sweep_op`` binds the forward sweep and its recompute backward as a
``torch.autograd.Function``. Its residuals are the inputs plus the final
(rgb, T), with no per-slice activations; gradients flow to the grid only,
and camera geometry (coeffs, dt) and the occupancy enables get none. With
``impl='cuda'`` both directions are the CUDA kernels; with ``impl='torch'``
both are the plain twins, which run wherever their tensors are. A view
batch (``views`` > 1) goes to the same kernels over all its views in one
launch each way, or to the view-batched twins. On a mesh of ranks each
sweeping its own rays, the op can return the gradient summed over the
ranks: slab by slab in stream order (``mesh``), or through the ring
backward (``ring``).
"""

from __future__ import annotations

import torch

from tpuvr_torch.dist.init import all_reduce
from tpuvr_torch.kernels.ring_bwd import (
    check_ring_size,
    sweep_bwd_ring,
    sweep_bwd_ring_torch,
)
from tpuvr_torch.kernels.sweep import sweep_fwd
from tpuvr_torch.kernels.sweep_bwd import sweep_bwd
from tpuvr_torch.kernels.sweep_torch import (
    sweep_bwd_torch,
    sweep_bwd_views_torch,
    sweep_fwd_torch,
    sweep_fwd_views_torch,
)


def resolve_impl(impl: str | None, t: torch.Tensor) -> str:
    """'auto'/None -> 'cuda' for a CUDA tensor, 'torch' for a CPU one."""
    if impl in (None, "auto"):
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown sweep impl: {impl!r}")
    return impl


class _Sweep(torch.autograd.Function):
    """(grid_sc, ay, by, ax, bx, enables, dt_map) -> (rgb, T); the
    coefficients travel as separate tensors so autograd sees each one."""

    @staticmethod
    def forward(ctx, grid_sc, ay, by, ax, bx, enables, dt_map, spec):
        fwd = spec[0]
        kw = spec[2]
        rgb, trans = fwd(grid_sc, (ay, by, ax, bx), enables, dt_map, **kw)
        ctx.save_for_backward(grid_sc, ay, by, ax, bx, enables, dt_map,
                              rgb, trans)
        ctx.spec = spec
        return rgb, trans

    @staticmethod
    def backward(ctx, d_rgb, d_trans):
        grid_sc, ay, by, ax, bx, enables, dt_map, rgb, trans = (
            ctx.saved_tensors)
        _, bwd, kw, bwd_chunks, mesh, ring = ctx.spec
        dgrid = None
        if ctx.needs_input_grad[0]:
            args = (grid_sc, (ay, by, ax, bx), enables, dt_map, rgb, trans,
                    d_rgb.contiguous(), d_trans.contiguous())
            if ring is not None:
                ring_fn, r_mesh, r_size, r_chunks = ring
                dgrid = ring_fn(*args, mesh=r_mesh, ring_size=r_size,
                                ring_chunks=r_chunks, **kw)
            elif bwd_chunks > 1 or mesh is not None:
                dgrid = _chunked_bwd(bwd, bwd_chunks, *args, kw, mesh)
            else:
                dgrid = bwd(*args, **kw)
        return dgrid, None, None, None, None, None, None, None


def sweep_op(
    reverse: bool,
    sigma_scale: float,
    early_stop_eps: float,
    impl: str,
    precision: str = "highest",
    *,
    views: int = 1,
    bwd_chunks: int = 1,
    softplus: bool = False,
    mesh=None,
    ring: tuple | None = None,
    row0: int = 0,
):
    """Differentiable sweep: (grid_sc, coeffs, enables, dt_map) ->
    (rgb (3, V, U), T (V, U)).

    ``impl`` 'cuda' runs the CUDA kernels, 'torch' the plain twins.
    ``softplus``: the grid's density channel holds raw parameters; the
    sweeps apply softplus per slice and the gradient is with respect to
    the raw parameters. ``bwd_chunks`` > 1 runs the backward slab by slab
    along the slice axis, threading the (trans, q) recompute carry.
    ``views`` > 1: the operands are a view batch, as the JAX package's
    (coeffs and enables (views, S), ray planes stacked along V), marched
    in one call each way; the gradient is the sum over the views.
    ``row0``: the ray planes are rows [row0, row0 + V) of each view's
    image, each sampled where the whole image's row is (a rank's row
    tile; see :func:`~tpuvr_torch.kernels.sweep.sweep_fwd`).

    ``mesh`` (a :class:`~tpuvr_torch.dist.init.DataMesh`; the JAX
    package's ``axis_name``): every rank sweeps its own rays, and the
    gradient comes out summed over the ranks, each of the ``bwd_chunks``
    slabs all-reduced as it comes out, in stream order (the next slab's
    backward waits for it). The caller must not reduce it again.
    ``ring = (mesh, size, chunks)``: the ring backward instead
    (:mod:`tpuvr_torch.kernels.ring_bwd`, B11's port), ``chunks`` slabs
    whose all-reduces overlap the next slab's backward; ``size`` (>= 2)
    is the mesh's rank count. Exclusive of ``bwd_chunks`` and ``mesh``,
    as in the JAX package.
    """
    if ring is not None:
        if bwd_chunks > 1 or mesh is not None:
            raise ValueError("ring is mutually exclusive with "
                             "bwd_chunks/mesh")
        r_mesh, r_size, r_chunks = ring
        check_ring_size(r_size, r_mesh)
        ring = ((sweep_bwd_ring if impl == "cuda" else sweep_bwd_ring_torch),
                r_mesh, int(r_size), int(r_chunks))
    if impl == "cuda":
        fwd, bwd = sweep_fwd, sweep_bwd
    elif impl == "torch" and views > 1:
        fwd, bwd = sweep_fwd_views_torch, sweep_bwd_views_torch
    elif impl == "torch":
        fwd, bwd = sweep_fwd_torch, sweep_bwd_torch
    else:
        raise ValueError(f"unknown sweep impl: {impl!r}")
    kw = dict(reverse=reverse, sigma_scale=sigma_scale,
              early_stop_eps=early_stop_eps, precision=precision,
              softplus=softplus, row0=int(row0))
    if views > 1:
        kw["views"] = int(views)
    spec = (fwd, bwd, kw, int(bwd_chunks), mesh, ring)

    def op(grid_sc, coeffs, enables, dt_map, row0=0):
        """``row0``: ``dt_map`` holds rows [row0, row0 + V) of the op's own
        rows (a row chunk of them), sampled where those rows are."""
        s = spec
        if row0:
            s = (fwd, bwd, {**kw, "row0": kw["row0"] + int(row0)},
                 *spec[3:])
        return _Sweep.apply(grid_sc, *coeffs, enables, dt_map, s)

    return op


def _chunked_bwd(bwd_fn, n_chunks, grid_sc, coeffs, enables, dt_map, rgb,
                 trans, d_rgb, d_trans, kw, mesh=None):
    """Slab-chunked backward: chunks follow traversal order (chunk 0 holds
    the first slices the rays hit), so the (trans, q) carry threads
    forward; the slabs are put back in grid order for ``reverse``. The
    traversal range is cut on the last dim of the coefficients and
    enables, so (S,) and a view batch's (views, S) both work. With a
    ``mesh`` each slab's gradient is all-reduced as it comes out."""
    s = grid_sc.shape[0]
    if s % n_chunks:
        raise ValueError(f"bwd_chunks {n_chunks} must divide slices {s}")
    sc = s // n_chunks
    n_v, n_u = dt_map.shape
    carry = (torch.ones((n_v, n_u), dtype=grid_sc.dtype,
                        device=grid_sc.device),
             torch.zeros((n_v, n_u), dtype=grid_sc.dtype,
                         device=grid_sc.device))
    parts = []
    for g in range(n_chunks):
        tr = slice(g * sc, (g + 1) * sc)  # traversal-step range
        g_lo = (s - (g + 1) * sc) if kw["reverse"] else g * sc
        grad_g, carry = bwd_fn(
            grid_sc[g_lo:g_lo + sc], tuple(c[..., tr] for c in coeffs),
            enables[..., tr], dt_map, rgb, trans, d_rgb, d_trans,
            carry=carry, **kw,
        )
        if mesh is not None:
            grad_g = grad_g.contiguous()
            all_reduce(grad_g, mesh)
        parts.append(grad_g)
    if kw["reverse"]:
        parts = parts[::-1]
    return torch.cat(parts, dim=0)


def chunked_sweep(op, grid_sc, coeffs, enables, dt_map, max_rows=None):
    """Apply a sweep op over row chunks of the intermediate image.

    ``op`` is a :func:`sweep_op`; chunk ``i`` is one call of it with the
    chunk's first row as ``row0``, so row ``r0 + v`` samples at ``(r0 +
    v)*ay + by``, exactly where the whole image's row does (the JAX
    package shifts ``by`` by ``r0*ay`` instead, which moves each position
    by up to an ulp). Per-chunk early termination is at least as
    aggressive as whole-image termination and keeps the same error bound.
    ``max_rows`` None disables chunking. Gradients flow through every
    chunk.
    """
    n_v = dt_map.shape[0]
    if max_rows is None or n_v <= max_rows:
        return op(grid_sc, coeffs, enables, dt_map)
    n_chunks = -(-n_v // max_rows)
    while n_v % n_chunks:
        n_chunks += 1
    rows = n_v // n_chunks
    rgbs, ts = [], []
    for i in range(n_chunks):
        r0 = i * rows
        rgb_i, t_i = op(grid_sc, coeffs, enables, dt_map[r0:r0 + rows],
                        row0=r0)
        rgbs.append(rgb_i)
        ts.append(t_i)
    return torch.cat(rgbs, dim=1), torch.cat(ts, dim=0)
