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


def _future_coverage_masks(coeffs, enables, n_v, n_u, n_y, n_x, sc,
                           n_chunks, row0=0):
    """Per slab boundary, the (V, U) rays that a remaining slab can reach.

    Ray row ``i`` takes a non-zero tent weight from traversal step ``k``
    only if its position ``(row0 + i)*ay[k] + by[k]`` lies in the tent's
    open support ``(-1, n_y)``, and likewise for columns; a step with
    ``enables[k] == 0`` contributes nothing. Positions are f32, a product
    and then a sum, each rounded: the forward kernel's and the twin's
    arithmetic, whatever the grid's dtype. The separable OR over the
    remaining steps, ``cov_v[i] & cov_u[j]``, is a superset of the rays
    those steps reach, so a ray outside the mask takes exactly nothing from
    any remaining slab. ``row0``: the ray planes are rows [row0, row0 + V)
    of the op's image (a row chunk).

    Returns a (n_chunks - 1, V, U) bool tensor on the coefficients'
    device; entry ``g - 1`` guards slab ``g``. Single-view (1-D) coeffs
    and enables only: a view batch's (views, S) would mis-broadcast the
    OR, so it raises ValueError.
    """
    ay, by, ax, bx = (torch.as_tensor(c).to(torch.float32) for c in coeffs)
    if ay.dim() != 1 or (enables is not None and enables.dim() != 1):
        raise ValueError(
            "ert_chunked_sweep supports single-view (1-D) coeffs and "
            f"enables only; got coeffs of {ay.dim()} dims"
            + ("" if enables is None else
               f", enables of {enables.dim()}"))
    dev = ay.device
    i = torch.arange(row0, row0 + n_v, dtype=torch.float32,
                     device=dev)[:, None]
    pos_v = i * ay[None, :] + by[None, :]                 # (V, S)
    j = torch.arange(n_u, dtype=torch.float32, device=dev)[:, None]
    pos_u = j * ax[None, :] + bx[None, :]                 # (U, S)
    valid_v = (pos_v > -1.0) & (pos_v < n_y)
    valid_u = (pos_u > -1.0) & (pos_u < n_x)
    if enables is not None:
        en = (enables > 0)[None, :]
        valid_v = valid_v & en
        valid_u = valid_u & en

    def remaining(valid):
        """(n_chunks - 1, rays): covered by any step of slabs g.. ."""
        per_slab = valid.reshape(valid.shape[0], n_chunks, sc).any(dim=2)
        suffix = per_slab.flip(1).to(torch.int32).cumsum(1).flip(1) > 0
        return suffix[:, 1:].T

    return remaining(valid_v)[:, :, None] & remaining(valid_u)[:, None, :]


def ert_chunked_sweep(op, grid_sc, coeffs, enables, dt_map, n_chunks,
                      reverse, eps, row0=0):
    """Slab-chunked forward with whole-slab early ray termination.

    The slice axis is cut into ``n_chunks`` slabs in traversal order (slab
    g is steps [g sc, (g + 1) sc), grid slices [S - (g + 1) sc, S - g sc)
    under ``reverse``). Each slab is a fresh render of its slices through
    ``op``, folded into the carry by the compositing identity
    ``(C, T) + T (C_g, T_g)``. Before slab g >= 1 a liveness flag asks
    whether any ray that a remaining slab can reach (the future-coverage
    mask; background rays that miss the volume keep T = 1 for ever and
    would hold every slab live) still has T >= ``eps``. Gradients flow
    through every slab's sweep by autograd.

    The flag stays on the device: it multiplies the slab's enables, so a
    dead slab still launches its sweep, every step disabled. The forward
    kernel walks such a slab without reading the grid and writes
    ``C_g = 0``, ``T_g = 1`` exactly (as the twin does), so the fold leaves
    the carry unchanged, and the backward gives the slab a zero gradient:
    what the JAX package's ``lax.cond`` gives by skipping the slab. That
    ``cond`` drops the launch; here it stays, because dropping it needs the
    flag on the host, a sync at every slab boundary, and would make the
    launch counts depend on the data. No call here reads a tensor back.

    ``row0``: the ray planes are rows [row0, row0 + V) of the op's image
    (a row chunk; the op itself must sample from row 0).
    """
    s = grid_sc.shape[0]
    if s % n_chunks:
        raise ValueError(f"ert_chunks {n_chunks} must divide slices {s}")
    sc = s // n_chunks
    n_v, n_u = dt_map.shape
    masks = _future_coverage_masks(coeffs, enables, n_v, n_u,
                                   grid_sc.shape[2], grid_sc.shape[3], sc,
                                   n_chunks, row0)
    # One autograd node: its backward joins the slabs' gradients once.
    slabs = torch.split(grid_sc, sc, dim=0)
    rgb = trans = None
    for g in range(n_chunks):
        tr = slice(g * sc, (g + 1) * sc)  # traversal-step range
        slab = slabs[n_chunks - 1 - g if reverse else g]
        en_g = enables[tr]
        if g:
            live = torch.amax(torch.where(masks[g - 1], trans.detach(),
                                          0.0)) >= eps
            en_g = en_g * live.to(en_g.dtype)
        rgb_g, t_g = op(slab, tuple(c[tr] for c in coeffs), en_g, dt_map,
                        row0=row0)
        if g:
            rgb, trans = rgb + trans[None] * rgb_g, trans * t_g
        else:
            rgb, trans = rgb_g, t_g
    return rgb, trans


def row_chunks(n_v: int, max_rows) -> int:
    """Row chunks of :func:`chunked_sweep` for ``n_v`` rows: the fewest of
    at most ``max_rows`` rows (None: one) that divide ``n_v`` evenly."""
    if max_rows is None or n_v <= max_rows:
        return 1
    n_chunks = -(-n_v // max_rows)
    while n_v % n_chunks:
        n_chunks += 1
    return n_chunks


def chunked_sweep(op, grid_sc, coeffs, enables, dt_map, max_rows=None,
                  ert_chunks=1, reverse=False, eps=0.0):
    """Apply a sweep op over row chunks of the intermediate image.

    ``op`` is a :func:`sweep_op`; chunk ``i`` is one call of it with the
    chunk's first row as ``row0``, so row ``r0 + v`` samples at ``(r0 +
    v)*ay + by``, exactly where the whole image's row does (the JAX
    package shifts ``by`` by ``r0*ay`` instead, which moves each position
    by up to an ulp). Per-chunk early termination is at least as
    aggressive as whole-image termination and keeps the same error bound.
    ``max_rows`` None disables chunking. Gradients flow through every
    chunk.

    ``ert_chunks`` > 1 with ``eps`` > 0: each row chunk also cuts the slice
    axis into slabs through :func:`ert_chunked_sweep` (``reverse`` is the
    op's traversal order), whose whole-slab termination keeps the same
    error bound. Otherwise each chunk is one call of ``op``.
    """
    n_v = dt_map.shape[0]

    def call(dt_c, r0):
        if ert_chunks > 1 and eps > 0.0:
            return ert_chunked_sweep(op, grid_sc, coeffs, enables, dt_c,
                                     ert_chunks, reverse, eps, row0=r0)
        return op(grid_sc, coeffs, enables, dt_c, row0=r0)

    n_chunks = row_chunks(n_v, max_rows)
    if n_chunks == 1:
        return call(dt_map, 0)
    rows = n_v // n_chunks
    rgbs, ts = [], []
    for i in range(n_chunks):
        r0 = i * rows
        rgb_i, t_i = call(dt_map[r0:r0 + rows], r0)
        rgbs.append(rgb_i)
        ts.append(t_i)
    return torch.cat(rgbs, dim=1), torch.cat(ts, dim=0)
