"""User-facing render entry points.

``render_view(grid, cam)`` factors the camera into a sweep plan (host-side
float64), streams the grid through the sweep kernel, and warps the
intermediate image to pixels. For a frame loop over one grid, call
:func:`prepare_grid` once and :func:`render_prepared` per frame.

Every entry point takes ``device``: ``None`` is the card, and only
``device="cpu"`` runs the plain PyTorch versions. A frame's phases and
``prepare_grid``'s are spans of ``tpuvr_torch.utils.trace``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpuvr_torch.config import LightingConfig, RenderConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.dist.init import gather_tiles, replicated
from tpuvr_torch.ops.geometry import (
    plan_sweep,
    plan_valid_mask,
    ray_dt,
    slice_coeffs,
    warp_to_pixels,
    warp_to_pixels_dynamic,
)
from tpuvr_torch.ops.vjp import chunked_sweep, resolve_impl, sweep_op
from tpuvr_torch.ref.camera import camera_rays, dominant_axis
from tpuvr_torch.ref.march import GRID_PERM, render_fixed_dt
from tpuvr_torch.utils import trace


def grid_to_sweep_layout(grid, axis: int):
    """(Z, Y, X, 4) -> contiguous (S, 4, Y, X) kernel layout for ``axis``."""
    return grid.permute(GRID_PERM[axis]).permute(0, 3, 1, 2).contiguous()


def sweep_layout_to_grid(grid_sc, axis: int):
    """Inverse of :func:`grid_to_sweep_layout` (every GRID_PERM is an
    involution)."""
    return grid_sc.permute(0, 2, 3, 1).permute(GRID_PERM[axis]).contiguous()


def slice_enables(grid_sc, reverse: bool, use_occupancy: bool):
    """Per-traversal-slice 0/1 flags: a slice whose maximum density is
    <= 0 contributes nothing and is skipped (lossless). No gradient flows
    through them."""
    s = grid_sc.shape[0]
    if not use_occupancy:
        return torch.ones(s, dtype=grid_sc.dtype, device=grid_sc.device)
    slice_max = torch.amax(grid_sc[:, 0].detach(), dim=(1, 2))
    enables = (slice_max > 0.0).to(grid_sc.dtype)
    return enables.flip(0) if reverse else enables


def _grid_shape_from_sweep(axis: int, gsc_shape):
    """(S, 4, Y', X') -> the (Z, Y, X, 4) shape it was laid out from."""
    s, _, yp, xp = gsc_shape
    if axis == 0:
        return (xp, yp, s, 4)
    if axis == 1:
        return (yp, s, xp, 4)
    return (s, yp, xp, 4)


def _check_cfg(cfg: RenderConfig, modes=("plane_sweep",)):
    """Refuse a mode outside ``modes`` ('fixed_dt' has no prepared form)."""
    if cfg.mode not in modes:
        raise ValueError(f"render mode {cfg.mode!r} is not one of {modes}")


def prepare_grid(
    grid,
    axes=(0, 1, 2),
    lighting: Optional[LightingConfig] = None,
    precision: str = "highest",
    device=None,
):
    """Per-grid-update work of the frame loop: the optional lighting bake,
    the sweep-layout transpose and the per-slice max density.

    Returns ``{axis: (grid_sc, slice_max)}`` for :func:`render_prepared`;
    rebuild it whenever the grid or the lighting changes.
    """
    grid = torch.as_tensor(grid, device=resolve_device(device))
    if lighting is not None and lighting.mode != "none":
        from tpuvr_torch.ops.lighting import apply_lighting

        with trace.span("tpuvr.prepare.bake"):
            grid = apply_lighting(grid, lighting, precision)
    prep = {}
    with trace.span("tpuvr.prepare.layout"):
        for axis in axes:
            grid_sc = grid_to_sweep_layout(grid, axis)
            slice_max = torch.amax(grid_sc[:, 0].detach(), dim=(1, 2))
            prep[int(axis)] = (grid_sc, slice_max)
    return prep


@functools.lru_cache(maxsize=16)
def _frame_geometry(cam, grid_shape, axis, oversample, dtype, device):
    """Plan, per-slice coefficients, dt, visibility mask and pixel base
    points of one camera; cached because cameras are static and a frame
    loop renders the same few again and again."""
    plan, uv_pixel = plan_sweep(cam, grid_shape, axis, oversample=oversample)
    coeffs = slice_coeffs(plan, dtype, device)
    dt_map = ray_dt(plan, dtype, device)
    valid = plan_valid_mask(plan, dtype, device)
    uv = (None if uv_pixel is None
          else torch.as_tensor(uv_pixel, dtype=dtype, device=device))
    return plan, coeffs, dt_map, valid, uv


def sweep_inputs(prep, cam, cfg: RenderConfig = RenderConfig(),
                 device=None):
    """The sweep's inputs for one view of a :func:`prepare_grid` result.

    Returns (plan, uv_pixel, (grid_sc, coeffs, enables, dt_map)): the plan
    and pixel base points for the warp, and the arguments of the sweep op
    in its (S, 4, Y, X) / (V, U) layouts.
    """
    _check_cfg(cfg)
    dev = resolve_device(device)
    axis = dominant_axis(cam)
    if axis not in prep:
        raise ValueError(
            f"camera sweeps axis {axis}, but prepare_grid was built for "
            f"axes {sorted(prep)}"
        )
    grid_sc, slice_max = (t.to(dev) for t in prep[axis])
    dtype = grid_sc.dtype
    plan, coeffs, dt_map, valid, uv = _frame_geometry(
        cam, _grid_shape_from_sweep(axis, tuple(grid_sc.shape)), axis,
        cfg.oversample, dtype, dev,
    )
    if cfg.use_occupancy:
        enables = (slice_max > 0.0).to(dtype)
        if plan.reverse:
            enables = enables.flip(0)
    else:
        enables = torch.ones(grid_sc.shape[0], dtype=dtype, device=dev)
    # Fly-through cameras: planes behind the eye are gated to zero.
    enables = enables * valid
    return plan, uv, (grid_sc, coeffs, enables, dt_map)


def render_prepared(
    prep,
    cam,
    cfg: RenderConfig = RenderConfig(),
    device=None,
):
    """Render one view from a :func:`prepare_grid` result.

    ``cfg.ert_chunks`` > 1 with ``cfg.early_stop_eps`` > 0 cuts the slice
    axis into that many slabs, a dead slab (every ray it can reach below
    eps) running with its steps disabled
    (:func:`~tpuvr_torch.ops.vjp.ert_chunked_sweep`).

    Returns:
      (rgb (res_y, res_x, 3), transmittance (res_y, res_x)).
    """
    with trace.request("render.frame"):
        with trace.span("tpuvr.render.plan"):
            plan, uv, args = sweep_inputs(prep, cam, cfg, device)
        with trace.span("tpuvr.render.sweep"):
            op = sweep_op(plan.reverse, cfg.sigma_scale, cfg.early_stop_eps,
                          resolve_impl("auto", args[0]), cfg.precision)
            rgb, trans = chunked_sweep(op, *args,
                                       max_rows=cfg.max_rows_per_call,
                                       ert_chunks=cfg.ert_chunks,
                                       reverse=plan.reverse,
                                       eps=cfg.early_stop_eps)
        with trace.span("tpuvr.render.warp"):
            inter = torch.cat([rgb, trans[None]], dim=0).permute(1, 2, 0)
            img = warp_to_pixels(inter, plan, uv)
    return img[..., :3], img[..., 3]


def render_view(
    grid,
    cam,
    cfg: RenderConfig = RenderConfig(),
    lighting: Optional[LightingConfig] = None,
    device=None,
):
    """Render one view of a (Z, Y, X, 4) voxel grid:
    ``render_prepared(prepare_grid(grid, axes=(axis,)), cam)``.

    ``cfg.mode='fixed_dt'`` marches each pixel's ray with a fixed step
    (``ref.march.render_fixed_dt``, after the lighting): the exact oracle,
    in plain PyTorch on the grid's device, slow and memory-hungry under
    autograd (every step's gather is kept). It ignores ``cfg.ert_chunks``,
    as the JAX package does.

    Returns:
      (rgb (res_y, res_x, 3), transmittance (res_y, res_x)).
    """
    _check_cfg(cfg, ("plane_sweep", "fixed_dt"))
    if cfg.mode == "fixed_dt":
        grid = torch.as_tensor(grid, device=resolve_device(device))
        if lighting is not None and lighting.mode != "none":
            from tpuvr_torch.ops.lighting import apply_lighting

            grid = apply_lighting(grid, lighting, cfg.precision)
        origins, dirs = camera_rays(cam, dtype=grid.dtype)
        return render_fixed_dt(grid, origins.to(grid.device),
                               dirs.to(grid.device), cfg)
    axis = dominant_axis(cam)
    prep = prepare_grid(grid, axes=(axis,), lighting=lighting,
                        precision=cfg.precision, device=device)
    return render_prepared(prep, cam, cfg, device=device)


def render_with_geom(
    grid,
    geom,
    axis: int,
    reverse: bool,
    cfg: RenderConfig = RenderConfig(),
    mesh=None,
    band: Optional[tuple] = None,
    device=None,
):
    """Render one view from its per-view geometry tensors: ``geom`` is the
    dict of :func:`~tpuvr_torch.ops.geometry.view_geometry` (which also
    gives ``axis`` and ``reverse``), the training path's form of a camera.
    ``band`` (its band bound) is accepted and unused: the port's kernels
    have no tiles. Differentiable with respect to ``grid``.

    With ``mesh`` (a :class:`~tpuvr_torch.dist.init.DataMesh`; every rank
    calls with the same arguments), rank r sweeps intermediate rows
    [r V/n, (r + 1) V/n) at their own positions (the sweep op's ``row0``;
    the JAX package shifts ``by`` instead, which moves a position by up to
    an ulp), the tiles are gathered on every rank, and each rank warps the
    whole image. The grid's gradient is then ``render_view_dp``'s: the
    one-process gradient on every rank. A ValueError, before any
    collective, when the ranks do not divide the rows, and for
    ``cfg.ert_chunks`` > 1 with ``cfg.early_stop_eps`` > 0 on a mesh.

    Returns (rgb (H, W, 3), transmittance (H, W)).
    """
    _check_cfg(cfg)
    dev = resolve_device(device)
    grid = torch.as_tensor(grid, device=dev)
    geom = {k: torch.as_tensor(v, device=dev) for k, v in geom.items()}
    dt_map = geom["dt"]
    r0, rows = 0, dt_map.shape[0]
    if mesh is not None:
        if rows % mesh.world:
            raise ValueError(f"intermediate rows {rows} not divisible by "
                             f"mesh size {mesh.world}")
        if cfg.ert_chunks > 1 and cfg.early_stop_eps > 0.0:
            raise ValueError(f"render_with_geom does not cut a rank's row "
                             f"tile into slabs: ert_chunks "
                             f"{cfg.ert_chunks} needs mesh=None")
        rows //= mesh.world
        r0 = mesh.rank * rows
        grid = replicated(grid, mesh)
    grid_sc = grid_to_sweep_layout(grid, axis)
    enables = slice_enables(grid_sc, reverse, cfg.use_occupancy)
    if "valid" in geom:
        enables = enables * geom["valid"]
    op = sweep_op(reverse, cfg.sigma_scale, cfg.early_stop_eps,
                  resolve_impl(None, grid_sc), cfg.precision, row0=r0)
    rgb, trans = chunked_sweep(op, grid_sc, tuple(geom["coeffs"]), enables,
                               dt_map[r0:r0 + rows],
                               max_rows=cfg.max_rows_per_call,
                               ert_chunks=cfg.ert_chunks, reverse=reverse,
                               eps=cfg.early_stop_eps)
    inter = torch.cat([rgb, trans[None]], dim=0)
    if mesh is not None:
        inter = gather_tiles(inter, mesh, 1)
    img = warp_to_pixels_dynamic(inter.permute(1, 2, 0), geom["lattice"],
                                 geom["uv"])
    return img[..., :3], img[..., 3]


def render(grid, cams, cfg: RenderConfig = RenderConfig(), **kw):
    """Render a list of views; returns stacked (N, H, W, 3) and (N, H, W)."""
    rgbs, ts = [], []
    for cam in cams:
        rgb, t = render_view(grid, cam, cfg, **kw)
        rgbs.append(rgb)
        ts.append(t)
    return torch.stack(rgbs), torch.stack(ts)
