"""Inverse rendering: recover a voxel grid from posed views.

``fit_grid`` runs Adam on the grid against the L2 image loss of posed
views, on one device or, with a mesh of ranks (one process per card,
``tpuvr_torch.dist``), with every view's rays row-sharded over the ranks:

- views are grouped by their sweep signature (axis, reverse) and the JAX
  package's banded tile class, as that package groups them; the per-view
  geometry is data (``tpuvr_torch.ops.geometry.view_geometry``), staged on
  the device once per group;
- each step renders a minibatch of one group's views through the
  differentiable sweep op: a minibatch of more than one view in one
  view-batched sweep (one forward and one backward kernel on the card),
  as the JAX package does, unless ``TPUVR_VIEW_BATCH=0`` (that package's
  switch) asks for the view-by-view loop. Each view is then warped to
  pixels and the grid is updated; groups rotate per step, or per block of
  ``steps_per_call`` steps;
- the pixel warp is the 4-tap gather, or with ``TPUVR_WARP=rows`` (that
  package's switch) the row-block warp of ``tpuvr_torch.ops.warp``,
  planned per view group, one kernel launch per view each way on the card;
- density is parameterized through softplus by default. In the fused mode
  the training state (params and Adam moments) stays in the current
  group's sweep layout and the kernels apply softplus per slice, so no
  softplus'd or transposed grid is materialized per step; the state is
  re-laid out when the group changes.

The minibatch draws follow the JAX package's ``fit_grid`` exactly (the
same groups, numpy generator and calls), so the two trainers see the same
views. Checkpoints (``tpuvr_torch.train.ckpt``) and metrics JSONL go to
the run directory. The host's phases are flat spans of
``tpuvr_torch.utils.trace`` (``tpuvr.fit.*``), each step a request
record.

On a mesh (``fit_grid(mesh=data_mesh())``, the JAX package's ``'data'``
mesh) every rank holds the whole grid and the same training state, sweeps
its row tile of every view of the minibatch, and the tiles are gathered so
that every rank warps the whole images and takes the same loss. Each rank
then backpropagates the loss through its own rows only, and the grid
gradient is summed over the ranks once: after the backward in
``grad_buckets`` all-reduces, slab by slab in stream order
(``bwd_chunks``), or through the ring backward (``grad_ring``, B11's
port).

On a ``('data', 'z')`` mesh (``fit_grid(mesh=grid_mesh(n_data, n_z))``,
the z-sharded grid) each rank holds one z slab of the parameters and of
both Adam moments, and :func:`make_train_step_zsharded` sweeps it over the
rank's row tile; the segments fold over ``'z'`` and only the slab's
gradient, summed over ``'data'``, reaches the rank. Its views must all
sweep the grid's z axis.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuvr_torch.config import RenderConfig, TrainConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.dist.init import (
    GridMesh,
    all_gather,
    all_reduce,
    all_to_all,
    bucketed_all_reduce,
    broadcast,
    exchange,
    gather_tiles,
)
from tpuvr_torch.dist.retile import fold_segments, retile_rows_to_slabs
from tpuvr_torch.dist.sharded_grid import fold_gathered
from tpuvr_torch.ops.geometry import (
    view_geometry,
    warp_to_pixels_band,
    warp_to_pixels_dynamic,
    warp_to_pixels_owned,
)
from tpuvr_torch.ops.render import (
    _check_cfg,
    grid_to_sweep_layout,
    prepare_grid,
    render_prepared,
    slice_enables,
    sweep_layout_to_grid,
)
from tpuvr_torch.ops.vjp import chunked_sweep, resolve_impl, sweep_op
from tpuvr_torch.ops.warp import (
    RowWarpPlan,
    lattice_positions,
    plan_row_warp,
    row_warp_image,
    row_warp_op,
)
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.ref.march import GRID_PERM
from tpuvr_torch.train.ckpt import Checkpointer
from tpuvr_torch.utils import trace
from tpuvr_torch.utils.metrics import MetricsLogger, psnr

log = logging.getLogger("tpuvr_torch")

_SOFTPLUS_INV_001 = float(np.log(np.expm1(0.01)))  # raw init -> sigma 0.01
_TILE = 128  # the JAX package's banded tile edge (band_tiles)


def params_to_grid(params, density_softplus: bool):
    """Map raw optimization parameters (Z, Y, X, 4) to the rendered grid."""
    if not density_softplus:
        return params
    sigma = torch.nn.functional.softplus(params[..., :1])
    return torch.cat([sigma, params[..., 1:]], dim=-1)


def init_params(grid_shape, density_softplus: bool, dtype=torch.float32,
                device=None):
    """Raw parameters: density 0.01 (through softplus) or 0, emission 0.5."""
    params = torch.zeros(grid_shape, dtype=dtype,
                         device=resolve_device(device))
    if density_softplus:
        params[..., 0] = _SOFTPLUS_INV_001
    params[..., 1:] = 0.5
    return params


# Adam with optax's rule (``optax.adam``): the state is (mu, nu, count).

def adam_init(params):
    return (torch.zeros_like(params), torch.zeros_like(params), 0)


def adam_update(grads, state, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """Returns (updates, new_state); apply with ``params + updates``.

    Moments are exponential averages, bias-corrected by 1 - b**count
    (formed in float64, then rounded to the moments' dtype), and the step
    is -lr * mu_hat / (sqrt(nu_hat) + eps)."""
    mu, nu, count = state
    mu = (1 - b1) * grads + b1 * mu
    nu = (1 - b2) * (grads * grads) + b2 * nu
    count = count + 1
    mu_hat = mu / float(np.float32(1 - b1**count))
    nu_hat = nu / float(np.float32(1 - b2**count))
    updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return updates, (mu, nu, count)


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` over plain tensors."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        return adam_init(params)

    def update(self, grads, state):
        return adam_update(grads, state, self.lr, self.b1, self.b2, self.eps)


def band_tiles(band, n_v, n_u, n_y, n_x):
    """A copy of the JAX package's banded tile class (``band_tiles`` in its
    ``kernels/sweep.py``): output-tile sizes (tile_v, tile_u) whose tap
    band fits a 128-wide window, or None (its dense kernels). It only
    mirrors that package's grouping of views: the port's kernels have no
    tiles, but :func:`group_views` keys on this class so that the two
    trainers draw the same minibatches.

    ``band`` is (max |ay|, max |ax|, ...) from ``view_geometry``; a 128
    tile takes slopes up to about 0.93, a 64 tile up to about 1.87.
    """
    if band is None:
        return None
    if n_y < _TILE or n_x < _TILE or n_y % 8 or n_x % 8:
        return None

    def pick(slope, n_out):
        for tile in (_TILE, _TILE // 2):
            if n_out % tile == 0 and slope <= (_TILE - 10) / (tile - 1):
                return tile
        return None

    tile_v = pick(band[0], n_v)
    tile_u = pick(band[1], n_u)
    if tile_v is None or tile_u is None:
        return None
    return tile_v, tile_u


def group_views(cams, grid_shape, rays_per_view: Optional[int] = None,
                n_shards: int = 1, oversample: float = 1.0):
    """Group cameras by sweep signature and stack their geometry (on the
    host), each view's at ``oversample`` (``RenderConfig.oversample``).

    Returns {(axis, reverse, tiles): (view_indices, stacked_geom, band,
    warp)} with ``band`` the group's (max |ay|, max |ax|, min |ay|,
    min |ax|). ``tiles`` is the JAX package's per-view banded tile class of
    the rows a step sweeps on one rank (the ``rays_per_view`` band, else
    every row, divided over ``n_shards`` row shards), () for its dense
    class: the port's kernels have no tiles, but keying on the class as the
    JAX package does gives both trainers the same groups, hence the same
    minibatches.

    ``warp`` is the group's :class:`~tpuvr_torch.ops.warp.RowWarpPlan` when
    ``TPUVR_WARP=rows`` and the planner finds one; the per-view window
    origins and tiled positions are then stacked into the geometry as
    ``rwvb`` (int32), ``rwy`` and ``rwx``. Otherwise None: the 4-tap gather
    (where the JAX package has its tiled or gather warp).
    """
    groups: Dict[Tuple[int, bool, tuple], Tuple[List, List, List]] = {}
    for i, cam in enumerate(cams):
        axis, reverse, geom, band = view_geometry(cam, grid_shape,
                                                  oversample=oversample)
        n_v, n_u = geom["dt"].shape
        dims_p = [grid_shape[d] for d in GRID_PERM[axis][:3]]
        rows = band_rows(rays_per_view, n_v, n_u, n_shards)
        v_swept = max((rows if rows is not None else n_v) // n_shards, 1)
        tiles = band_tiles(band, v_swept, n_u, dims_p[1], dims_p[2])
        idxs, geoms, bands = groups.setdefault((axis, reverse, tiles or ()),
                                               ([], [], []))
        idxs.append(i)
        geoms.append(geom)
        bands.append(band)
    rows_warp = os.environ.get("TPUVR_WARP") == "rows"
    out = {}
    for key, (idxs, geoms, bands) in groups.items():
        band = (max(b[0] for b in bands), max(b[1] for b in bands),
                min(b[2] for b in bands), min(b[3] for b in bands))
        plan = None
        if rows_warp:
            n_v, n_u = geoms[0]["dt"].shape
            planned = plan_row_warp(
                [lattice_positions(tuple(g["lattice"].numpy()),
                                   g["uv"].numpy(), n_v, n_u) for g in geoms],
                n_v, n_u)
            if planned is not None:
                plan, rvb, ry, rx = planned
                for g, vb, yy, xx in zip(geoms, rvb, ry, rx):
                    g.update(rwvb=torch.as_tensor(vb), rwy=torch.as_tensor(yy),
                             rwx=torch.as_tensor(xx))
        stacked = {k: torch.stack([g[k] for g in geoms]) for k in geoms[0]}
        out[key] = (idxs, stacked, band, plan)
    return out


def view_batch_eligible(k_views: int) -> bool:
    """Does a group's step march its minibatch in one view-batched sweep?
    Yes for more than one view, as in the JAX package, unless
    ``TPUVR_VIEW_BATCH=0`` (that package's switch back to the view loop)."""
    if k_views <= 1:
        return False
    return os.environ.get("TPUVR_VIEW_BATCH", "1") != "0"


def band_rows(rays_per_view: Optional[int], n_v: int, n_u: int,
              n_shards: int = 1) -> Optional[int]:
    """Row-band height for ``rays_per_view`` ray subsampling: about that
    many rays per view, rounded up to a multiple of 128 (8 when V is not a
    multiple of 128), and of ``n_shards`` so the band splits over the row
    shards; None means every row."""
    if rays_per_view is None:
        return None
    q = 128 if n_v % 128 == 0 else 8
    q = q * n_shards // math.gcd(q, n_shards)
    rows = -(-rays_per_view // n_u)
    rows = min(n_v, -(-rows // q) * q)
    return None if rows >= n_v else rows


def _slice_band(geom, r0s, rows: int):
    """Row-band view of stacked geometry: by shifted by r0 rows, dt cut to
    the band, per view."""
    coeffs = geom["coeffs"]  # (n_views, 4, S)
    r0 = torch.as_tensor(r0s, dtype=coeffs.dtype, device=coeffs.device)
    by = coeffs[:, 1] + r0[:, None] * coeffs[:, 0]
    coeffs = torch.stack([coeffs[:, 0], by, coeffs[:, 2], coeffs[:, 3]], 1)
    dt = torch.stack([d[int(r):int(r) + rows]
                      for d, r in zip(geom["dt"], r0s)])
    return dict(geom, coeffs=coeffs, dt=dt)


def make_train_step(
    key,
    n_views: int,
    opt,
    render_cfg: RenderConfig,
    density_softplus: bool,
    impl: Optional[str],
    rows: Optional[int] = None,
    kernel_softplus: bool = False,
    lighting=None,
    view_batch: bool = False,
    warp_tiling=None,
    mesh=None,
    grad_buckets: int = 4,
    bwd_chunks: int = 1,
    grad_ring: bool = False,
):
    """One train step for a view group (axis, reverse, ...), on one device
    or, with a ``mesh``, on every rank of it.

    Returns ``step(params, opt_state, geom_all, targets_all, pick, r0s) ->
    (params, opt_state, loss)``: ``pick`` (n_views,) indexes the group's
    stacked geometry and targets, ``r0s`` (n_views,) are the row-band
    offsets (used when ``rows`` is set). The loss is the mean over the
    views of each view's image MSE (over the band's pixels with ``rows``).

    ``view_batch`` (see :func:`view_batch_eligible`): march the whole
    minibatch through one view-batched sweep, its planes stacked along V,
    so the backward writes one summed grid gradient; the views are then
    warped and their losses summed in the same order as the view loop.
    ``kernel_softplus``: ``params`` are the raw parameters already in this
    group's (S, 4, Y, X) sweep layout, and the kernels apply softplus per
    slice (every slice is then occupied). ``lighting``: bake the sky light
    volume from the current density and multiply it into emission before
    the sweep (with ``lighting.detach=False`` the gradient flows through
    the shadows too). ``warp_tiling``: the group's ``RowWarpPlan`` from
    :func:`group_views`; without ``rows`` each view's channels-first
    (4, V, U) image then goes through the row-block warp (its geometry
    holds ``rwy``/``rwx``/``rwvb``), and the loss compares channels-first
    images. None (or with ``rows``) keeps the 4-tap gather.

    ``mesh`` (a :class:`~tpuvr_torch.dist.init.DataMesh`): every rank
    calls the step with the same arguments. Rank r sweeps rows
    [r V/n, (r + 1) V/n) of every view of the minibatch (of the band, with
    ``rows``), each ray sampled where the single-device step samples it
    (the sweep op's ``row0``); the tiles are gathered, every rank warps the whole images
    and takes the same loss, takes its gradient with respect to the
    images, and backpropagates only its own rows into its sweep. The grid
    gradient is then summed over the ranks: in ``grad_buckets``
    all-reduces after the backward; with ``bwd_chunks`` > 1 slab by slab
    inside the sweep's backward, in stream order; with ``grad_ring``
    through the ring backward over ``bwd_chunks`` slabs (at least 1), each
    slab's all-reduce overlapping the next slab's backward. Every rank
    returns the same loss and applies the same summed gradient.
    """
    axis, reverse = key[0], key[1]
    if isinstance(mesh, GridMesh):
        raise ValueError("a ('data', 'z') mesh trains through "
                         "make_train_step_zsharded")
    ringed = mesh is not None and grad_ring
    chunked = mesh is not None and bwd_chunks > 1 and not ringed
    lit = lighting is not None and lighting.mode != "none"
    if kernel_softplus and (lit or not density_softplus):
        raise ValueError("the fused mode (kernel_softplus) needs softplus "
                         "density and no lighting: the bake needs the "
                         "canonical grid")

    def forward(params, sweep):
        """``sweep(grid_sc, enables)`` of the grid the parameters give, in
        this group's sweep layout, and its slice enables: one forward span,
        or two around the lit step's bake."""
        if kernel_softplus:
            with trace.span("tpuvr.fit.forward"):
                return sweep(params, params.new_ones(params.shape[0]))
        with trace.span("tpuvr.fit.forward"):
            grid = params_to_grid(params, density_softplus)
            if not lit:
                return sweep(*sweep_grid(grid))
        from tpuvr_torch.ops.lighting import apply_lighting

        with trace.span("tpuvr.fit.bake"):
            grid = apply_lighting(grid, lighting, render_cfg.precision)
        with trace.span("tpuvr.fit.forward"):
            return sweep(*sweep_grid(grid))

    def sweep_grid(grid):
        grid_sc = grid_to_sweep_layout(grid, axis)
        return grid_sc, slice_enables(grid_sc, reverse,
                                      render_cfg.use_occupancy)

    row_plan = (warp_tiling if isinstance(warp_tiling, RowWarpPlan)
                and rows is None else None)

    def warp_loss(inter, geom_i, target, r0, row_op):
        """Pixel warp of a (V, U, 4) intermediate image, or a (4, V, U) one
        through ``row_op``, and its MSE."""
        if row_op is not None:
            out = row_op(inter, geom_i["rwy"], geom_i["rwx"], geom_i["rwvb"])
            img3 = row_warp_image(out[:3], row_plan)
            return torch.mean((img3 - target.permute(2, 0, 1)) ** 2)
        if rows is None:
            img = warp_to_pixels_dynamic(inter, geom_i["lattice"],
                                         geom_i["uv"])[..., :3]
            return torch.mean((img - target) ** 2)
        img, mask = warp_to_pixels_band(inter, geom_i["lattice"],
                                        geom_i["uv"], r0)
        err = torch.mean((img[..., :3] - target) ** 2, dim=-1)
        mask = mask.to(err.dtype)
        return torch.sum(err * mask) / torch.clamp_min(torch.sum(mask), 1.0)

    def inter_image(rgb, trans):
        inter = torch.cat([rgb, trans[None]], dim=0)
        return inter if row_plan is not None else inter.permute(1, 2, 0)

    def view_inters(op, grid_sc, enables, geom):
        """Every view's intermediate image ((4, V, U) for the row warp, else
        (V, U, 4)), one op call per view or, with ``view_batch``, one call
        for the stacked batch."""
        c = geom["coeffs"]  # (n_views, 4, S)
        en = enables[None, :] * geom["valid"]  # (n_views, S)
        dt = geom["dt"]  # (n_views, V, U)
        if not view_batch:
            return [inter_image(*op(grid_sc, tuple(c[i]), en[i], dt[i]))
                    for i in range(n_views)]
        rgb, trans = op(grid_sc, tuple(c.unbind(1)), en, dt.flatten(0, 1))
        v_pv = dt.shape[1]
        return [inter_image(r, t) for r, t in zip(rgb.split(v_pv, dim=1),
                                                  trans.split(v_pv))]

    def images_loss(inters, geom, targets, r0s, row_op):
        """The mean over the views of each view's warped image MSE."""
        total = 0.0
        for i, inter in enumerate(inters):
            geom_i = {k: v[i] for k, v in geom.items()}
            total = total + warp_loss(inter, geom_i, targets[i], r0s[i],
                                      row_op)
        return total / n_views

    def row_tile(geom):
        """This rank's rows [r V/n, (r + 1) V/n) of every view: (first row,
        row count)."""
        n_v = geom["dt"].shape[1]
        if n_v % mesh.world:
            raise ValueError(f"intermediate rows {n_v} not divisible by "
                             f"mesh size {mesh.world}")
        v_l = n_v // mesh.world
        return mesh.rank * v_l, v_l

    def tiles_of_rows(op, grid_sc, enables, geom, r_lo, v_l):
        """This rank's (n_views, 4, V / n, U) row tiles of the views'
        intermediate images, swept by an op made with ``row0=r_lo`` so that
        each ray samples where the whole image's does."""
        c = geom["coeffs"]  # (n_views, 4, S)
        en = enables[None, :] * geom["valid"]
        dt = geom["dt"][:, r_lo:r_lo + v_l]
        if not view_batch:
            return torch.stack([
                torch.cat([rgb, trans[None]], dim=0) for rgb, trans in (
                    op(grid_sc, tuple(c[i]), en[i], dt[i])
                    for i in range(n_views))])
        rgb, trans = op(grid_sc, tuple(c.unbind(1)), en, dt.flatten(0, 1))
        tiles = torch.cat([rgb, trans[None]], dim=0)
        return tiles.reshape(4, n_views, v_l, -1).transpose(0, 1)

    def mesh_loss_and_grads(op, row_op, p, geom, targets, r0s, r_lo, v_l):
        with torch.enable_grad():
            tiles = forward(p, lambda grid_sc, enables: tiles_of_rows(
                op, grid_sc, enables, geom, r_lo, v_l))
        with trace.span("tpuvr.fit.loss"):
            full = gather_tiles(tiles.detach(), mesh, 2).requires_grad_(True)
            with torch.enable_grad():
                inters = [x if row_plan is not None else x.permute(1, 2, 0)
                          for x in full.unbind(0)]
                loss = images_loss(inters, geom, targets, r0s, row_op)
        with trace.span("tpuvr.fit.backward"), torch.enable_grad():
            (d_full,) = torch.autograd.grad(loss, full)
            (grads,) = torch.autograd.grad(
                tiles, p, d_full.narrow(2, r_lo, tiles.shape[2]))
        if not (chunked or ringed):
            with trace.span("tpuvr.fit.reduce"):
                bucketed_all_reduce(grads, mesh, grad_buckets)
        return loss, grads

    def step(params, opt_state, geom_all, targets_all, pick, r0s):
        with trace.span("tpuvr.fit.gather"):
            pick_t = torch.as_tensor(np.asarray(pick), dtype=torch.long,
                                     device=params.device)
            geom = {k: v[pick_t] for k, v in geom_all.items()}
            targets = targets_all[pick_t]
            if rows is not None:
                geom = _slice_band(geom, r0s, rows)
            r_lo, v_l = (0, None) if mesh is None else row_tile(geom)
            op = sweep_op(reverse, render_cfg.sigma_scale,
                          render_cfg.early_stop_eps,
                          resolve_impl(impl, params), render_cfg.precision,
                          softplus=kernel_softplus,
                          views=n_views if view_batch else 1,
                          bwd_chunks=bwd_chunks if chunked else 1,
                          mesh=mesh if chunked else None,
                          ring=((mesh, mesh.world, max(bwd_chunks, 1))
                                if ringed else None), row0=r_lo)
            row_op = (None if row_plan is None else
                      row_warp_op(row_plan.f_v, resolve_impl(impl, params)))
            p = params.detach().requires_grad_(True)
        if mesh is not None:
            loss, grads = mesh_loss_and_grads(op, row_op, p, geom, targets,
                                              r0s, r_lo, v_l)
        else:
            with torch.enable_grad():
                inters = forward(p, lambda grid_sc, enables: view_inters(
                    op, grid_sc, enables, geom))
                with trace.span("tpuvr.fit.loss"):
                    loss = images_loss(inters, geom, targets, r0s, row_op)
                with trace.span("tpuvr.fit.backward"):
                    (grads,) = torch.autograd.grad(loss, p)
        with trace.span("tpuvr.fit.adam"):
            updates, opt_state = opt.update(grads, opt_state)
            return params + updates, opt_state, loss.detach()

    return step


def make_train_step_zsharded(
    key,
    n_views: int,
    opt,
    render_cfg: RenderConfig,
    density_softplus: bool,
    impl: Optional[str],
    mesh: GridMesh,
    rows: Optional[int] = None,
    grad_buckets: int = 4,
):
    """One train step of a view group on a ``('data', 'z')`` mesh, every
    rank holding its z slab of the raw (Z, Y, X, 4) parameters (the JAX
    package's ``make_train_step_zsharded``).

    Returns ``step(params_slab, opt_state, geom_all, targets_all, pick,
    r0s) -> (params_slab, opt_state, loss)``, the arguments as
    :func:`make_train_step`'s; every rank calls it with the same ones and
    gets the same loss, the mean over the views of each view's image MSE
    (over the band's pixels with ``rows``), as on one device.

    The views must sweep the grid's z axis (axis 2), so that the stored Z
    slab is the sweep slab (a ValueError otherwise). Rank (i, d) sweeps its
    slab over rows [i V / n_data, (i + 1) V / n_data) of each view, view by
    view, with early ray termination off; its slab covers traversal steps
    [k sz, (k + 1) sz), k = d, or n_z - 1 - d for a reverse group (the op
    runs with the group's ``reverse`` against the ascending-z slab).

    The loss, then its gradient, by staged autograd passes around the
    collectives, every rank issuing the same ones in the same order:

    - ``rows`` None (the retile): the segments are retiled over ``'z'``
      (one ``all_to_all``) and folded into the rank's row block b = r (rows
      [b V / n, (b + 1) V / n) of n = n_data n_z blocks), which takes block
      b + 1's first row as a halo over the flat ring (one ``exchange``; the
      last block gets zeros) and warps the pixels it owns
      (``warp_to_pixels_owned``): a disjoint masked partial MSE. Backward:
      the halo's cotangent goes back to block b + 1 (one ``exchange``), the
      fold's to the slabs (the reverse ``all_to_all``). The partial losses
      are summed over every rank (one all-reduce a step).
    - ``rows`` set (the band): the slabs' segments are gathered over
      ``'z'`` and folded, the data tiles gathered over ``'data'`` into the
      whole band, and every rank takes the band's loss; its cotangent,
      narrowed to the rank's data tile, goes back through the fold to the
      rank's own segment only.

    The slab's gradient is summed over ``'data'`` in ``grad_buckets``
    all-reduces; nothing crosses ``'z'`` after the folds.
    """
    axis, reverse = key[0], key[1]
    if axis != 2:
        raise ValueError(
            "z-sharded training requires cameras whose dominant sweep axis "
            f"is the grid z axis (got axis={axis}); render those views with "
            "the replicated data-parallel trainer instead")
    n_data, n_z = mesh.shape["data"], mesh.shape["z"]
    i, d, rank = mesh.data.rank, mesh.z.rank, mesh.rank
    halo_pairs = [(b, b - 1) for b in range(1, mesh.world)]
    back_pairs = [(b - 1, b) for b in range(1, mesh.world)]

    def retile_loss(seg, geom_v, target, n_v):
        """This rank's partial loss of one view and its cotangent with
        respect to ``seg`` (4, V / n_data, U)."""
        rows_sub = seg.shape[1] // n_z
        recv = retile_rows_to_slabs(seg, mesh.z).requires_grad_(True)
        with torch.enable_grad():
            color, trans = fold_segments(recv, reverse)
            inter = torch.cat([color, trans[None]]).permute(1, 2, 0)
        own = inter.detach().requires_grad_(True)
        halo = exchange(own.detach()[:1], halo_pairs,
                        mesh.flat).requires_grad_(True)
        with torch.enable_grad():
            img, mask = warp_to_pixels_owned(
                torch.cat([own, halo]), geom_v["lattice"], geom_v["uv"],
                rank * rows_sub, rows_sub, n_v)
            err = torch.mean((img[..., :3] - target) ** 2, dim=-1)
            part = torch.sum(err * mask.to(err.dtype)) / err.numel()
            d_own, d_halo = torch.autograd.grad(part / n_views, (own, halo))
        d_own[:1] += exchange(d_halo, back_pairs, mesh.flat)
        with torch.enable_grad():
            (d_recv,) = torch.autograd.grad(inter, recv, d_own)
        d_seg = all_to_all(d_recv, mesh.z)
        return part.detach(), d_seg.transpose(0, 1).reshape(seg.shape)

    def band_loss(seg, geom_v, target, r0):
        """The band's loss of one view (the same on every rank) and its
        cotangent with respect to this rank's ``seg``."""
        segs = list(all_gather(seg, mesh.z).unbind(0))
        own = seg.requires_grad_(True)
        with torch.enable_grad():
            segs[d] = own
            if reverse:  # rank order reverses traversal order
                segs = segs[::-1]
            color, trans = fold_gathered([x[:3] for x in segs],
                                         [x[3] for x in segs])
            tile = torch.cat([color, trans[None]])
        full = all_gather(tile.detach(), mesh.data)
        full = full.transpose(0, 1).flatten(1, 2).requires_grad_(True)
        with torch.enable_grad():
            img, mask = warp_to_pixels_band(full.permute(1, 2, 0),
                                            geom_v["lattice"], geom_v["uv"],
                                            r0)
            err = torch.mean((img[..., :3] - target) ** 2, dim=-1)
            mask = mask.to(err.dtype)
            loss_v = torch.sum(err * mask) / torch.clamp_min(torch.sum(mask),
                                                             1.0)
            (d_full,) = torch.autograd.grad(loss_v / n_views, full)
            v_l = tile.shape[1]
            (d_seg,) = torch.autograd.grad(
                tile, own, d_full.narrow(1, i * v_l, v_l))
        return loss_v.detach(), d_seg

    def step(params, opt_state, geom_all, targets_all, pick, r0s):
        pick_t = torch.as_tensor(np.asarray(pick), dtype=torch.long,
                                 device=params.device)
        geom = {k: v[pick_t] for k, v in geom_all.items()}
        targets = targets_all[pick_t]
        if rows is not None:
            geom = _slice_band(geom, r0s, rows)
        n_v = geom["dt"].shape[1]
        _check_zrows(n_v, mesh)
        v_l = n_v // n_data
        r_lo = i * v_l
        op = sweep_op(reverse, render_cfg.sigma_scale, 0.0,
                      resolve_impl(impl, params), render_cfg.precision,
                      row0=r_lo)
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            grid_sc = grid_to_sweep_layout(
                params_to_grid(p, density_softplus), axis)
            occ = slice_enables(grid_sc, reverse, render_cfg.use_occupancy)
        sz = grid_sc.shape[0]
        k0 = ((n_z - 1 - d) if reverse else d) * sz
        segs, d_segs, total = [], [], 0.0
        for v in range(n_views):
            geom_v = {k: t[v] for k, t in geom.items()}
            with torch.enable_grad():
                rgb, trans = op(grid_sc, tuple(geom_v["coeffs"][:, k0:k0 + sz]),
                                occ * geom_v["valid"][k0:k0 + sz],
                                geom_v["dt"][r_lo:r_lo + v_l])
                seg = torch.cat([rgb, trans[None]])
            if rows is None:
                loss_v, d_seg = retile_loss(seg.detach(), geom_v, targets[v],
                                            n_v)
            else:
                loss_v, d_seg = band_loss(seg.detach(), geom_v, targets[v],
                                          r0s[v])
            segs.append(seg)
            d_segs.append(d_seg)
            total = total + loss_v
        with torch.enable_grad():
            (grads,) = torch.autograd.grad(segs, p, d_segs)
        bucketed_all_reduce(grads, mesh.data, grad_buckets)
        loss = (total / n_views).reshape(1)
        if rows is None:  # disjoint partials: their sum is the loss
            all_reduce(loss, mesh.flat)
        updates, opt_state = opt.update(grads, opt_state)
        return params + updates, opt_state, loss[0]

    return step


def _check_zrows(n_v: int, mesh: GridMesh):
    """The intermediate (or band) rows must split over every rank of a
    ``('data', 'z')`` mesh: ValueError otherwise."""
    if n_v % mesh.world:
        raise ValueError(f"{n_v} rows not divisible by mesh "
                         f"{mesh.shape['data']}x{mesh.shape['z']}")


def _as_tensor(x):
    """A float32 tensor of numpy data or of a tensor on any device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=torch.float32)


def _relayout(params, opt_state, src, dst):
    """Move the training state between layouts: None is the canonical
    (Z, Y, X, 4), an axis that axis' (S, 4, Y, X) sweep layout."""
    if src == dst:
        return params, opt_state

    def cv(x):
        if not torch.is_tensor(x) or x.dim() != 4:
            return x  # Adam's count
        g = sweep_layout_to_grid(x, src) if src is not None else x
        return grid_to_sweep_layout(g, dst) if dst is not None else g

    return cv(params), tuple(cv(x) for x in opt_state)


def fit_grid(
    targets,
    cams,
    grid_shape,
    cfg: TrainConfig = TrainConfig(),
    render_cfg: RenderConfig = RenderConfig(),
    mesh=None,
    impl: Optional[str] = None,
    run_dir: Optional[str] = None,
    resume: bool = False,
    grad_buckets: int = 4,
    bwd_chunks: int = 1,
    grad_ring: bool = False,
    lighting=None,
    params_init=None,
    opt=None,
    fused: Optional[bool] = None,
    device=None,
):
    """Optimize a voxel grid to reproduce ``targets`` from ``cams``.

    Args:
      targets: (N, H, W, 3) posed view images (numpy or tensor).
      cams: list of N cameras.
      grid_shape: (Z, Y, X, 4) of the grid to recover.
      cfg/render_cfg: training and renderer configs. The views' lattices
        take ``render_cfg.oversample``, as the targets' renders do;
        ``render_cfg.mode`` 'fixed_dt' raises ValueError before any work
        or collective (the trainer sweeps planes; the JAX package's
        trainer drops both fields without a word).
      mesh: optional :class:`~tpuvr_torch.dist.init.DataMesh`
        (``tpuvr_torch.dist.data_mesh()``): ray data parallelism over its
        ranks, each of which calls ``fit_grid`` with the same arguments.
        The ranks start from rank 0's parameters; rank 0 alone writes
        metrics and checkpoints, and on ``resume`` rank 0's checkpoint
        decides the start step, the parameters and the optimizer state
        of every rank (the others need not see rank 0's ``run_dir``).
        Or a :class:`~tpuvr_torch.dist.init.GridMesh`
        (``tpuvr_torch.dist.grid_mesh(n_data, n_z)``): the z-sharded grid
        (:func:`make_train_step_zsharded`), rank (i, d) holding slab d of
        the parameters and of both Adam moments; views are grouped and
        banded over the n_data row shards, the fused mode is off, rank 0's
        start step and each slab's first ``'data'`` rank's state start
        every rank, that rank alone checkpoints its slab to
        ``run_dir/ckpt/z{d}`` (a resume restores each rank's own slab), and
        rank 0 writes the metrics. It refuses, with a ValueError before any
        collective, lighting, ``grad_ring``, ``bwd_chunks`` > 1,
        ``TPUVR_WARP=rows`` and ``fused=True`` (the JAX package drops the
        first four silently on such a mesh), views that do not sweep the
        z axis, a Z that the z ranks do not divide, and intermediate or band
        rows that the ranks do not divide.
      grad_buckets: MeshConfig.grad_buckets, the all-reduces the grid
        gradient is cut into after the backward.
      bwd_chunks: MeshConfig.bwd_chunks: > 1 cuts the backward into slabs
        and all-reduces each in stream order as it comes out.
      grad_ring: MeshConfig.grad_ring: the ring backward (B11's port),
        each slab's all-reduce overlapping the next slab's backward;
        ``bwd_chunks`` is its slab count. ``grad_ring`` and
        ``bwd_chunks`` > 1 need a mesh (ValueError without one).
      impl: sweep implementation, None for the device's ('cuda' on the
        card, 'torch' on the CPU); 'torch' on the card runs the plain
        twins, for comparison only.
      run_dir: metrics/checkpoint directory (default ``cfg.ckpt_dir``).
      resume: continue from the latest checkpoint in ``run_dir``.
      lighting: optional LightingConfig for lit inverse rendering; each
        step bakes the light volume from the current density (turns the
        fused mode off).
      params_init: optional (Z, Y, X, 4) raw-parameter warm start.
      opt: optimizer with ``init(params)`` and ``update(grads, state)``
        (default ``Adam(cfg.lr)``).
      fused: keep the state in sweep layout with the kernels' softplus;
        None chooses as the JAX package does: with softplus density, no
        lighting, ``TPUVR_FUSED_SOFTPLUS`` not "0" (that package's switch)
        and ``steps_per_call`` > 1 or a single view group.
      device: None for the card, or "cpu".

    Returns:
      (grid (rendered space), params, history) with ``history["loss"]``
      per step and ``history["step_ms"]``, the time from the end of one
      step to the end of the next (CUDA events on the card; the first
      entry runs from the start of the loop). On a mesh every rank
      returns the same history; on a ``GridMesh`` the grid and params
      are the rank's z slab (the JAX package returns one global sharded
      array; the port materialises the whole grid on no rank).
    """
    _check_cfg(render_cfg)
    zmesh = isinstance(mesh, GridMesh)
    if zmesh:
        _refuse_on_zmesh(grid_shape, mesh, lighting, grad_ring, bwd_chunks,
                         fused)
        fused = False
    elif mesh is None and (grad_ring or bwd_chunks > 1):
        raise ValueError("grad_ring and bwd_chunks > 1 reduce the gradient "
                         "over a mesh; pass mesh=")
    with trace.span("tpuvr.fit.plan"):
        dev = resolve_device(device)
        run_dir = run_dir or cfg.ckpt_dir
        main_rank = mesh is None or mesh.rank == 0
        metrics = MetricsLogger(run_dir if main_rank else None)
        opt = opt if opt is not None else Adam(cfg.lr)
        # On a z mesh: this rank's slab of Z, and its own checkpoint
        # directory.
        slab_shape, z_rows = tuple(grid_shape), slice(None)
        ckpt_dir, writer = f"{run_dir}/ckpt", main_rank
        if zmesh:
            sz = grid_shape[0] // mesh.shape["z"]
            slab_shape = (sz, *grid_shape[1:])
            z_rows = slice(mesh.z.rank * sz, (mesh.z.rank + 1) * sz)
            ckpt_dir = f"{ckpt_dir}/z{mesh.z.rank}"
            writer = mesh.data.rank == 0
        if params_init is not None:
            params = torch.as_tensor(params_init, dtype=torch.float32)[
                z_rows].to(dev, copy=True)
        else:
            params = init_params(slab_shape, cfg.density_softplus, device=dev)
        opt_state = opt.init(params)
        start_step = 0

        ckpt = Checkpointer(ckpt_dir) if cfg.ckpt_every else None
        if resume and ckpt is not None and ckpt.latest_step() is not None:
            step_no, state = ckpt.restore(
                {"params": params, "opt_state": opt_state})
            params, opt_state = state["params"], state["opt_state"]
            start_step = step_no + 1
            log.info("resumed from checkpoint at step %d", step_no)

        # Geometry is built on the host, then each group's stacked tensors
        # move to the device once.
        n_shards = 1 if mesh is None else mesh.shape["data"]
        groups = {
            k: (idxs, {n: t.to(dev) for n, t in stacked.items()}, band,
                plan)
            for k, (idxs, stacked, band, plan) in group_views(
                cams, grid_shape, rays_per_view=cfg.rays_per_view,
                n_shards=n_shards, oversample=render_cfg.oversample).items()
        }
        group_keys = sorted(groups)
        lit = lighting is not None and lighting.mode != "none"
        K = max(int(cfg.steps_per_call), 1)
        if fused is None:
            fused = (cfg.density_softplus and not lit
                     and os.environ.get("TPUVR_FUSED_SOFTPLUS", "1") != "0"
                     and (K > 1 or len(group_keys) == 1))
        steps_fns, rows_by_key = {}, {}
        for key in group_keys:
            idxs, stacked, _, plan = groups[key]
            n_v, n_u = stacked["dt"].shape[1], stacked["dt"].shape[2]
            rows = band_rows(cfg.rays_per_view, n_v, n_u, n_shards)
            rows_by_key[key] = (rows, n_v)
            k_views = min(cfg.views_per_batch, len(idxs))
            if zmesh:
                _check_zrows(rows or n_v, mesh)
                steps_fns[key] = make_train_step_zsharded(
                    key, k_views, opt, render_cfg, cfg.density_softplus,
                    impl, mesh, rows=rows, grad_buckets=grad_buckets)
                continue
            if (rows or n_v) % n_shards:
                raise ValueError(f"group {key}: intermediate rows "
                                 f"{rows or n_v} not divisible by mesh size "
                                 f"{n_shards}")
            steps_fns[key] = make_train_step(
                key, k_views, opt, render_cfg, cfg.density_softplus, impl,
                rows=rows, kernel_softplus=fused, lighting=lighting,
                view_batch=view_batch_eligible(k_views), warp_tiling=plan,
                mesh=mesh, grad_buckets=grad_buckets, bwd_chunks=bwd_chunks,
                grad_ring=grad_ring,
            )
        targets = _as_tensor(targets)
        targets_by_key = {
            k: targets[torch.as_tensor(groups[k][0],
                                       device=targets.device)].to(dev)
            for k in group_keys
        }

        if mesh is not None:  # after every check that can refuse the run
            params, opt_state, start_step = _start_from_rank0(
                params, opt_state, start_step, opt,
                *((mesh.flat, mesh.data) if zmesh else (mesh,)))
        rng = np.random.default_rng(cfg.seed + start_step)
    history = {"loss": [], "step_ms": []}
    pending = None  # (step numbers, key, device losses) awaiting readback

    def drain(rec):
        """Read a block's losses back and write their metrics lines."""
        step_is, key_i, losses = rec
        with trace.span("tpuvr.fit.drain", ("fit.step", step_is[-1])):
            for step_i, loss in zip(step_is, losses):
                history["loss"].append(float(loss))
                metrics.write(step_i, loss=float(loss), group=str(key_i))

    def draw(key, size=None):
        """View picks and row offsets, as the JAX package draws them."""
        idxs = groups[key][0]
        k_views = min(cfg.views_per_batch, len(idxs))
        shape = (k_views,) if size is None else (size, k_views)
        pick = np.stack([
            rng.choice(len(idxs), size=k_views, replace=False)
            for _ in range(size or 1)
        ]).reshape(shape)
        rows, n_v = rows_by_key[key]
        if rows is None:
            r0s = np.zeros(shape, np.int32)
        else:
            r0s = rng.integers(0, (n_v - rows) // 8 + 1,
                               size=shape).astype(np.int32) * 8
        return pick, r0s

    on_card = dev.type == "cuda"

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    marks = [mark()]
    step_no = start_step
    # A resumed run starts from the block its start_step falls in, so the
    # groups (and the generator's draws) come in the uninterrupted order.
    blk = start_step // K
    cur_layout = None  # fused mode: the axis whose layout the state is in
    while step_no < cfg.steps:
        req = ("fit.step", step_no)
        with trace.span("tpuvr.fit.draw", req):
            if K == 1:
                key = group_keys[step_no % len(group_keys)]
                n_done = 1
                picks, r0s_all = draw(key)
                picks, r0s_all = picks[None], r0s_all[None]
            else:
                key = group_keys[blk % len(group_keys)]
                n_done = min(K, cfg.steps - step_no)
                picks, r0s_all = draw(key, size=n_done)
                blk += 1
        if fused and cur_layout != key[0]:
            with trace.span("tpuvr.fit.relayout", req):
                params, opt_state = _relayout(params, opt_state, cur_layout,
                                              key[0])
            cur_layout = key[0]
        losses = []
        for j, (pick, r0s) in enumerate(zip(picks, r0s_all)):
            with trace.request("fit.step", step_no + j):
                params, opt_state, loss = steps_fns[key](
                    params, opt_state, groups[key][1], targets_by_key[key],
                    pick, r0s)
            losses.append(loss)
            marks.append(mark())
        # Read the previous block's losses back only now, so the host does
        # not wait on the device before queueing this block.
        if pending is not None:
            drain(pending)
        pending = (list(range(step_no, step_no + n_done)), key, losses)
        next_step = step_no + n_done
        if ckpt is not None and writer and (
                next_step % cfg.ckpt_every < n_done
                or next_step >= cfg.steps):
            with trace.span("tpuvr.fit.ckpt", ("fit.step", next_step - 1)):
                p_c, o_c = (_relayout(params, opt_state, cur_layout, None)
                            if fused else (params, opt_state))
                ckpt.save(next_step - 1, {"params": p_c, "opt_state": o_c},
                          cast_bf16=cfg.ckpt_bf16)
        step_no = next_step
    if pending is not None:
        drain(pending)
    if on_card:
        marks[-1].synchronize()
        history["step_ms"] = [a.elapsed_time(b)
                              for a, b in zip(marks, marks[1:])]
    else:
        history["step_ms"] = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    if fused and cur_layout is not None:
        with trace.span("tpuvr.fit.relayout", ("fit.step", step_no - 1)):
            params, opt_state = _relayout(params, opt_state, cur_layout, None)
    return params_to_grid(params, cfg.density_softplus), params, history


def _broadcast_tree(tree, mesh, device):
    """Rank 0's copy of a state tree: tensors broadcast in place, Python
    numbers through a one-element tensor."""
    if isinstance(tree, dict):
        return {k: _broadcast_tree(v, mesh, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_broadcast_tree(v, mesh, device) for v in tree)
    if torch.is_tensor(tree):
        return broadcast(tree.contiguous(), mesh)
    if isinstance(tree, (int, float)):
        t = torch.tensor([tree], dtype=torch.float64 if isinstance(
            tree, float) else torch.int64, device=device)
        return type(tree)(broadcast(t, mesh).item())
    return tree


def _start_from_rank0(params, opt_state, start_step, opt, mesh,
                      state_mesh=None):
    """Every rank of ``mesh`` starts where rank 0 does: rank 0's start step
    (its own run directory decides a resume; the ranks' hosts need not
    share one), its parameters, and, when it resumed, its optimizer
    state. A rank that restored a checkpoint rank 0 did not have starts
    from a fresh optimizer state, as rank 0 does. ``state_mesh`` (default
    ``mesh``): the ranks whose first rank's parameters and state a rank
    takes (a z slab's ``'data'`` ranks). Issues two broadcasts, and one
    per state tensor or number after a resume."""
    state_mesh = state_mesh or mesh
    head = torch.tensor([start_step], dtype=torch.int64, device=params.device)
    rank0_step = int(broadcast(head, mesh).item())
    broadcast(params, state_mesh)
    if rank0_step > 0:
        opt_state = _broadcast_tree(opt_state, state_mesh, params.device)
    elif start_step > 0:
        opt_state = opt.init(params)
    return params, opt_state, rank0_step


def _refuse_on_zmesh(grid_shape, mesh: GridMesh, lighting, grad_ring: bool,
                     bwd_chunks: int, fused: Optional[bool]):
    """What ``fit_grid`` cannot run on a ``('data', 'z')`` mesh raises
    ValueError, before any collective."""
    if lighting is not None and lighting.mode != "none":
        raise ValueError("lighting on a ('data', 'z') mesh: the light bake "
                         "needs the whole grid, and a rank holds one slab")
    if grad_ring or bwd_chunks > 1:
        raise ValueError("grad_ring and bwd_chunks > 1 reduce a replicated "
                         "grid's gradient; on a ('data', 'z') mesh each "
                         "slab's gradient is summed over 'data' only")
    if os.environ.get("TPUVR_WARP") == "rows":
        raise ValueError("TPUVR_WARP=rows on a ('data', 'z') mesh: the "
                         "z-sharded step warps the rows a rank owns with "
                         "the 4-tap gather")
    if fused:
        raise ValueError("the fused mode keeps the state in a group's sweep "
                         "layout; it is off on a ('data', 'z') mesh")
    if grid_shape[0] % mesh.shape["z"]:
        raise ValueError(f"grid Z={grid_shape[0]} not divisible by z-mesh "
                         f"{mesh.shape['z']}")


def render_all_views(grid, cams, render_cfg: RenderConfig = RenderConfig(),
                     lighting=None, device=None):
    """Render every camera: one ``prepare_grid`` (with the light bake) for
    all the views' sweep axes, then ``render_prepared`` per view. Returns
    (N, H, W, 3)."""
    dev = resolve_device(device)
    with torch.no_grad():
        grid = torch.as_tensor(grid, device=dev)
        axes = sorted({dominant_axis(cam) for cam in cams})
        prep = prepare_grid(grid, axes=axes, lighting=lighting,
                            precision=render_cfg.precision, device=dev)
        return torch.stack([render_prepared(prep, cam, render_cfg,
                                            device=dev)[0] for cam in cams])


def render_views_grouped(grid, cams, render_cfg: RenderConfig = RenderConfig(),
                         lighting=None, device=None):
    """Render every camera through the training path's per-view geometry:
    views grouped as :func:`group_views` groups them, one sweep op and one
    sweep-layout grid per group, and per view the row-block warp (under
    ``TPUVR_WARP=rows``, where the group has a plan) or the 4-tap gather.
    ``render_cfg.ert_chunks`` > 1 cuts each view's slices into slabs, as
    ``render_view`` does, and ``render_cfg.oversample`` sets each view's
    lattice (the JAX package's grouped render ignores both); a
    ``render_cfg.mode`` other than 'plane_sweep' raises ValueError.
    Returns (N, H, W, 3)."""
    _check_cfg(render_cfg)
    dev = resolve_device(device)
    with torch.no_grad():
        grid = torch.as_tensor(grid, device=dev)
        if lighting is not None and lighting.mode != "none":
            from tpuvr_torch.ops.lighting import apply_lighting

            grid = apply_lighting(grid, lighting, render_cfg.precision)
        out = [None] * len(cams)
        for key, (idxs, stacked, _, plan) in group_views(
                cams, tuple(grid.shape),
                oversample=render_cfg.oversample).items():
            axis, reverse = key[0], key[1]
            grid_sc = grid_to_sweep_layout(grid, axis)
            enables = slice_enables(grid_sc, reverse,
                                    render_cfg.use_occupancy)
            impl = resolve_impl(None, grid_sc)
            op = sweep_op(reverse, render_cfg.sigma_scale,
                          render_cfg.early_stop_eps, impl,
                          render_cfg.precision)
            row_op = None if plan is None else row_warp_op(plan.f_v, impl)
            stacked = {n: t.to(dev) for n, t in stacked.items()}
            for j, i in enumerate(idxs):
                g = {n: t[j] for n, t in stacked.items()}
                rgb, trans = chunked_sweep(
                    op, grid_sc, tuple(g["coeffs"]), enables * g["valid"],
                    g["dt"], ert_chunks=render_cfg.ert_chunks,
                    reverse=reverse, eps=render_cfg.early_stop_eps)
                inter = torch.cat([rgb, trans[None]], dim=0)
                if row_op is not None:
                    img = row_op(inter, g["rwy"], g["rwx"], g["rwvb"])
                    out[i] = row_warp_image(img[:3], plan).permute(1, 2, 0)
                else:
                    out[i] = warp_to_pixels_dynamic(
                        inter.permute(1, 2, 0), g["lattice"], g["uv"])[..., :3]
        return torch.stack(out)


def evaluate_psnr(grid, cams, targets, render_cfg: RenderConfig =
                  RenderConfig(), lighting=None, device=None):
    """PSNR (dB) of every view rendered from ``grid`` (through
    :func:`render_views_grouped`, as the JAX package renders it) against
    ``targets``."""
    preds = render_views_grouped(grid, cams, render_cfg, lighting, device)
    return float(psnr(preds, _as_tensor(targets).to(preds.device)))
