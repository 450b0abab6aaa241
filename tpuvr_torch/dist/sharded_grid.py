"""The z-sharded grid: slab sharding and segment folds (the JAX package's
``tpuvr.dist.sharded_grid``).

When the grid outgrows one card it is cut along the sweep axis: on a
:class:`~tpuvr_torch.dist.init.GridMesh`, rank (i, d) owns slab d, the
d-th contiguous run of slices in traversal order, and sweeps it over its
data row tile i of intermediate rays into a ray segment (C_d, T_d).
Segments fold front to back with the associative composite
``(C1, T1) + (C2, T2) = (C1 + T1 C2, T1 T2)``. A plane-sweep sample
touches one slice, so slabs need no halo. Early ray termination is off (a
slab cannot see the transmittance in front of it); occupancy is taken per
slab.

Folds over the ``'z'`` ranks, each leaving a rank its 1/n_z row tile of
the composite:

- ``fold="all_gather"``: gather every slab's segment and fold locally;
- ``fold="ring"``: the ordered ring reduce-scatter
  (:func:`ring_compose_rs`), n_z - 1 hops of one tile's two-sided partial;
- the retile (``tpuvr_torch.dist.retile``): one ``all_to_all``, then a
  local fold of the rank's rows.

The render follows :func:`~tpuvr_torch.dist.replicated.render_view_dp`'s
convention: every rank passes the whole grid, keeps only its slab of the
sweep layout, and gets back the whole image (the tiles gathered over every
rank in rank order, the JAX package's ``P(('data', 'z'))`` out-sharding).
A rank sweeps its rows with the sweep op's ``row0``, where the JAX package
shifts ``by`` by ``row_off * ay``.

Gradients (the contract of :mod:`tpuvr_torch.dist.init`: every rank takes
the same loss of the same image and differentiates it, all ranks running
the backward): the gradient of the ``grid`` a rank passed is its z slab's
gradient, summed over its ``'data'`` ranks, in the slab's place in the
grid, and zeros elsewhere. Summed over the ``'z'`` ranks these give
``render_view``'s gradient. The gathered tiles' backward keeps the rank's
own tile; the folds' collectives run transposed (the gathered fold's
``all_gather`` as a reduce-scatter, the ring's exchanges over the reversed
pairs, the retile's ``all_to_all`` as itself); the slab enters the sweep
through :func:`~tpuvr_torch.dist.init.replicated` over ``'data'`` (one
all-reduce of the slab's gradient where n_data > 1). Nothing crosses
``'z'`` after the folds (the JAX package's "grid gradients stay sharded
over 'z'"), so no rank gathers the whole gradient. Occupancy and the
visibility mask carry no gradient. A grid that needs no gradient renders
with the same launches, collectives and bits as a forward-only call.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuvr_torch.config import RenderConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.dist.init import (
    GridMesh,
    all_gather,
    exchange,
    gather_tiles,
    replicated,
)
from tpuvr_torch.ops.geometry import warp_to_pixels
from tpuvr_torch.ops.render import _check_cfg, _frame_geometry
from tpuvr_torch.ops.vjp import resolve_impl, sweep_op
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.ref.march import GRID_PERM

__all__ = ["fold_gathered", "ring_compose_rs", "render_view_zsharded",
           "row_tile"]


def fold_gathered(c_segs, t_segs):
    """Front-to-back fold of (n, 3, V, U) / (n, V, U) segment stacks (or
    sequences), first to last."""
    color, trans = c_segs[0], t_segs[0]
    for c, t in zip(c_segs[1:], t_segs[1:]):
        color = color + trans[None] * c
        trans = trans * t
    return color, trans


def row_tile(color, trans, idx: int, r: int):
    """Rows [idx r, idx r + r) of a (3, V, U) / (V, U) pair."""
    return color[:, idx * r:(idx + 1) * r], trans[idx * r:(idx + 1) * r]


def ring_compose_rs(rgb_d, t_d, mesh):
    """Ordered ring reduce-scatter of ray segments over ``mesh`` (the
    ``'z'`` ranks, in traversal order): rank d's (3, V, U) / (V, U) segment
    covers every row, and rank d gets its 1/n row tile of the whole fold.

    Tile c's partial starts at rank c + 1 and travels the ring, each rank
    folding its segment in. The fold is associative but not commutative, so
    the partial is a (left, right) pair split at the ring's seam: ranks
    after the tile (c + 1 .. n - 1) extend the right fold, ranks from 0 to
    c, reached after the wrap, the left; the tile is L + R. Per hop a rank
    sends one (8, V / n, U) pair to the next (one :func:`exchange`); the
    backward sends its cotangent one hop back, hop by hop in reverse.
    """
    n, idx = mesh.world, mesh.rank
    rows = t_d.shape[0]
    if rows % n:
        raise ValueError(f"{rows} local rows not divisible by ring size {n}")
    if n == 1:
        return rgb_d, t_d
    r = rows // n
    sc, st = row_tile(rgb_d, t_d, (idx - 1) % n, r)
    zc, ot = torch.zeros_like(sc), torch.ones_like(st)
    # Rank 0 starts tile n - 1 after the seam (left), the others before it.
    left, right = ((sc, st), (zc, ot)) if idx == 0 else ((zc, ot), (sc, st))
    perm = [(i, (i + 1) % n) for i in range(n)]
    for s in range(n - 1):
        packed = torch.cat([left[0], left[1][None], right[0], right[1][None]])
        packed = exchange(packed, perm, mesh)
        left = (packed[:3], packed[3])
        right = (packed[4:7], packed[7])
        c = (idx - 2 - s) % n
        sc, st = row_tile(rgb_d, t_d, c, r)
        if idx > c:  # before the seam in traversal order: extend R
            right = (right[0] + right[1][None] * sc, right[1] * st)
        else:
            left = (left[0] + left[1][None] * sc, left[1] * st)
    return left[0] + left[1][None] * right[0], left[1] * right[1]


def check_zmesh(plan, mesh: GridMesh):
    """The JAX package's divisibility refusals: the slices over ``'z'``, the
    intermediate rows over every rank."""
    n_data, n_z = mesh.shape["data"], mesh.shape["z"]
    if plan.n_planes % n_z:
        raise ValueError(f"{plan.n_planes} slices not divisible by z-mesh "
                         f"{n_z}")
    if plan.n_v % (n_data * n_z):
        raise ValueError(f"{plan.n_v} rows not divisible by mesh "
                         f"{n_data}x{n_z}")


def slab_inputs(grid, cam, mesh: GridMesh, cfg: RenderConfig, device):
    """This rank's sweep inputs: its traversal slab of the sweep layout
    (flipped first under a reverse plan, so the sweep runs forward) and,
    for its data row tile, the slab's coefficients, enables and ray dt.
    Runs no collective. Returns (plan, uv_pixel, (slab (sz, 4, Y', X'),
    coeffs, enables (sz,), dt (V / n_data, U)), the tile's first row)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    grid = torch.as_tensor(grid, device=dev)
    axis = dominant_axis(cam)
    # The camera's plan and geometry, cached across frames as the
    # single-card frame loop caches them.
    plan, coeffs, dt_map, valid, uv_pixel = _frame_geometry(
        cam, tuple(grid.shape), axis, cfg.oversample, grid.dtype, dev)
    check_zmesh(plan, mesh)
    n_z = mesh.shape["z"]
    d, i = mesh.z.rank, mesh.data.rank
    sz = plan.n_planes // n_z
    rows = plan.n_v // mesh.shape["data"]
    # Traversal steps [d sz, (d + 1) sz): those layout slices, taken from
    # the grid before the copy, so no rank holds the whole layout.
    lo = plan.n_planes - (d + 1) * sz if plan.reverse else d * sz
    slab = grid.permute(GRID_PERM[axis])[lo:lo + sz].permute(0, 3, 1, 2)
    slab = (slab.flip(0) if plan.reverse else slab).contiguous()
    steps = slice(d * sz, (d + 1) * sz)
    enables = valid[steps]
    if cfg.use_occupancy:
        enables = enables * (torch.amax(slab[:, 0].detach(), dim=(1, 2))
                             > 0.0).to(slab.dtype)
    return plan, uv_pixel, (slab, tuple(c[steps] for c in coeffs), enables,
                            dt_map[i * rows:(i + 1) * rows]), i * rows


def slab_segment(grid, cam, mesh: GridMesh, cfg: RenderConfig, impl, device):
    """This rank's ray segment: the sweep of :func:`slab_inputs`, early ray
    termination off, the slab shared by the ``'data'`` ranks
    (:func:`~tpuvr_torch.dist.init.replicated`). Returns (plan, uv_pixel,
    rgb_d (3, V / n_data, U), t_d (V / n_data, U))."""
    cfg = dataclasses.replace(cfg, early_stop_eps=0.0)
    plan, uv_pixel, (slab, coeffs, enables, dt), row0 = slab_inputs(
        grid, cam, mesh, cfg, device)
    op = sweep_op(False, cfg.sigma_scale, 0.0, resolve_impl(impl, slab),
                  cfg.precision, row0=row0)
    rgb_d, t_d = op(replicated(slab, mesh.data), coeffs, enables, dt)
    return plan, uv_pixel, rgb_d, t_d


def assemble(color, trans, plan, uv_pixel, mesh: GridMesh):
    """Every rank's row tile (rank r holds rows [r V / n, (r + 1) V / n)),
    gathered in rank order and warped to pixels: (rgb (H, W, 3), trans
    (H, W)) on every rank."""
    tile = torch.cat([color, trans[None]], dim=0)
    inter = gather_tiles(tile, mesh.flat, 1)
    img = warp_to_pixels(inter.permute(1, 2, 0), plan, uv_pixel)
    return img[..., :3], img[..., 3]


def render_view_zsharded(grid, cam, mesh: GridMesh,
                         cfg: RenderConfig = RenderConfig(), impl=None,
                         device=None, fold: str = "all_gather"):
    """Render with the grid slab-sharded over ``'z'`` and the rays
    row-sharded over ``'data'``; the segments fold over ``'z'`` with
    ``fold`` ("all_gather" or "ring"). Every rank calls it with the same
    arguments and the whole grid. Differentiable with respect to the grid
    under the module's gradient contract: a rank's gradient is its slab's,
    zeros elsewhere.

    Returns (rgb (H, W, 3), trans (H, W)) on every rank. Raises ValueError
    when the slices do not split over ``'z'`` or the intermediate rows over
    every rank.
    """
    if fold not in ("all_gather", "ring"):
        raise ValueError(f"unknown fold: {fold}")
    plan, uv, rgb_d, t_d = slab_segment(grid, cam, mesh, cfg, impl, device)
    if fold == "ring":
        color, trans = ring_compose_rs(rgb_d, t_d, mesh.z)
    else:
        segs = all_gather(torch.cat([rgb_d, t_d[None]]), mesh.z)
        color, trans = fold_gathered(segs[:, :3], segs[:, 3])
        color, trans = row_tile(color, trans, mesh.z.rank,
                                t_d.shape[0] // mesh.shape["z"])
    return assemble(color, trans, plan, uv, mesh)
