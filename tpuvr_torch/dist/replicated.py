"""Replicated-grid data parallelism: rays sharded over the ranks.

The renderer's "batch" is rays (rows of the intermediate image) and its
"parameters" are the voxel grid. A rank's row tile of a view is the sweep
of those rows, each sampled where the whole image's row is (the sweep op's
``row0``), so sharding moves no ray data: every rank holds the grid,
sweeps its rows, and the tiles are gathered for the pixel warp.

Gradients (the contract of :mod:`tpuvr_torch.dist.init`: every rank takes
the same loss of the same image and differentiates it, all ranks running
the backward): the gradient of the ``grid`` a rank passed is the whole
grid's, summed over the mesh, equal on every rank and equal to
``render_view``'s. The gathered tiles' backward keeps the rank's own rows,
and the grid enters through :func:`~tpuvr_torch.dist.init.replicated`,
whose backward is one all-reduce of the grid's gradient (the JAX package's
``psum`` of the replicated capture). The trainer's mesh step stages its
own passes (``tpuvr_torch.train.fit``).
"""

from __future__ import annotations

import torch

from tpuvr_torch.config import RenderConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.dist.init import DataMesh, data_mesh, gather_tiles, replicated
from tpuvr_torch.ops.geometry import warp_to_pixels
from tpuvr_torch.ops.render import prepare_grid, sweep_inputs
from tpuvr_torch.ops.vjp import chunked_sweep, resolve_impl, sweep_op
from tpuvr_torch.ref.camera import dominant_axis

__all__ = ["DataMesh", "data_mesh", "render_view_dp"]


def render_view_dp(grid, cam, mesh: DataMesh,
                   cfg: RenderConfig = RenderConfig(), impl=None,
                   device=None):
    """Render with the intermediate image's rows sharded over the mesh:
    rank r sweeps rows [r V/n, (r + 1) V/n) against its copy of the grid,
    the tiles are gathered on every rank, and each rank warps the whole
    image to pixels. Every rank must call it with the same arguments.
    Differentiable with respect to the grid under the module's gradient
    contract: every rank gets ``render_view``'s gradient.

    Returns (rgb (H, W, 3), trans (H, W)) on every rank. Raises ValueError
    when the mesh's size does not divide the intermediate rows, and, before
    any collective, for ``cfg.ert_chunks`` > 1 with ``cfg.early_stop_eps``
    > 0: a rank's row tile does not cut its slices into slabs (the JAX
    package's ``render_view_dp`` drops the setting without a word).
    """
    if cfg.ert_chunks > 1 and cfg.early_stop_eps > 0.0:
        raise ValueError(f"render_view_dp does not cut the slices into "
                         f"slabs: ert_chunks {cfg.ert_chunks} needs "
                         f"render_view")
    axis = dominant_axis(cam)
    grid = replicated(torch.as_tensor(grid, device=resolve_device(device)),
                      mesh)
    prep = prepare_grid(grid, axes=(axis,), precision=cfg.precision,
                        device=device)
    plan, uv, (grid_sc, coeffs, enables, dt_map) = sweep_inputs(
        prep, cam, cfg, device)
    n_v = dt_map.shape[0]
    if n_v % mesh.world:
        raise ValueError(f"intermediate rows {n_v} not divisible by "
                         f"mesh size {mesh.world}")
    rows = n_v // mesh.world
    r0 = mesh.rank * rows
    op = sweep_op(plan.reverse, cfg.sigma_scale, cfg.early_stop_eps,
                  resolve_impl(impl, grid_sc), cfg.precision, row0=r0)
    rgb, trans = chunked_sweep(op, grid_sc, coeffs, enables,
                               dt_map[r0:r0 + rows],
                               max_rows=cfg.max_rows_per_call)
    inter = gather_tiles(torch.cat([rgb, trans[None]], dim=0), mesh, 1)
    img = warp_to_pixels(inter.permute(1, 2, 0), plan, uv)
    return img[..., :3], img[..., 3]
