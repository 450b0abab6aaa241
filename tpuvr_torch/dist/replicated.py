"""Replicated-grid data parallelism: rays sharded over the ranks.

The renderer's "batch" is rays (rows of the intermediate image) and its
"parameters" are the voxel grid. A rank's row tile of a view is the sweep
of those rows, each sampled where the whole image's row is (the sweep op's
``row0``), so sharding moves no ray data: every rank holds the grid,
sweeps its rows, and the tiles are gathered for the pixel warp. Gradients with respect to the replicated grid
are summed over the ranks (see ``tpuvr_torch.train.fit``).
"""

from __future__ import annotations

import torch

from tpuvr_torch.config import RenderConfig
from tpuvr_torch.dist.init import DataMesh, data_mesh, gather_tiles
from tpuvr_torch.ops.geometry import warp_to_pixels
from tpuvr_torch.ops.render import prepare_grid, sweep_inputs
from tpuvr_torch.ops.vjp import chunked_sweep, resolve_impl, sweep_op
from tpuvr_torch.ref.camera import dominant_axis

__all__ = ["DataMesh", "data_mesh", "render_view_dp"]


def render_view_dp(grid, cam, mesh: DataMesh,
                   cfg: RenderConfig = RenderConfig(), impl=None,
                   device=None):
    """Forward render with the intermediate image's rows sharded over the
    mesh: rank r sweeps rows [r V/n, (r + 1) V/n) against its copy of the
    grid, the tiles are gathered on every rank, and each rank warps the
    whole image to pixels. Every rank must call it with the same
    arguments.

    Returns (rgb (H, W, 3), trans (H, W)) on every rank. Raises ValueError
    when the mesh's size does not divide the intermediate rows.
    """
    axis = dominant_axis(cam)
    with torch.no_grad():
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
