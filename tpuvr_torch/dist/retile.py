"""Ray re-tiling with ``all_to_all`` (the JAX package's
``tpuvr.dist.retile``, the Ulysses move with rays as the sequence and
grid slabs as the heads).

After the slab sweep a ``'z'`` rank holds its slab's segment over all its
rows. One ``all_to_all`` swaps "my slab x all rows" for "all slabs x my
row tile", and the rank folds its own 1/n_z of the rows front to back:
the same bytes a rank receives as the gathered fold, but the fold's state,
work and output are sharded.
"""

from __future__ import annotations

import torch

from tpuvr_torch.config import RenderConfig
from tpuvr_torch.dist.init import GridMesh, all_to_all
from tpuvr_torch.dist.sharded_grid import assemble, fold_gathered, slab_segment

__all__ = ["fold_segments", "fold_segments_retiled", "render_view_retiled",
           "retile_rows_to_slabs"]


def retile_rows_to_slabs(seg, mesh):
    """(C, rows, U) of my slab over all rows -> (n, C, rows / n, U): every
    slab's segment over my row tile, in rank (``'z'``) order; one
    :func:`~tpuvr_torch.dist.init.all_to_all` over ``mesh``."""
    n = mesh.world
    c, rows, n_u = seg.shape
    if rows % n:
        raise ValueError(f"{rows} local rows not divisible by z-mesh {n}")
    return all_to_all(seg.reshape(c, n, rows // n, n_u).transpose(0, 1),
                      mesh)


def fold_segments(segs, reverse: bool = False):
    """Fold (n, 4, rows, U) segments (rgb then T on dim 1) front to back,
    in rank order or, with ``reverse``, from the last rank to the first
    (rank order reverses traversal order for a reverse sweep). Returns
    (rgb (3, rows, U), trans (rows, U))."""
    if reverse:
        segs = segs.flip(0)
    return fold_gathered(segs[:, :3], segs[:, 3])


def fold_segments_retiled(rgb_d, t_d, mesh, reverse: bool = False):
    """Composite every ``'z'`` rank's segment ((3, V, U) / (V, U) over all
    V rows) into this rank's row tile: (rgb (3, V / n, U), trans
    (V / n, U)). ``reverse``: rank order is reversed traversal order."""
    segs = retile_rows_to_slabs(torch.cat([rgb_d, t_d[None]]), mesh)
    return fold_segments(segs, reverse)


def render_view_retiled(grid, cam, mesh: GridMesh,
                        cfg: RenderConfig = RenderConfig(), impl=None,
                        device=None):
    """:func:`~tpuvr_torch.dist.sharded_grid.render_view_zsharded` with the
    retiled fold: the same arguments, checks, result (rgb (H, W, 3),
    trans (H, W)) on every rank and gradient (the rank's slab's; the
    ``all_to_all`` is its own transpose). The render pre-flips a reverse
    plan's slabs, so rank order is traversal order here."""
    plan, uv, rgb_d, t_d = slab_segment(grid, cam, mesh, cfg, impl, device)
    color, trans = fold_segments_retiled(rgb_d, t_d, mesh.z)
    return assemble(color, trans, plan, uv, mesh)
