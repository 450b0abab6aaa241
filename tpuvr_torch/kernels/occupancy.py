"""Coarse occupancy for empty-space skipping: plain reductions.

A brick field holds the maximum density of each brick of voxels; each
sweep slice inherits its brick layer's maximum as an enable. Skipping is
lossless: a slice is skipped only where the maximum density is <= 0, and
rectified density then contributes nothing. (The render path's own
per-slice skip, ``ops.render.slice_enables``, takes each slice's maximum
directly.)
"""

from __future__ import annotations

import torch


def build_occupancy(grid, brick: int = 8):
    """Max-pool the density channel into bricks.

    Args:
      grid: (Z, Y, X, 4) voxel field (or (Z, Y, X) density).
      brick: pooling edge (voxels); the dims need not divide evenly (edge
        bricks pool the remainder).

    Returns:
      (ceil(Z/b), ceil(Y/b), ceil(X/b)) max-density field.
    """
    sigma = grid[..., 0] if grid.dim() == 4 else grid
    z, y, x = sigma.shape
    pads = [(-d) % brick for d in (z, y, x)]
    sigma = torch.nn.functional.pad(sigma, (0, pads[2], 0, pads[1], 0,
                                            pads[0]), value=-torch.inf)
    bz, by, bx = (d // brick for d in sigma.shape)
    return sigma.reshape(bz, brick, by, brick, bx, brick).amax(dim=(1, 3, 5))


def slice_enables_from_occupancy(occ, n_slices: int, brick: int,
                                 reverse: bool, dtype=torch.float32):
    """Per-slice 0/1 enables (in traversal order) from a brick field pooled
    over the *sweep-permuted* grid (dim 0 = sweep axis); no gradient."""
    layer_max = torch.amax(occ.detach(), dim=(1, 2))
    idx = torch.arange(n_slices, device=occ.device) // brick
    enables = (layer_max[idx] > 0.0).to(dtype)
    return enables.flip(0) if reverse else enables


def occupancy_fraction(occ) -> torch.Tensor:
    """Fraction of bricks that hold density (a diagnostic of skip gains)."""
    return torch.mean((occ > 0.0).to(torch.float32))
