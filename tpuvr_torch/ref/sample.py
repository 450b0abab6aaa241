"""Trilinear grid sampling and its transpose.

Conventions (those of the JAX package):
  - the voxel grid is ``grid[z, y, x, c]`` with channels
    ``c = (sigma, r, g, b)``;
  - voxel centres sit at integer coordinates; world space == grid space;
  - points are ``(x, y, z)`` vectors;
  - outside the slab ``[0, N_axis - 1]`` the field is vacuum: a corner
    beyond the grid contributes zero (zero padding), so interpolation
    decays linearly to 0 over the one-voxel margin.

``trilinear_scatter_add`` is the transpose of ``trilinear`` with respect to
the grid, the oracle for the sweep kernels' gradients. Both run on the
device of their inputs.
"""

from __future__ import annotations

import torch


def _corner_data(grid, pts):
    """Shared corner indices and weights for the trilinear gather and
    scatter.

    Args:
      grid: (Z, Y, X, C), or anything whose first three sizes are those.
      pts: (..., 3) sample points ordered (x, y, z).

    Returns:
      (idx_z, idx_y, idx_x, weights): lists of the 8 corners' index
      tensors per axis and weights (...,), in (dz, dy, dx) nested order; a
      corner out of range has weight 0 and an index clamped into range.
    """
    z_dim, y_dim, x_dim = grid.shape[0], grid.shape[1], grid.shape[2]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()

    idx_z, idx_y, idx_x, weights = [], [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                w = ((fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
                     * (fz if dz else 1.0 - fz))
                valid = ((ix >= 0) & (ix < x_dim) & (iy >= 0) & (iy < y_dim)
                         & (iz >= 0) & (iz < z_dim))
                weights.append(torch.where(valid, w, torch.zeros_like(w)))
                idx_x.append(ix.clamp(0, x_dim - 1))
                idx_y.append(iy.clamp(0, y_dim - 1))
                idx_z.append(iz.clamp(0, z_dim - 1))
    return idx_z, idx_y, idx_x, weights


def trilinear(grid, pts):
    """Trilinear interpolation of ``grid`` at points ``pts``.

    Args:
      grid: (Z, Y, X, C) voxel field.
      pts: (..., 3) points ordered (x, y, z) in grid space.

    Returns:
      (..., C) interpolated values; zero outside the grid. The 8 corners
      are summed in a fixed order, so that the float64 result equals the
      JAX package's to roundoff.
    """
    idx_z, idx_y, idx_x, weights = _corner_data(grid, pts)
    out = 0.0
    for iz, iy, ix, w in zip(idx_z, idx_y, idx_x, weights):
        out = out + w[..., None] * grid[iz, iy, ix]
    return out


def trilinear_scatter_add(grid_shape, pts, values, dtype=torch.float32):
    """Transpose of :func:`trilinear`: scatter ``values`` into a zero grid
    (on the device of ``pts``); equal to the gradient of ``trilinear``
    with respect to the grid.

    Args:
      grid_shape: (Z, Y, X, C).
      pts: (..., 3) points (x, y, z).
      values: (..., C) cotangents at each point.

    Returns:
      (Z, Y, X, C) accumulated gradient grid.
    """
    grid = torch.zeros(grid_shape, dtype=dtype, device=pts.device)
    idx_z, idx_y, idx_x, weights = _corner_data(grid, pts)
    for iz, iy, ix, w in zip(idx_z, idx_y, idx_x, weights):
        grid.index_put_((iz, iy, ix), (w[..., None] * values).to(dtype),
                        accumulate=True)
    return grid
