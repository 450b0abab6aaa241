"""Plain ray marchers, the oracles for every kernel, and the axis
permutation tables of the plane sweep.

Two discretizations of the same emission-absorption integral:

- :func:`render_fixed_dt`: the per-pixel march with a fixed step ``dt``
  along each ray; samples are trilinear gathers at arbitrary points.
- :func:`render_plane_sweep`: one sample where each ray crosses each
  integer plane of the sweep axis, so a step touches a single grid slice.
  This is the discretization of the sweep kernels.

Both are the JAX package's ``ref/march.py`` with each ``lax.scan`` a
Python loop, the steps' arithmetic in the same order, so that float64
results agree with it to roundoff. They run on the device of their
inputs and are differentiable with respect to the grid.

``GRID_PERM[axis]`` transposes the (Z, Y, X, C) grid so that the sweep
axis becomes dim 0; ``PT_PERM[axis]`` is the matching permutation of
(x, y, z) point and direction components. Every entry is an involution.
"""

from __future__ import annotations

import math

import torch

from tpuvr_torch.config import RenderConfig
from tpuvr_torch.ref.sample import trilinear

GRID_PERM = {0: (2, 1, 0, 3), 1: (1, 0, 2, 3), 2: (0, 1, 2, 3)}
PT_PERM = {0: (2, 1, 0), 1: (0, 2, 1), 2: (0, 1, 2)}


def permute_for_sweep(grid, origins, dirs, axis: int):
    """Rotate grid and rays so that the sweep axis is the leading grid
    dim."""
    pp = list(PT_PERM[axis])
    return grid.permute(GRID_PERM[axis]), origins[..., pp], dirs[..., pp]


def intersect_aabb(origins, dirs, lo, hi, eps: float = 1e-9):
    """Slab-method ray/AABB intersection.

    Returns (t_enter, t_exit) per ray; an empty intersection has
    t_enter > t_exit. A direction component below ``eps`` in magnitude
    takes ``1/eps`` (the rays, not the grid, see the division).
    """
    small = torch.abs(dirs) < eps
    inv = torch.where(small, torch.full_like(dirs, 1.0 / eps),
                      1.0 / torch.where(small, torch.ones_like(dirs), dirs))
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_near, t_far


def _relu(x):
    """``max(x, 0)`` with the JAX package's gradient (half at a tie)."""
    return torch.maximum(x, torch.zeros_like(x))


def render_fixed_dt(grid, origins, dirs, cfg: RenderConfig = RenderConfig()):
    """Fixed-step trilinear ray march (the reference-semantics oracle).

    Args:
      grid: (Z, Y, X, 4) voxel field, channels (sigma, r, g, b).
      origins/dirs: (..., 3) rays, (x, y, z) components; dirs need not be
        normalized: ``dt`` is measured in units of ``|dirs|``.
      cfg: ``step_dt``, ``max_steps``, ``tmin`` and ``sigma_scale``.

    Returns:
      (rgb (..., 3), transmittance (...,)).
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    dtype = grid.dtype
    z_dim, y_dim, x_dim = grid.shape[0], grid.shape[1], grid.shape[2]
    # The zero-padded trilinear field has support [-1, N] per axis; the
    # march covers all of it.
    lo = torch.full((3,), -1.0, dtype=dtype, device=grid.device)
    hi = torch.tensor([x_dim, y_dim, z_dim], dtype=dtype, device=grid.device)

    t_near, t_far = intersect_aabb(o, d, lo, hi)
    t_near = torch.clamp_min(t_near, cfg.tmin)

    dt = cfg.step_dt
    if cfg.max_steps is None:
        diag = math.sqrt((x_dim + 1) ** 2 + (y_dim + 1) ** 2
                         + (z_dim + 1) ** 2)
        n_steps = int(math.ceil(diag / dt)) + 1
    else:
        n_steps = cfg.max_steps

    color = torch.zeros((o.shape[0], 3), dtype=dtype, device=grid.device)
    trans = torch.ones((o.shape[0],), dtype=dtype, device=grid.device)
    steps = torch.arange(n_steps, dtype=dtype, device=grid.device)
    for i in steps:
        t = t_near + (i + 0.5) * dt
        valid = t < t_far
        s = trilinear(grid, o + d * t[:, None])
        # Density is rectified after interpolation: negative raw values,
        # which appear mid-optimization, are vacuum.
        sigma = _relu(s[:, 0]) * cfg.sigma_scale
        sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
        att = torch.exp(-sigma * dt)
        color = color + (trans * (1.0 - att))[:, None] * s[:, 1:4]
        trans = trans * att
    return color.reshape(*batch_shape, 3), trans.reshape(batch_shape)


def render_plane_sweep(grid, origins, dirs, axis: int = 2,
                       cfg: RenderConfig = RenderConfig()):
    """Plane-sweep trilinear march: one sample per integer-plane crossing.

    Args:
      grid: (Z, Y, X, 4) voxel field.
      origins/dirs: (..., 3) rays (x, y, z). A ray whose component along
        the sweep axis is (near) zero never crosses the planes: its dt
        blows up but every sample is masked out.
      axis: sweep axis, 0=x 1=y 2=z (``ref.camera.dominant_axis``).
      cfg: ``tmin`` and ``sigma_scale``.

    Returns:
      (rgb (..., 3), transmittance (...,)).
    """
    batch_shape = origins.shape[:-1]
    grid_p, o, d = permute_for_sweep(grid, origins.reshape(-1, 3),
                                     dirs.reshape(-1, 3), axis)
    dtype = grid.dtype
    n_planes = grid_p.shape[0]

    oz, dz = o[:, 2], d[:, 2]
    eps = torch.tensor(1e-12, dtype=dtype, device=grid.device)
    parallel = torch.abs(dz) < eps
    inv_dz = 1.0 / torch.where(parallel, eps, dz)
    dt = torch.abs(inv_dz)
    ascending = dz > 0

    color = torch.zeros((o.shape[0], 3), dtype=dtype, device=grid.device)
    trans = torch.ones((o.shape[0],), dtype=dtype, device=grid.device)
    ks = torch.arange(n_planes, device=grid.device)
    for k in ks:
        # Visit the planes front to back along each ray.
        k_eff = torch.where(ascending, k, n_planes - 1 - k).to(dtype)
        t = (k_eff - oz) * inv_dz
        valid = (t > cfg.tmin) & ~parallel
        px = o[:, 0] + d[:, 0] * t
        py = o[:, 1] + d[:, 1] * t
        s = trilinear(grid_p, torch.stack([px, py, k_eff], dim=-1))
        sigma = torch.where(valid, _relu(s[:, 0]) * cfg.sigma_scale,
                            torch.zeros_like(s[:, 0]))
        att = torch.exp(-sigma * dt)
        color = color + (trans * (1.0 - att))[:, None] * s[:, 1:4]
        trans = trans * att
    return color.reshape(*batch_shape, 3), trans.reshape(batch_shape)
