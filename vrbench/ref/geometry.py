"""Cameras and the plane-sweep factorisation, frozen for the reference.

The system under test renders a voxel grid by a plane sweep: every ray of
an intermediate lattice on the base plane of the sweep axis is sampled
where it crosses each integer plane of that axis (a separable resample per
slice), composited front to back, and the intermediate image is warped to
the pixels by a bilinear gather. The output is defined by that
factorisation, so the reference works the same plan out again here, in
float64 numpy, from the camera's numbers alone.

Vectors are (x, y, z) in grid space (voxel centres at integers); a grid
is (Z, Y, X, C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# Transposes that bring the sweep axis to dim 0 of a (Z, Y, X, C) grid,
# and the matching permutation of (x, y, z) components; each an involution.
GRID_PERM = {0: (2, 1, 0, 3), 1: (1, 0, 2, 3), 2: (0, 1, 2, 3)}
PT_PERM = {0: (2, 1, 0), 1: (0, 2, 1), 2: (0, 1, 2)}


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: ``eye``, view direction ``forward``, world up hint,
    vertical field of view ``fov_y`` (radians) and the resolution."""

    eye: Tuple[float, float, float]
    forward: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fov_y: float
    res_x: int
    res_y: int


def look_at(eye, target, res: int, fov_y_deg: float = 40.0,
            up=(0.0, 0.0, 1.0)) -> Camera:
    """A square camera at ``eye`` looking at ``target``."""
    fwd = tuple(float(t) - float(e) for e, t in zip(eye, target))
    return Camera(tuple(float(e) for e in eye), fwd, tuple(up),
                  math.radians(fov_y_deg), res, res)


def orbit(n_views: int, grid_n: int, res: int, elevation_deg: float,
          azimuth_deg: float = 0.0, distance_factor: float = 2.2,
          fov_y_deg: float = 40.0):
    """``n_views`` cameras evenly spaced on a circle around the grid centre
    at ``distance_factor * grid_n``, ``elevation_deg`` above it, the first
    at azimuth ``azimuth_deg``."""
    c = (grid_n - 1) / 2.0
    dist = distance_factor * grid_n
    elev = math.radians(elevation_deg)
    cams = []
    for i in range(n_views):
        az = 2.0 * math.pi * i / n_views + math.radians(azimuth_deg)
        eye = (c + dist * math.cos(az) * math.cos(elev),
               c + dist * math.sin(az) * math.cos(elev),
               c + dist * math.sin(elev))
        cams.append(look_at(eye, (c, c, c), res, fov_y_deg))
    return cams


def basis(forward, up):
    """Right-handed (right, up, forward) as float64 numpy; a forward
    parallel to the up hint takes the least aligned axis as its hint."""
    f = np.asarray(forward, dtype=np.float64)
    f = f / np.linalg.norm(f)
    u_hint = np.asarray(up, dtype=np.float64)
    r = np.cross(f, u_hint)
    if np.linalg.norm(r) < 1e-6:
        u_hint = np.eye(3)[int(np.argmin(np.abs(f)))]
        r = np.cross(f, u_hint)
    r = r / np.linalg.norm(r)
    return r, np.cross(r, f), f


def dominant_axis(cam: Camera) -> int:
    """The grid axis (0=x, 1=y, 2=z) most aligned with the view."""
    mags = [abs(float(c)) for c in cam.forward]
    return mags.index(max(mags))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One view's sweep: axis, plane count, traversal direction, the
    base-plane lattice (u0, du, v0, dv) of n_v x n_u rays, the permuted eye
    and the visible plane range."""

    axis: int
    n_planes: int
    reverse: bool
    lattice: Tuple[float, float, float, float]
    n_u: int
    n_v: int
    eye: Tuple[float, float, float]
    valid: Tuple[int, int]


def plan(cam: Camera, grid_shape):
    """The view's :class:`Plan` over a (Z, Y, X, C) grid, its lattice one
    ray a pixel (``RenderConfig.oversample`` 1), and each pixel's base-plane
    point (res_y, res_x, 2), float64."""
    axis = dominant_axis(cam)
    n_planes = grid_shape[GRID_PERM[axis][0]]
    pp = list(PT_PERM[axis])
    r, u, f = (v[pp] for v in basis(cam.forward, cam.up))
    pos = np.asarray(cam.eye, dtype=np.float64)[pp]
    if abs(f[2]) < 1e-6:
        raise ValueError("the view is parallel to the sweep planes")
    reverse = bool(f[2] < 0)
    jj = (np.arange(cam.res_x) + 0.5) / cam.res_x * 2.0 - 1.0
    ii = 1.0 - (np.arange(cam.res_y) + 0.5) / cam.res_y * 2.0
    uu, vv = np.meshgrid(jj, ii)
    t = np.tan(cam.fov_y * 0.5)
    d = (f + uu[..., None] * (t * cam.res_x / cam.res_y) * r
         + vv[..., None] * t * u)
    ez = float(pos[2])
    if abs(ez) < 1e-6:
        raise ValueError("the eye lies on the base plane")
    valid = (0, n_planes - 1)
    if 0.0 <= ez <= n_planes - 1:
        valid = ((int(math.floor(ez)) + 1, n_planes - 1) if not reverse
                 else (0, int(math.ceil(ez)) - 1))
    tt = -pos[2] / d[..., 2]
    base_u = pos[0] + d[..., 0] * tt
    base_v = pos[1] + d[..., 1] * tt
    n_u, n_v = cam.res_x, cam.res_y
    umin, umax = float(base_u.min()), float(base_u.max())
    vmin, vmax = float(base_v.min()), float(base_v.max())
    lattice = (umin, (umax - umin) / max(n_u - 1, 1),
               vmin, (vmax - vmin) / max(n_v - 1, 1))
    return (Plan(axis, n_planes, reverse, lattice, n_u, n_v,
                 (float(pos[0]), float(pos[1]), ez), valid),
            np.stack([base_u, base_v], axis=-1))


def coeffs(p: Plan, device=None):
    """Per-traversal-step (ay, by, ax, bx), four (S,) float32 tensors: step
    k samples row i at ``i*ay[k] + by[k]`` and column j at
    ``j*ax[k] + bx[k]``."""
    u0, du, v0, dv = p.lattice
    ex, ey, ez = p.eye
    planes = np.arange(p.n_planes, dtype=np.float64)
    if p.reverse:
        planes = planes[::-1]
    sp = 1.0 - planes / ez
    out = (dv * sp, v0 * sp + ey * (1.0 - sp), du * sp,
           u0 * sp + ex * (1.0 - sp))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                 device=device) for a in out)


def ray_dt(p: Plan, device=None):
    """(n_v, n_u) float32 path length per plane of each lattice ray."""
    u0, du, v0, dv = p.lattice
    ex, ey, ez = p.eye
    uu, vv = np.meshgrid(u0 + du * np.arange(p.n_u),
                         v0 + dv * np.arange(p.n_v))
    dt = np.sqrt((uu - ex) ** 2 + (vv - ey) ** 2 + ez * ez) / abs(ez)
    return torch.as_tensor(dt, dtype=torch.float32, device=device)


def visible(p: Plan, device=None):
    """(S,) float32 0/1 of the planes in front of the eye, traversal order."""
    planes = np.arange(p.n_planes)
    mask = ((planes >= p.valid[0]) & (planes <= p.valid[1])).astype(np.float32)
    if p.reverse:
        mask = mask[::-1].copy()
    return torch.as_tensor(mask, device=device)


@dataclasses.dataclass
class View:
    """Everything the reference needs to render one camera, on a device."""

    plan: Plan
    coeffs: tuple
    dt: torch.Tensor
    visible: torch.Tensor
    lattice: torch.Tensor
    uv: torch.Tensor


def view(cam: Camera, grid_shape, device=None) -> View:
    p, uv = plan(cam, grid_shape)
    return View(p, coeffs(p, device), ray_dt(p, device), visible(p, device),
                torch.as_tensor(p.lattice, dtype=torch.float32, device=device),
                torch.as_tensor(uv, dtype=torch.float32, device=device))


def sweep_layout(grid, axis: int):
    """(Z, Y, X, 4) -> contiguous (S, 4, Y', X') with the sweep axis first."""
    return grid.permute(GRID_PERM[axis]).permute(0, 3, 1, 2).contiguous()


def cam_fields(cam: Camera) -> dict:
    """The camera's numbers, for building the system's own camera."""
    return dict(eye=cam.eye, forward=cam.forward, up=cam.up, fov_y=cam.fov_y,
                res_x=cam.res_x, res_y=cam.res_y)
