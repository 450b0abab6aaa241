"""Sweep geometry: factor a camera into per-slice separable resamples.

In the permuted grid space (sweep axis -> dim 0) every ray is named by
its intersection (u, v) with the base plane, and the sample position on
plane p is affine in the lattice index for both camera models:

  orthographic:  pos_x(j, p) = u_j + p * dx/dz            (translation)
  perspective:   pos_x(j, p) = u_j * s_p + ex * (1 - s_p) (scale+translate)
                 with s_p = 1 - p/ez   (eye at (ex, ey, ez))

Planning is host-side float64 numpy (cameras are static) and hands
tensors to the sweep. When the pixel -> base-plane map is not a regular
separable lattice, a final bilinear warp (:func:`warp_to_pixels`, a
4-tap gather) resamples the intermediate image to pixels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpuvr_torch.ref.camera import OrthoCamera, PerspectiveCamera, _basis
from tpuvr_torch.ref.march import GRID_PERM, PT_PERM


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static description of a sweep render.

    Attributes:
      axis: sweep axis in (x=0, y=1, z=2).
      n_planes: number of planes (grid extent along axis).
      reverse: True if rays traverse planes in decreasing index order.
      lattice: (u0, du, v0, dv) base-plane lattice.
      n_u/n_v: intermediate image resolution.
      separable: True if the intermediate lattice equals the pixel grid.
      ortho: True for orthographic cameras.
      cam_params: ortho: (sx, sy) plane shear per unit plane index;
        perspective: permuted eye (ex, ey, ez).
      valid: (first, last) inclusive visible plane range; narrower than
        the slab only for a perspective eye inside it (fly-through).
    """

    axis: int
    n_planes: int
    reverse: bool
    lattice: Tuple[float, float, float, float]
    n_u: int
    n_v: int
    separable: bool
    ortho: bool
    cam_params: Tuple[float, ...]
    valid: Tuple[int, int] = (0, -1)


def _permuted_camera(cam, axis: int):
    """Camera basis and position with (x, y, z) permuted for the sweep."""
    pp = list(PT_PERM[axis])
    r, u, f = _basis(cam.forward, cam.up)
    r, u, f = r[pp], u[pp], f[pp]
    if isinstance(cam, OrthoCamera):
        pos = np.asarray(cam.center, dtype=np.float64)[pp]
    else:
        pos = np.asarray(cam.eye, dtype=np.float64)[pp]
    return r, u, f, pos


def plan_sweep(cam, grid_shape, axis: int, oversample: float = 1.0):
    """Build the :class:`SweepPlan` for a camera over a (Z, Y, X, C) grid.

    Returns:
      (plan, uv_pixel): ``uv_pixel`` is None when separable, else an
      (res_y, res_x, 2) float64 array of each pixel ray's base-plane (u, v).
    """
    dims_p = [grid_shape[d] for d in GRID_PERM[axis][:3]]  # (S, Y, X)
    n_planes = dims_p[0]
    r, u, f, pos = _permuted_camera(cam, axis)
    if abs(f[2]) < 1e-6:
        raise ValueError("sweep axis must not be perpendicular to view dir")
    reverse = f[2] < 0

    res_x, res_y = cam.res_x, cam.res_y
    jj = (np.arange(res_x) + 0.5) / res_x * 2.0 - 1.0
    ii = 1.0 - (np.arange(res_y) + 0.5) / res_y * 2.0
    uu, vv = np.meshgrid(jj, ii)

    valid = (0, n_planes - 1)
    if isinstance(cam, OrthoCamera):
        o = (
            pos[None, None, :]
            + uu[..., None] * (cam.width * 0.5) * r
            + vv[..., None] * (cam.height * 0.5) * u
        )
        d = np.broadcast_to(f, o.shape)
        ortho = True
        cam_params = (float(f[0] / f[2]), float(f[1] / f[2]))
    elif isinstance(cam, PerspectiveCamera):
        t = np.tan(cam.fov_y * 0.5)
        aspect = res_x / res_y
        d = f + uu[..., None] * (t * aspect) * r + vv[..., None] * t * u
        o = np.broadcast_to(pos, d.shape)
        ortho = False
        ez = float(pos[2])
        if abs(ez) < 1e-6:
            raise ValueError(
                "perspective eye on the sweep base plane (permuted z=0) "
                "degenerates the base-plane ray parameterization; nudge "
                "the camera"
            )
        if 0.0 <= ez <= n_planes - 1:
            # Fly-through: planes behind the eye are masked (see valid).
            if not reverse:
                valid = (int(math.floor(ez)) + 1, n_planes - 1)
            else:
                valid = (0, int(math.ceil(ez)) - 1)
            if valid[0] > valid[1]:
                raise ValueError(
                    "camera looks out of the slab: no visible planes"
                )
        cam_params = (float(pos[0]), float(pos[1]), ez)
    else:
        raise TypeError(f"unknown camera type: {type(cam)}")

    tt = (0.0 - o[..., 2]) / d[..., 2]
    base_u = o[..., 0] + d[..., 0] * tt
    base_v = o[..., 1] + d[..., 1] * tt

    du_col = np.diff(base_u, axis=1)
    dv_row = np.diff(base_v, axis=0)
    separable = (
        np.ptp(base_u, axis=0).max() < 1e-9 * max(1.0, np.abs(base_u).max())
        and np.ptp(base_v, axis=1).max()
        < 1e-9 * max(1.0, np.abs(base_v).max())
        and np.ptp(du_col) < 1e-9 * max(1.0, np.abs(du_col).max())
        and np.ptp(dv_row) < 1e-9 * max(1.0, np.abs(dv_row).max())
    )

    if separable:
        n_u, n_v = res_x, res_y
        u0, du = float(base_u[0, 0]), float(du_col[0, 0])
        v0, dv = float(base_v[0, 0]), float(dv_row[0, 0])
        uv_pixel = None
    else:
        n_u = int(round(res_x * oversample))
        n_v = int(round(res_y * oversample))
        umin, umax = float(base_u.min()), float(base_u.max())
        vmin, vmax = float(base_v.min()), float(base_v.max())
        du = (umax - umin) / max(n_u - 1, 1)
        dv = (vmax - vmin) / max(n_v - 1, 1)
        u0, v0 = umin, vmin
        uv_pixel = np.stack([base_u, base_v], axis=-1)

    plan = SweepPlan(
        axis=axis,
        n_planes=n_planes,
        reverse=bool(reverse),
        lattice=(u0, du, v0, dv),
        n_u=n_u,
        n_v=n_v,
        separable=bool(separable),
        ortho=ortho,
        cam_params=cam_params,
        valid=valid,
    )
    return plan, uv_pixel


def plan_valid_mask(plan: SweepPlan, dtype=torch.float32, device="cpu"):
    """(S,) 0/1 mask of visible planes, in traversal order."""
    p = np.arange(plan.n_planes)
    mask = ((p >= plan.valid[0]) & (p <= plan.valid[1])).astype(np.float64)
    if plan.reverse:
        mask = mask[::-1].copy()
    return torch.as_tensor(mask, dtype=dtype, device=device)


def slice_coeffs(plan: SweepPlan, dtype=torch.float32, device="cpu"):
    """Per-traversal-step affine coefficients (ay, by, ax, bx), four (S,)
    tensors: step k samples row i at ``i*ay[k] + by[k]`` and column j at
    ``j*ax[k] + bx[k]``."""
    u0, du, v0, dv = plan.lattice
    s = plan.n_planes
    p = np.arange(s, dtype=np.float64)
    if plan.reverse:
        p = p[::-1]
    if plan.ortho:
        sx, sy = plan.cam_params
        ax = np.full(s, du)
        bx = u0 + p * sx
        ay = np.full(s, dv)
        by = v0 + p * sy
    else:
        ex, ey, ez = plan.cam_params
        sp = 1.0 - p / ez
        ax = du * sp
        bx = u0 * sp + ex * (1.0 - sp)
        ay = dv * sp
        by = v0 * sp + ey * (1.0 - sp)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
        for a in (ay, by, ax, bx)
    )


def band_bounds(plan: SweepPlan) -> Tuple[float, float, float, float]:
    """(max |ay|, max |ax|, min |ay|, min |ax|) over the visible slices:
    the tent slopes, which bound how far apart neighbouring rays' taps
    lie in a slice."""
    u0, du, v0, dv = plan.lattice
    if plan.ortho:
        return (abs(float(dv)), abs(float(du)),
                abs(float(dv)), abs(float(du)))
    ez = plan.cam_params[2]
    p_vis = np.arange(plan.valid[0], plan.valid[1] + 1, dtype=np.float64)
    sp = np.abs(1.0 - p_vis / ez)
    sp_max, sp_min = float(sp.max()), float(sp.min())
    return (abs(float(dv)) * sp_max, abs(float(du)) * sp_max,
            abs(float(dv)) * sp_min, abs(float(du)) * sp_min)


def ray_dt(plan: SweepPlan, dtype=torch.float32, device="cpu"):
    """Per-intermediate-ray step length (n_v, n_u) for unit-speed rays:
    the constant ``1/|d_z|`` of each ray's direction."""
    u0, du, v0, dv = plan.lattice
    uj = u0 + du * np.arange(plan.n_u, dtype=np.float64)
    vi = v0 + dv * np.arange(plan.n_v, dtype=np.float64)
    uu, vv = np.meshgrid(uj, vi)
    if plan.ortho:
        sx, sy = plan.cam_params
        dt = np.full_like(uu, np.sqrt(1.0 + sx * sx + sy * sy))
    else:
        ex, ey, ez = plan.cam_params
        dt = np.sqrt((uu - ex) ** 2 + (vv - ey) ** 2 + ez * ez) / abs(ez)
    return torch.as_tensor(dt, dtype=dtype, device=device)


def intermediate_rays(plan: SweepPlan, dtype=torch.float64, device="cpu"):
    """Origins and dirs (n_v, n_u, 3) of the intermediate-lattice rays, for
    holding a sweep against the oracle.

    The rays are in *permuted* space, origins in front of the slab so that
    every plane crossing has t > 0: pair them with
    ``ref.march.render_plane_sweep(grid_permuted, o, d, axis=2)``.
    """
    u0, du, v0, dv = plan.lattice
    uj = u0 + du * np.arange(plan.n_u, dtype=np.float64)
    vi = v0 + dv * np.arange(plan.n_v, dtype=np.float64)
    uu, vv = np.meshgrid(uj, vi)
    base = np.stack([uu, vv, np.zeros_like(uu)], axis=-1)
    if plan.ortho:
        sx, sy = plan.cam_params
        sign = -1.0 if plan.reverse else 1.0
        d = np.asarray([sx, sy, 1.0]) * sign
        d = np.broadcast_to(d / np.linalg.norm(d), base.shape)
        o = base - d * (4.0 * plan.n_planes)
    else:
        eye = np.asarray(plan.cam_params)
        d = base - eye
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        # base - eye points toward the base plane, and plan.reverse sets the
        # view's z sign. For a fly-through (or behind-the-slab) eye the base
        # plane is behind the camera: flip, so that the marcher sees the
        # planes in front (t > 0), as the masked sweep does.
        want = -1.0 if plan.reverse else 1.0
        if float(d[0, 0, 2]) * want < 0:
            d = -d
        o = np.broadcast_to(eye, base.shape)
    return (torch.as_tensor(np.ascontiguousarray(o), dtype=dtype,
                            device=device),
            torch.as_tensor(np.ascontiguousarray(d), dtype=dtype,
                            device=device))


def _bilinear(g, x, y, n_rows: int, n_cols: int):
    """The 4-tap bilinear gather of an (n_rows, n_cols, C) image at
    fractional (row y, column x), with the taps clamped into the image."""
    x0 = torch.clamp(torch.floor(x), 0, n_cols - 2)
    y0 = torch.clamp(torch.floor(y), 0, n_rows - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    return (
        g[y0, x0] * ((1 - fy) * (1 - fx))[..., None]
        + g[y0, x0 + 1] * ((1 - fy) * fx)[..., None]
        + g[y0 + 1, x0] * (fy * (1 - fx))[..., None]
        + g[y0 + 1, x0 + 1] * (fy * fx)[..., None]
    )


def warp_to_pixels(intermediate, plan: SweepPlan,
                   uv_pixel: Optional[np.ndarray]):
    """Bilinearly resample the (n_v, n_u, C) intermediate image at the
    pixel base points (a 4-tap gather; identity when ``uv_pixel`` is
    None). Linear in ``intermediate``."""
    if uv_pixel is None:
        return intermediate
    u0, du, v0, dv = plan.lattice
    uvp = torch.as_tensor(uv_pixel, dtype=intermediate.dtype,
                          device=intermediate.device)
    x = (uvp[..., 0] - u0) / du
    y = (uvp[..., 1] - v0) / dv
    return _bilinear(intermediate, x, y, plan.n_v, plan.n_u)


def view_geometry(cam, grid_shape, dtype=torch.float32, oversample=1.0):
    """One view's sweep geometry as CPU tensors, for the training step;
    ``oversample`` is ``RenderConfig.oversample`` (the intermediate
    lattice's density for a non-separable camera).

    Returns (axis, reverse, geom, band) with geom = {
      'coeffs': (4, S) [ay, by, ax, bx] in traversal order,
      'dt': (V, U),
      'lattice': (4,) [u0, du, v0, dv],
      'uv': (H, W, 2) pixel base-plane coordinates (always present: for a
            separable camera they are the lattice points themselves),
      'valid': (S,) 0/1 visible planes in traversal order,
    } and ``band`` from :func:`band_bounds`.
    """
    from tpuvr_torch.ref.camera import dominant_axis

    axis = dominant_axis(cam)
    plan, uv_pixel = plan_sweep(cam, grid_shape, axis, oversample=oversample)
    if uv_pixel is None:
        u0, du, v0, dv = plan.lattice
        uu, vv = np.meshgrid(u0 + du * np.arange(plan.n_u),
                             v0 + dv * np.arange(plan.n_v))
        uv_pixel = np.stack([uu, vv], axis=-1)
    geom = {
        "coeffs": torch.stack(slice_coeffs(plan, dtype)),
        "dt": ray_dt(plan, dtype),
        "lattice": torch.as_tensor(plan.lattice, dtype=dtype),
        "uv": torch.as_tensor(uv_pixel, dtype=dtype),
        "valid": plan_valid_mask(plan, dtype),
    }
    return axis, plan.reverse, geom, band_bounds(plan)


def warp_to_pixels_dynamic(intermediate, lattice, uv_pixel):
    """:func:`warp_to_pixels` with the lattice as a (4,) tensor and the
    pixel base points as an (H, W, 2) tensor (the training step's per-view
    geometry is data)."""
    u0, du, v0, dv = lattice[0], lattice[1], lattice[2], lattice[3]
    x = (uv_pixel[..., 0] - u0) / du
    y = (uv_pixel[..., 1] - v0) / dv
    return _bilinear(intermediate, x, y, intermediate.shape[0],
                     intermediate.shape[1])


def warp_to_pixels_band(inter_band, lattice, uv_pixel, r0):
    """Pixel warp from the intermediate rows [r0, r0 + rows) only (the
    ``TrainConfig.rays_per_view`` row band).

    Returns (img (H, W, C), mask (H, W) bool): ``img`` is valid where
    ``mask``, the pixels whose bilinear support lies inside the band.
    """
    rows, n_u = inter_band.shape[0], inter_band.shape[1]
    u0, du, v0, dv = lattice[0], lattice[1], lattice[2], lattice[3]
    x = (uv_pixel[..., 0] - u0) / du
    y = (uv_pixel[..., 1] - v0) / dv
    yb = y - float(r0)
    mask = (yb >= 0.0) & (yb <= rows - 1)
    return _bilinear(inter_band, x, yb, rows, n_u), mask


def warp_to_pixels_owned(inter_halo, lattice, uv_pixel, r0: int,
                         rows_own: int, n_v: int):
    """Pixel warp from the intermediate rows a rank owns (the z-sharded
    trainer's row block, the JAX package's ``warp_to_pixels_owned``).

    ``inter_halo`` is (rows_own + 1, n_u, C): the block's rows
    [r0, r0 + rows_own) of the n_v-row image and one halo row, the next
    block's first. A pixel belongs to the block whose rows hold its clipped
    base row ``y0 = clip(floor(y), 0, n_v - 2)``: the blocks' masks are
    disjoint and cover every pixel, with the taps of
    :func:`warp_to_pixels_dynamic` (the last block's pixels never read its
    halo row, which is zeros, because of the clip at n_v - 2).

    Returns (img (H, W, C), mask (H, W) bool): ``img`` valid where ``mask``.
    """
    n_u = inter_halo.shape[1]
    u0, du, v0, dv = lattice[0], lattice[1], lattice[2], lattice[3]
    x = (uv_pixel[..., 0] - u0) / du
    y = (uv_pixel[..., 1] - v0) / dv
    x0 = torch.clamp(torch.floor(x), 0, n_u - 2)
    y0 = torch.clamp(torch.floor(y), 0, n_v - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    y0 = y0.long()
    mask = (y0 >= r0) & (y0 < r0 + rows_own)
    yl = torch.clamp(y0 - r0, 0, rows_own - 1)
    x0 = x0.long()
    g = inter_halo
    img = (
        g[yl, x0] * ((1 - fy) * (1 - fx))[..., None]
        + g[yl, x0 + 1] * ((1 - fy) * fx)[..., None]
        + g[yl + 1, x0] * (fy * (1 - fx))[..., None]
        + g[yl + 1, x0 + 1] * (fy * fx)[..., None]
    )
    return img, mask
