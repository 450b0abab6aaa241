"""Cameras: frozen dataclasses, with the host-side float64 basis, and
per-pixel ray generation for the oracles.

Vectors are (x, y, z) in grid space (voxel centres at integers). The
fields and the basis are those of the JAX package's cameras, so a camera
moves across field for field (``tpuvr_torch.convert.camera_from_fields``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

Vec3 = Tuple[float, float, float]


def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _basis(forward: Vec3, up: Vec3):
    """Right-handed camera basis (right, up_ortho, forward) as f64 numpy.

    If ``forward`` is (near) parallel to the ``up`` hint, a fallback up
    axis is substituted deterministically instead of producing NaNs.
    """
    f = np.asarray(forward, dtype=np.float64)
    f = f / np.linalg.norm(f)
    u_hint = np.asarray(up, dtype=np.float64)
    r = np.cross(f, u_hint)
    if np.linalg.norm(r) < 1e-6:
        axis = int(np.argmin(np.abs(f)))
        u_hint = np.eye(3)[axis]
        r = np.cross(f, u_hint)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    return r, u, f


@dataclasses.dataclass(frozen=True)
class OrthoCamera:
    """Orthographic camera: parallel rays along ``forward``.

    Attributes:
      center: centre of the image plane.
      forward: view direction.
      up: world up hint.
      width/height: image plane extent in voxel units.
      res_x/res_y: image resolution in pixels.
    """

    center: Vec3
    forward: Vec3
    up: Vec3 = (0.0, 0.0, 1.0)
    width: float = 2.0
    height: float = 2.0
    res_x: int = 256
    res_y: int = 256


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Pinhole camera with vertical field of view ``fov_y`` (radians)."""

    eye: Vec3
    forward: Vec3
    up: Vec3 = (0.0, 0.0, 1.0)
    fov_y: float = math.radians(40.0)
    res_x: int = 256
    res_y: int = 256


def _pixel_ndc(res_x: int, res_y: int, dtype):
    """Pixel-centre NDC grids (u right, v up), each (res_y, res_x)."""
    j = (torch.arange(res_x, dtype=dtype) + 0.5) / res_x * 2.0 - 1.0
    i = 1.0 - (torch.arange(res_y, dtype=dtype) + 0.5) / res_y * 2.0
    return torch.meshgrid(j, i, indexing="xy")


def camera_rays(cam, dtype=torch.float32):
    """Per-pixel rays, on the CPU in ``dtype`` (the caller moves them).

    Returns:
      origins (res_y, res_x, 3), dirs (res_y, res_x, 3). Perspective dirs
      are unit length; orthographic dirs equal the unit forward vector.
    """
    r, u, f = (torch.as_tensor(v, dtype=dtype)
               for v in _basis(cam.forward, cam.up))
    uu, vv = _pixel_ndc(cam.res_x, cam.res_y, dtype)
    if isinstance(cam, OrthoCamera):
        center = torch.as_tensor(cam.center, dtype=dtype)
        origins = (center + uu[..., None] * (cam.width * 0.5) * r
                   + vv[..., None] * (cam.height * 0.5) * u)
        return origins, f.expand(origins.shape).clone()
    if isinstance(cam, PerspectiveCamera):
        t = math.tan(cam.fov_y * 0.5)
        aspect = cam.res_x / cam.res_y
        dirs = _normalize(f + uu[..., None] * (t * aspect) * r
                          + vv[..., None] * t * u)
        eye = torch.as_tensor(cam.eye, dtype=dtype)
        return eye.expand(dirs.shape).clone(), dirs
    raise TypeError(f"unknown camera type: {type(cam)}")


def look_at_perspective(
    eye: Vec3,
    target: Vec3,
    up: Vec3 = (0.0, 0.0, 1.0),
    fov_y: float = math.radians(40.0),
    res_x: int = 256,
    res_y: int = 256,
) -> PerspectiveCamera:
    """Perspective camera looking from ``eye`` toward ``target``."""
    fwd = tuple(float(t) - float(e) for e, t in zip(eye, target))
    return PerspectiveCamera(
        eye=tuple(float(e) for e in eye),
        forward=fwd,
        up=up,
        fov_y=fov_y,
        res_x=res_x,
        res_y=res_y,
    )


def dominant_axis(cam) -> int:
    """Grid axis (0=x, 1=y, 2=z) most aligned with the view direction."""
    mags = [abs(float(c)) for c in cam.forward]
    return mags.index(max(mags))
