"""Cameras: frozen dataclasses, with the host-side float64 basis.

Vectors are (x, y, z) in grid space (voxel centres at integers). The
fields and the basis are those of the JAX package's cameras, so a camera
moves across field for field (``tpuvr_torch.convert.camera_from_fields``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


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
