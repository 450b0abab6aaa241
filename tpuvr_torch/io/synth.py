"""Synthetic scenes and posed-view fixtures."""

from __future__ import annotations

import math
from typing import List

import torch

from tpuvr_torch.device import resolve_device
from tpuvr_torch.ref.camera import look_at_perspective


def smoke_sphere(n: int, dtype=torch.float32, device=None):
    """Asymmetric smoke-sphere voxel field of shape (n, n, n, 4).

    Two Gaussian density lobes (one off-centre) with a position-dependent
    emission ramp; the optical depth through the core is about 3.3 at
    every ``n``. Built on ``device`` (``None`` means the card).
    """
    dev = resolve_device(device)
    c = (n - 1) / 2.0
    ax = torch.arange(n, dtype=dtype, device=dev)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")

    def lobe(cx, cy, cz, radius, amp):
        r2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        return amp * torch.exp(-r2 / (2.0 * radius**2))

    sigma = lobe(c, c, c, 0.3 * n, 6.0 / n)
    sigma = sigma + lobe(c + 0.18 * n, c - 0.1 * n, c + 0.12 * n,
                         0.15 * n, 3.0 / n)
    ramp = (x + y + z) / (3.0 * max(n - 1, 1))
    r = 0.9 * ramp + 0.1
    g = 0.5 * torch.ones_like(ramp)
    b = 1.0 - 0.8 * ramp
    return torch.stack([sigma, r, g, b], dim=-1)


def hollow_shell(n: int, r0: float = 0.35, width: float = 0.06,
                 amp: float | None = None, dtype=torch.float32, device=None):
    """Hollow spherical shell of shape (n, n, n, 4) with density exactly
    zero off the shell.

    The stress scene for empty-space skipping: every slice through the
    sphere touches density, yet most of each slice and the whole interior
    are empty. Density is a truncated raised cosine over ``|r - r0*n| <
    width*n`` (``amp`` at the centre of the wall, by default about optical
    depth 1.5 through one wall); emission ramps as in :func:`smoke_sphere`.
    Built on ``device`` (``None`` means the card). The square root and the
    cosine are taken in float64 and rounded to ``dtype``, which on the CPU
    rounds them correctly, as the JAX package's are (PyTorch's float32
    versions can be an ulp off): the two packages' shells agree bit for
    bit there. The card's float64 cosine is not correctly rounded, so a
    value built there may be an ulp off.
    """
    dev = resolve_device(device)
    c = (n - 1) / 2.0
    ax = torch.arange(n, dtype=dtype, device=dev)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    r = torch.sqrt(((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2).double())
    d = torch.abs(r.to(dtype) - r0 * n)
    w = width * n
    if amp is None:
        amp = 24.0 / n
    cos = torch.cos((math.pi * d / w).double()).to(dtype)
    sigma = torch.where(d < w, amp * 0.5 * (1.0 + cos), 0.0)
    ramp = (x + y + z) / (3.0 * max(n - 1, 1))
    return torch.stack([sigma, 0.9 * ramp + 0.1, 0.5 * torch.ones_like(ramp),
                        1.0 - 0.8 * ramp], dim=-1)


def orbit_cameras(
    n_views: int,
    grid_n: int,
    res: int = 64,
    fov_y: float = math.radians(40.0),
    elevation_deg: float = 20.0,
    distance_factor: float = 2.2,
) -> List:
    """``n_views`` perspective cameras on a tilted circle around the grid
    centre, at ``distance_factor * grid_n``, all looking at the centre."""
    c = (grid_n - 1) / 2.0
    dist = distance_factor * grid_n
    elev = math.radians(elevation_deg)
    cams = []
    for i in range(n_views):
        az = 2.0 * math.pi * i / n_views
        eye = (
            c + dist * math.cos(az) * math.cos(elev),
            c + dist * math.sin(az) * math.cos(elev),
            c + dist * math.sin(elev),
        )
        cams.append(
            look_at_perspective(
                eye, (c, c, c), fov_y=fov_y, res_x=res, res_y=res
            )
        )
    return cams
