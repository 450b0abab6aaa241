"""Hemisphere-sampled single-scatter lighting: the light volume.

  L(voxel) = sky_intensity * (1/N) * sum_w exp(-tau_w(voxel))

where tau_w is the optical depth from the voxel to the sky along
hemisphere direction w. Each tau_w is one directional slab sweep from the
sky side inward (``tpuvr_torch.kernels.lighting.tau_sweep``). Lit
rendering multiplies L into the emission channels, so the render sweep is
unchanged. With ``detach`` (the config's default) no gradient flows
through L; ``detach=False`` differentiates the shadows too, through the
tau sweeps' adjoint (``tau_sweep_adj``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuvr_torch.config import LightingConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.kernels.lighting import tau_sweep, tau_sweep_adj
from tpuvr_torch.ref.march import GRID_PERM, PT_PERM


def hemisphere_dirs(n: int, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Deterministic Fibonacci-spiral directions around ``up``: (n, 3)
    unit vectors with dir . up > 0."""
    up = np.asarray(up, dtype=np.float64)
    up = up / np.linalg.norm(up)
    golden = (1.0 + math.sqrt(5.0)) / 2.0
    i = np.arange(n, dtype=np.float64)
    z = (i + 0.5) / n
    phi = 2.0 * math.pi * i / golden
    r = np.sqrt(1.0 - z * z)
    local = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    a = np.asarray([0.0, 0.0, 1.0])
    if np.allclose(up, a):
        rot = np.eye(3)
    elif np.allclose(up, -a):
        rot = np.diag([1.0, -1.0, -1.0])
    else:
        v = np.cross(a, up)
        c = float(a @ up)
        vx = np.asarray(
            [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
        )
        rot = np.eye(3) + vx + vx @ vx / (1.0 + c)
    return local @ rot.T


class _Tau(torch.autograd.Function):
    """Differentiable tau sweep: the adjoint is another directional sweep
    with the negated shift, plane-ascending. The residual is sigma alone,
    for the relu mask."""

    @staticmethod
    def forward(ctx, sig_p, d_y, d_x, dt, precision):
        ctx.save_for_backward(sig_p)
        ctx.args = dict(d_y=d_y, d_x=d_x, dt=dt, precision=precision)
        return tau_sweep(sig_p, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        (sig_p,) = ctx.saved_tensors
        ds = tau_sweep_adj(g.contiguous(), **ctx.args)
        return (torch.where(sig_p > 0.0, ds, torch.zeros_like(ds)),
                None, None, None, None)


def _directional_tau(sigma, w, precision="highest"):
    """Optical depth to the sky along unit direction ``w`` (x, y, z) for
    every voxel of the (Z, Y, X) density; same layout out."""
    axis = int(np.argmax(np.abs(w)))
    perm = GRID_PERM[axis][:3]
    sig_p = sigma.permute(perm)
    wp = np.asarray(w, dtype=np.float64)[list(PT_PERM[axis])]
    flip = wp[2] < 0
    if flip:
        sig_p = sig_p.flip(0)
    dz = abs(float(wp[2]))
    tau_p = _Tau.apply(sig_p.contiguous(), float(wp[1]) / dz,
                       float(wp[0]) / dz, 1.0 / dz, precision)
    if flip:
        tau_p = tau_p.flip(0)
    return tau_p.permute(tuple(int(i) for i in np.argsort(perm)))


def light_volume(sigma, cfg: LightingConfig = LightingConfig(),
                 precision: str = "highest", device=None):
    """Sky-light volume L (Z, Y, X): mean hemisphere transmittance.

    Directions accumulate one at a time, so without gradients at most
    about two tau volumes are alive at once; with them, each direction
    keeps its permuted density and its transmittance for the backward.
    """
    sigma = torch.as_tensor(sigma, device=resolve_device(device))
    total = torch.zeros_like(sigma)
    for w in hemisphere_dirs(cfg.n_samples, cfg.up):
        total = total + torch.exp(-_directional_tau(sigma, w, precision))
    return (cfg.sky_intensity / cfg.n_samples) * total


def apply_lighting(grid, cfg: LightingConfig = LightingConfig(),
                   precision: str = "highest", detach: bool | None = None):
    """Multiply the sky-light volume into the emission channels of a
    (Z, Y, X, 4) grid; density is unchanged. ``detach`` (default
    ``cfg.detach``) stops gradients at the light volume; ``detach=False``
    differentiates the shadows through the tau sweeps' adjoint."""
    if detach is None:
        detach = cfg.detach
    if cfg.mode == "lightvolume":
        sigma = grid[..., 0].detach() if detach else grid[..., 0]
        ell = light_volume(sigma, cfg, precision, device=grid.device)
    elif cfg.mode == "persample":
        raise NotImplementedError("mode='persample' (the exact oracle) is "
                                  "not ported yet")
    else:
        raise ValueError(f"unknown lighting mode: {cfg.mode!r}")
    return torch.cat([grid[..., :1], grid[..., 1:4] * ell[..., None]],
                     dim=-1)
