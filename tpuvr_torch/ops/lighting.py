"""Hemisphere-sampled single-scatter lighting: the light volume.

  L(voxel) = sky_intensity * (1/N) * sum_w exp(-tau_w(voxel))

where tau_w is the optical depth from the voxel to the sky along
hemisphere direction w. Each tau_w is one directional slab sweep from the
sky side inward; :func:`light_volume` sweeps every direction in one call
of ``tpuvr_torch.kernels.lighting.tau_sweep_dirs`` (one launch on the
card). Lit rendering multiplies L into the emission channels, so the render
sweep is unchanged. With ``detach`` (the config's default) no gradient
flows through L, and on the card the sum and the multiply are one kernel
each way (``tpuvr_torch.kernels.light_apply``, K9 and K10);
``detach=False`` differentiates the shadows too, through the tau sweeps'
adjoint (``tau_sweep_adj_dirs``, K4, again one launch). On the card that
route is one autograd function (:func:`apply_lighting`): K2 and K9
forward, and backward K11 (the lit grid's and the taus' cotangents), K4
and K12 (the relu masks and the directions' sum), with no ATen pass
between them. Such a bake, one whose density takes a gradient, counts as
``light_shadow`` in ``utils.trace.launch_counts()``, and its backward as
``light_shadow_adjoint``, under the span ``tpuvr.light.adjoint``; a
detached bake runs none of it.

``mode='persample'`` builds L exactly instead (:func:`light_volume_exact`):
true secondary marches from every voxel centre through the trilinear
density, in plain PyTorch on the grid's device, as the JAX package's is
plain XLA. It is the oracle that the sweeps are held against.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tpuvr_torch.config import LightingConfig
from tpuvr_torch.device import resolve_device
from tpuvr_torch.kernels import light_apply as klight_apply
from tpuvr_torch.kernels.light_apply import (
    grid_order,
    light_apply,
    light_apply_fwd,
    light_value_torch,
    lit_grid_torch,
    mask_sum,
    shadow_cotangents,
)
from tpuvr_torch.kernels.lighting import (
    tau_sweep,
    tau_sweep_adj,
    tau_sweep_adj_dirs,
    tau_sweep_dirs,
)
from tpuvr_torch.ref.march import GRID_PERM, PT_PERM, _relu
from tpuvr_torch.ref.sample import trilinear
from tpuvr_torch.utils import trace

# Differentiable 'lightvolume' bakes ("bake": the tau sweeps of a density
# that takes a gradient) and their backward passes ("adjoint").
shadow: collections.Counter[str] = collections.Counter()
trace.counter(lambda: {"light_shadow": shadow["bake"],
                       "light_shadow_adjoint": shadow["adjoint"]})


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


def light_direction(w):
    """The sweep toward unit direction ``w`` (x, y, z), as the JAX
    package's ``_directional_tau`` sets it up: (axis, flip, d_y, d_x, dt),
    the sweep axis of the (Z, Y, X) field (its ``GRID_PERM`` layout), whether
    the sky lies at its first plane (the planes are walked in reverse), and
    the in-plane shift per plane and the path length per plane."""
    axis = int(np.argmax(np.abs(w)))
    wp = np.asarray(w, dtype=np.float64)[list(PT_PERM[axis])]
    dz = abs(float(wp[2]))
    return (axis, bool(wp[2] < 0), float(wp[1]) / dz, float(wp[0]) / dz,
            1.0 / dz)


def direction_table(cfg: LightingConfig):
    """:func:`light_direction` of each of ``cfg``'s hemisphere directions."""
    return [light_direction(w)
            for w in hemisphere_dirs(cfg.n_samples, cfg.up)]


class _Tau(torch.autograd.Function):
    """Differentiable tau sweep of one direction: the adjoint is another
    directional sweep with the negated shift, plane-ascending. The residual
    is sigma alone, for the relu mask."""

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
    every voxel of the (Z, Y, X) density; same layout out. One direction
    alone (its own permuted, flipped copy); :func:`light_volume` sweeps all
    of them at once."""
    axis, flip, d_y, d_x, dt = light_direction(w)
    sig_p = sigma.permute(GRID_PERM[axis][:3])
    if flip:
        sig_p = sig_p.flip(0)
    tau_p = _Tau.apply(sig_p.contiguous(), d_y, d_x, dt, precision)
    if flip:
        tau_p = tau_p.flip(0)
    return tau_p.permute(grid_order(axis))


class _TauDirs(torch.autograd.Function):
    """Differentiable tau sweeps of a whole direction table in one kernel
    call each way. The forward makes one contiguous copy of sigma in each
    sweep axis's layout that needs one (none for the z axis of a
    contiguous sigma; flipped directions walk their copy in reverse) and
    returns each direction's tau in its axis's layout. The backward is one
    adjoint call over every direction, then the relu mask, and sums the
    directions' gradients from the last to the first: the order in which
    autograd adds them up when each direction is its own function
    (:func:`_directional_tau`), so that both give the same bits.

    The backward counts as ``light_shadow_adjoint`` and runs under the
    span ``tpuvr.light.adjoint`` (on autograd's thread, inside the
    caller's backward)."""

    @staticmethod
    def forward(ctx, sigma, table, precision):
        axes = sorted({row[0] for row in table})
        fields = [sigma.permute(GRID_PERM[a][:3]).contiguous() for a in axes]
        by_axis = dict(zip(axes, fields))
        ctx.save_for_backward(*fields)
        ctx.axes, ctx.table, ctx.precision = axes, table, precision
        return tuple(tau_sweep_dirs(
            [(by_axis[a], flip, d_y, d_x, dt)
             for a, flip, d_y, d_x, dt in table], precision))

    @staticmethod
    def backward(ctx, *gs):
        shadow["adjoint"] += 1
        with trace.span("tpuvr.light.adjoint"):
            by_axis = dict(zip(ctx.axes, ctx.saved_tensors))
            ds = tau_sweep_adj_dirs(
                [(g.contiguous(), flip, d_y, d_x, dt)
                 for g, (_, flip, d_y, d_x, dt) in zip(gs, ctx.table)],
                ctx.precision)
            dsig = None
            for (axis, *_), d in zip(ctx.table[::-1], ds[::-1]):
                field = by_axis[axis]
                term = torch.where(field > 0.0, d,
                                   torch.zeros_like(d)).permute(
                                       grid_order(axis))
                dsig = term if dsig is None else dsig + term
        return dsig, None, None


class _Shadow(torch.autograd.Function):
    """The lit grid of a differentiable 'lightvolume' bake on the card, in
    one function. Forward: the sigma layout copies that the sweeps take, K2
    (``tau_sweep_dirs``) and K9 (``light_apply_fwd``); it keeps the taus
    (one a direction), the grid and one sigma for the masks (the z sweep's
    copy, else the grid's channel 0), and no exponential, L or sum.
    Backward: K11 (``shadow_cotangents``: the grid's gradient, and each
    tau's cotangent written over the tau), K4 (``tau_sweep_adj_dirs``) and
    K12 (``mask_sum``: the relu masks and the directions' sum, into the
    density channel), counted as ``light_shadow_adjoint`` under the span
    ``tpuvr.light.adjoint``. The same bits as the ATen route
    (:func:`light_volume`, then ``lit_grid_torch``). The backward writes
    over its saved taus, so it runs once."""

    @staticmethod
    def forward(ctx, grid, table, precision, scale):
        axes = [row[0] for row in table]
        sigma = grid[..., 0]
        fields = {a: sigma.permute(GRID_PERM[a][:3]).contiguous()
                  for a in sorted(set(axes))}
        taus = tau_sweep_dirs([(fields[a], flip, d_y, d_x, dt)
                               for a, flip, d_y, d_x, dt in table], precision)
        mask = fields.get(2, sigma)
        del fields
        lit = light_apply_fwd(grid, taus, axes, scale)
        ctx.save_for_backward(grid, mask, *taus)
        ctx.table, ctx.precision, ctx.scale = table, precision, scale
        ctx.spent = False
        return lit

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if ctx.spent:
            raise RuntimeError("the shadow route's backward writes over its "
                               "saved taus and runs once")
        ctx.spent = True
        shadow["adjoint"] += 1
        with trace.span("tpuvr.light.adjoint"):
            grid, mask, *cots = ctx.saved_tensors
            axes = [row[0] for row in ctx.table]
            dgrid = shadow_cotangents(g, grid, cots, axes, ctx.scale)
            adjs = tau_sweep_adj_dirs(
                [(c, flip, d_y, d_x, dt)
                 for c, (_, flip, d_y, d_x, dt) in zip(cots, ctx.table)],
                ctx.precision)
            del cots
            mask_sum(dgrid, adjs, axes, mask)
        return dgrid, None, None, None


def light_volume(sigma, cfg: LightingConfig = LightingConfig(),
                 precision: str = "highest", device=None):
    """Sky-light volume L (Z, Y, X): mean hemisphere transmittance.

    Every direction's tau comes from one batched sweep, so all N tau
    volumes are alive at once: with a copy of sigma for each sweep axis
    (none for the z axis of a contiguous sigma) during the sweep, then
    with the running sum, one direction's negation and its exponential
    (``kernels.light_apply.light_value_torch``, the ATen passes): N + 3
    volumes of sigma's size besides sigma at the peak, 1.3 GB for N = 16
    at 256^3 in f32. With gradients the copies and the exponentials stay
    for the backward, and the bake counts as ``light_shadow``.
    :func:`apply_lighting` bakes a detached light volume on the card
    without the sum and the exponentials.
    """
    sigma = torch.as_tensor(sigma, device=resolve_device(device))
    if sigma.requires_grad and torch.is_grad_enabled():
        shadow["bake"] += 1
    table = direction_table(cfg)
    return light_value_torch(_TauDirs.apply(sigma, table, precision),
                             [axis for axis, *_ in table],
                             cfg.sky_intensity / cfg.n_samples)


# Points of one trilinear gather of the exact marcher: consecutive steps
# march together up to this many (some 300 B each while the gather runs).
GATHER_POINTS = 1 << 22


def light_at_points_ref(sigma, pts, cfg: LightingConfig = LightingConfig(),
                        dt: float = 0.25):
    """Exact hemisphere lighting at points: ``cfg.n_samples`` secondary
    rays from each point, marched with step ``dt`` through the trilinear
    density (vacuum outside the grid) far enough to leave it from anywhere
    in it.

    Args:
      sigma: (Z, Y, X) density.
      pts: (..., 3) points (x, y, z).

    Returns:
      (...,) light values, ``(sky / N) sum_w exp(-tau_w)``.

    The directions march together, stacked on a leading axis, and so do
    blocks of consecutive steps (as many as keep one gather within
    ``GATHER_POINTS`` points): every operation is elementwise or a
    gather, so each step's values are those of its own march, and tau
    adds the steps, and the total the directions, one at a time in order.
    Differentiable by autograd, which keeps every step's gather.
    """
    z_dim, y_dim, x_dim = sigma.shape
    field = sigma[..., None]
    dirs = torch.as_tensor(hemisphere_dirs(cfg.n_samples, cfg.up),
                           dtype=sigma.dtype, device=sigma.device)
    w = dirs.reshape(cfg.n_samples, *([1] * (pts.dim() - 1)), 3)
    diag = math.sqrt((x_dim + 1) ** 2 + (y_dim + 1) ** 2 + (z_dim + 1) ** 2)
    n_steps = int(math.ceil(diag / dt)) + 1
    tau = sigma.new_zeros((cfg.n_samples, *pts.shape[:-1]))
    block = max(1, GATHER_POINTS // tau.numel())
    for i0 in range(0, n_steps, block):
        offsets = torch.tensor(
            [(i + 0.5) * dt for i in range(i0, min(i0 + block, n_steps))],
            dtype=sigma.dtype, device=sigma.device)
        p = pts + w * offsets.reshape(-1, *([1] * w.dim()))
        for step in dt * _relu(trilinear(field, p)[..., 0]):
            tau = tau + step
    trans = torch.exp(-tau)
    total = 0.0
    for k in range(cfg.n_samples):
        total = total + trans[k]
    return (cfg.sky_intensity / cfg.n_samples) * total


def light_volume_exact(sigma, cfg: LightingConfig = LightingConfig(),
                       chunk_planes: int = 1):
    """Exact light volume (Z, Y, X) of the 'persample' mode:
    :func:`light_at_points_ref` at every voxel centre with step
    ``cfg.secondary_dt``, ``chunk_planes`` z planes a call (the values do
    not depend on it).

    O(voxels * N * steps) trilinear samples, some 230 operations a
    gather (a block of steps, :data:`GATHER_POINTS`). Under autograd every
    step's gather is kept (its corners' indices and weights), about 230 B
    a point, a direction and a step in f32: 16 MB at 8^3 with 4
    directions and dt 0.5 (33 steps), 7 GB at 32^3 with 16 directions and
    dt 1 (59 steps), 110 GB at 64^3 (114 steps), so differentiate only
    small grids.
    """
    z_dim, y_dim, x_dim = sigma.shape
    yy, xx = torch.meshgrid(
        torch.arange(y_dim, dtype=sigma.dtype, device=sigma.device),
        torch.arange(x_dim, dtype=sigma.dtype, device=sigma.device),
        indexing="ij")
    planes = []
    for z0 in range(0, z_dim, chunk_planes):
        zs = torch.arange(z0, min(z0 + chunk_planes, z_dim),
                          dtype=sigma.dtype, device=sigma.device)
        n = zs.shape[0]
        pts = torch.stack([xx.expand(n, -1, -1), yy.expand(n, -1, -1),
                           zs[:, None, None].expand(n, y_dim, x_dim)],
                          dim=-1)
        planes.append(light_at_points_ref(sigma, pts, cfg,
                                          dt=cfg.secondary_dt))
    return torch.cat(planes, dim=0)


def apply_lighting(grid, cfg: LightingConfig = LightingConfig(),
                   precision: str = "highest", detach: bool | None = None):
    """Multiply the sky-light volume into the emission channels of a
    (Z, Y, X, 4) grid; density is unchanged. ``cfg.mode`` 'lightvolume'
    bakes it with the tau sweeps, 'persample' marches it exactly
    (:func:`light_volume_exact`, one z plane a call; slow, and under
    autograd memory-hungry). ``detach`` (default ``cfg.detach``) stops
    gradients at the light volume; ``detach=False`` differentiates the
    shadows too: through the tau sweeps' adjoint, or by autograd through
    every step of the exact marches.

    A detached 'lightvolume' bake of a float32 grid on the card, in any
    layout (``kernels.light_apply.takes``), goes from the tau sweeps
    straight to one pass each way (``kernels.light_apply``: K9 sums the
    exponentials, scales and multiplies the emission; K10 is its
    backward), which frees each tau once read and makes no sum or
    exponential: N + 3 volumes of sigma's size at the peak (the taus and a
    copy of sigma for each sweep axis), then the lit grid. So does an
    undetached one with no gradient to take (under ``torch.no_grad``, or
    a grid that takes none), which is the same function. An undetached one
    whose grid takes a gradient runs as one function (``_Shadow``): K2 and
    K9 forward, keeping the taus; backward K11 writes the grid's gradient
    and each tau's cotangent over the tau, K4 sweeps the cotangents back
    and K12 adds their masked sum into the density channel (one launch of
    each a run of ``kernels.light_apply.MAX_DIRS`` directions). Every other
    call (the CPU, 'persample', another dtype) takes the ATen passes
    (:func:`light_volume`, then ``lit_grid_torch``), counted as
    ``light_apply_fallback``; each route gives the same bits."""
    if detach is None:
        detach = cfg.detach
    if cfg.mode == "lightvolume" and klight_apply.takes(grid):
        table = direction_table(cfg)
        scale = cfg.sky_intensity / cfg.n_samples
        if detach or not (torch.is_grad_enabled() and grid.requires_grad):
            taus = _TauDirs.apply(grid[..., 0].detach(), table, precision)
            return light_apply(grid, taus, [axis for axis, *_ in table],
                               scale)
        shadow["bake"] += 1
        return _Shadow.apply(klight_apply.aligned(grid), table, precision,
                             scale)
    klight_apply.launches["fallback"] += 1
    sigma = grid[..., 0].detach() if detach else grid[..., 0]
    if cfg.mode == "lightvolume":
        ell = light_volume(sigma, cfg, precision, device=grid.device)
    elif cfg.mode == "persample":
        ell = light_volume_exact(sigma, cfg)
    else:
        raise ValueError(f"unknown lighting mode: {cfg.mode!r}")
    return lit_grid_torch(grid, ell)
