"""The fit's reference with the shadows differentiated: the image loss of
posed views and its gradient with respect to the raw voxel parameters,
the density's through the sky light too, in plain PyTorch (float32, TF32
off: :func:`vrbench.ref.sweep.strict_f32`).

With the light L = (sky / N) sum_w exp(-tau_w(sigma)) multiplied into the
emission e (the lit grid is (sigma, e L)), a loss whose cotangent with
respect to the lit grid is (g_0, g_e) has

  d sigma = g_0 + sum_w (d tau_w / d sigma)^T [-(sky / N) exp(-tau_w) dL],
  d e = L g_e,   dL = sum_c g_c e_c,

where tau_w is :func:`vrbench.ref.sweep.tau` (relu inside) along
hemisphere direction w. The gradient is taken in passes so that it fits
at 512^3 beside nothing else:

1. L and the lit grid, without autograd (:func:`vrbench.ref.sweep.light_volume`);
2. the lit grid's gradient, by :func:`vrbench.ref.train.loss_and_grad`'s
   row blocks, the lit grid as its (unlit, linear) parameters;
3. dL, the light's cotangent;
4. one direction at a time: its tau re-swept under autograd, with
   :func:`vrbench.ref.sweep.tau`'s tents and recurrence, and
   back-propagated, through exp(-tau), with the cotangent (sky / N) dL
   into sigma (the relu mask by autograd). The sweep is written out here
   (:func:`swept_dot`) because ``tau`` reads its planes one index at a
   time and writes them in place, and autograd zero-fills or copies the
   whole volume once a plane back through each: 0.58 s a direction at
   512^3 on the H100, most of the reference's time. The tests hold these
   passes against autograd through ``light_volume`` and ``tau``
   themselves;
5. the emission's L g_e, and the whole through softplus when the
   configuration uses it.

Minibatches, Adam and the faults are :mod:`vrbench.ref.train`'s, with one
more fault: 'detached', the light's gradient left out (what the detached
fit's reference computes).
"""

from __future__ import annotations

import numpy as np
import torch

from vrbench.ref import sweep
from vrbench.ref import train as RT
from vrbench.ref.geometry import GRID_PERM, PT_PERM


def directions(lighting):
    """Each hemisphere direction's sweep: (permutation of the (Z, Y, X)
    density into its sweep layout, flip, d_y, d_x, dt), as
    :func:`vrbench.ref.sweep.light_volume` sweeps it."""
    out = []
    for w in sweep.hemisphere_dirs(lighting["n_samples"], lighting["up"]):
        axis = int(np.argmax(np.abs(w)))
        wp = w[list(PT_PERM[axis])]
        dz = abs(float(wp[2]))
        out.append((GRID_PERM[axis][:3], bool(wp[2] < 0), float(wp[1]) / dz,
                    float(wp[0]) / dz, 1.0 / dz))
    return out


def swept_dot(sig_p, c, d_y: float, d_x: float, dt: float):
    """sum_k <c[k], exp(-tau[k])> for the (S, Y, X) density ``sig_p``
    whose plane index rises toward the sky, tau swept as
    :func:`vrbench.ref.sweep.tau` sweeps it (the same tents and the same
    f32 operations a plane), one plane at a time: the planes are taken by
    one ``unbind`` and no volume is written in place, so that autograd's
    backward handles whole volumes once, not once a plane."""
    s, n_y, n_x = sig_p.shape
    planes = sig_p.unbind(0)
    one = sig_p.new_ones(1)
    mat_a, mat_b = (m[0] for m in sweep.tents(one, one * d_y, one, one * d_x,
                                              range(n_y), n_y, n_x, n_x))
    t = sig_p.new_zeros((n_y, n_x))
    total = (c[s - 1] * torch.exp(-t)).sum()
    for k in range(s - 2, -1, -1):
        t = (mat_a @ (t + dt * torch.relu(planes[k + 1]))) @ mat_b
        total = total + (c[k] * torch.exp(-t)).sum()
    return total


def light_grad(sigma, d_ell, lighting):
    """(d L)^T d_ell with respect to the (Z, Y, X) density: one direction
    at a time, re-swept under autograd (:func:`swept_dot`)."""
    leaf = sigma.detach().requires_grad_(True)
    scale = lighting["sky_intensity"] / lighting["n_samples"]
    for perm, flip, d_y, d_x, dt in directions(lighting):
        c = (scale * d_ell).permute(perm)
        if flip:
            c = c.flip(0)
        with torch.enable_grad():
            sig_p = leaf.permute(perm)
            if flip:
                sig_p = sig_p.flip(0)
            swept_dot(sig_p.contiguous(), c.contiguous(), d_y, d_x,
                      dt).backward()
    return leaf.grad


def loss_and_grad(params, views, targets, pick, cfg, row_block: int,
                  rows_of=None, loss_rows=None, shadows: bool = True):
    """The minibatch loss and its gradient with respect to ``params``, the
    light differentiated (passes 1-5 above); ``shadows=False`` leaves its
    gradient out. ``rows_of`` and ``loss_rows`` plant
    :func:`vrbench.ref.train.loss_and_grad`'s faults."""
    light = cfg["lighting"]
    softplus = cfg["density_softplus"]
    with torch.no_grad():
        grid = RT.to_grid(params, softplus)
        ell = sweep.light_volume(grid[..., 0], light["n_samples"],
                                 light["sky_intensity"], light["up"])
        lit = torch.cat([grid[..., :1], grid[..., 1:4] * ell[..., None]],
                        dim=-1)
    unlit = dict(cfg, lighting=None, density_softplus=False)
    loss, g_lit = RT.loss_and_grad(lit, views, targets, pick, unlit,
                                   row_block, rows_of, loss_rows)
    del lit
    with torch.no_grad():
        d_grid = torch.cat([g_lit[..., :1], g_lit[..., 1:4] * ell[..., None]],
                           dim=-1)
        if shadows:
            d_ell = (g_lit[..., 1:4] * grid[..., 1:4]).sum(-1)
    del g_lit, ell
    if shadows:
        d_grid[..., 0] += light_grad(grid[..., 0], d_ell, light)
        del d_ell
    del grid
    if not softplus:
        return loss, d_grid
    leaf = params.detach().requires_grad_(True)
    with torch.enable_grad():
        RT.to_grid(leaf, True).backward(d_grid)
    return loss, leaf.grad


def follow(params0, views, targets, cfg, steps: int, seed: int,
           row_block: int = 128, fault=None):
    """:func:`vrbench.ref.train.follow` with the shadows differentiated:
    (each step's loss, the first gradient's leaf norms, the parameters'
    change's leaf norms after the steps, each view list). ``fault`` is
    one of that function's or 'detached'."""
    adam = RT.Adam(params0, cfg["lr"])
    p = params0.clone()
    losses, g_norms = [], None
    picks = RT.draws(views, cfg, steps, seed)
    loss_rows = rows_of = None
    if fault == "altered":
        targets = targets / 1.01  # the same MSE as images scaled by 1.01
    for pick in picks:
        if fault == "half_batch":
            if len(pick) > 1:
                pick = pick[:len(pick) // 2]
            else:
                loss_rows = targets.shape[1] // 2
        if fault == "no_exchange":
            rows_of = (0, views[pick[0]].plan.n_v // 4)
        loss, g = loss_and_grad(p, views, targets, pick, cfg, row_block,
                                rows_of, loss_rows, fault != "detached")
        if fault == "altered":
            loss, g = loss * 1.01 ** 2, g * 1.01 ** 2
        if g_norms is None:
            g_norms = RT.leaf_norms(g)
        losses.append(float(loss))
        p = adam.step(p, g)
        del g
    return losses, g_norms, RT.leaf_norms(p - params0), picks
