"""The fit's reference: the image loss of posed views, its gradient with
respect to the raw voxel parameters, and Adam, in plain PyTorch.

A step renders each view of its minibatch (softplus on the density when
the configuration says so, the detached sky light, the sweep, the pixel
warp), takes the mean over the views of each view's image MSE, and applies
``optax.adam``'s rule. Minibatches are drawn as the fit draws them: the
views grouped by sweep signature (axis, direction) in sorted order, a
numpy generator seeded with the fit's seed, one ``choice`` without
replacement per step, one group per step or per block of
``steps_per_call`` steps.

The gradient is taken in two passes so that it fits beside nothing
else: the whole intermediate image without autograd, the loss's
cotangent with respect to it, then blocks of rows re-marched under
autograd and back-propagated into one leaf in sweep layout, which is then
carried back through the layout, light and softplus at once.
"""

from __future__ import annotations

import numpy as np
import torch

from vrbench.ref import sweep
from vrbench.ref.geometry import sweep_layout


def softplus_inv(y: float) -> float:
    return float(np.log(np.expm1(y)))


def initial_params(cfg, device):
    """The fit's starting raw parameters: density ``init_density`` (through
    softplus when the configuration uses it) and emission
    ``init_emission``."""
    n = cfg["grid_n"]
    dens = cfg["init_density"]
    if cfg["density_softplus"]:
        dens = softplus_inv(dens)
    p = torch.full((n, n, n, 4), float(cfg["init_emission"]),
                   dtype=torch.float32, device=device)
    p[..., 0] = dens
    return p


def to_grid(params, softplus: bool):
    if not softplus:
        return params
    return torch.cat([torch.nn.functional.softplus(params[..., :1]),
                      params[..., 1:]], dim=-1)


def groups(views):
    """Sorted ((axis, reverse), [view indices]) of ``views``."""
    out = {}
    for i, v in enumerate(views):
        out.setdefault((v.plan.axis, v.plan.reverse), []).append(i)
    return sorted(out.items())


def draws(views, cfg, steps: int, seed: int):
    """The view indices of each of ``steps`` steps of one fit call."""
    grp = groups(views)
    rng = np.random.default_rng(seed)
    k_call = max(int(cfg["steps_per_call"]), 1)
    out = []
    step, blk = 0, 0
    while step < steps:
        if k_call == 1:
            key_i, n_done = step % len(grp), 1
        else:
            key_i, n_done = blk % len(grp), min(k_call, steps - step)
            blk += 1
        idxs = grp[key_i][1]
        k = min(cfg["views_per_batch"], len(idxs))
        for _ in range(n_done):
            pick = rng.choice(len(idxs), size=k, replace=False)
            out.append([idxs[int(j)] for j in pick])
        step += n_done
    return out


class Adam:
    """``optax.adam``: moments bias-corrected by 1 - b**count formed in
    float64 and rounded to f32; the update is -lr * mu_hat /
    (sqrt(nu_hat) + eps)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0

    def step(self, params, grads):
        self.mu = (1 - self.b1) * grads + self.b1 * self.mu
        self.nu = (1 - self.b2) * (grads * grads) + self.b2 * self.nu
        self.count += 1
        mu_hat = self.mu / float(np.float32(1 - self.b1 ** self.count))
        nu_hat = self.nu / float(np.float32(1 - self.b2 ** self.count))
        return params + (-self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))


def loss_and_grad(params, views, targets, pick, cfg, row_block: int,
                  rows_of=None, loss_rows=None):
    """The minibatch loss and its gradient with respect to ``params``.

    ``rows_of``: back-propagate only these intermediate rows of each view
    (a rank's rows, as when its gradient never meets the others').
    ``loss_rows``: take each view's MSE over the image rows [0, loss_rows)
    alone. Both plant faults; None is the fit itself."""
    eps, occ = cfg["early_stop_eps"], cfg["use_occupancy"]
    axis = views[pick[0]].plan.axis
    leaf = params.detach().requires_grad_(True)
    with torch.enable_grad():
        gsc = sweep_layout(sweep.lit(to_grid(leaf, cfg["density_softplus"]),
                                     cfg.get("lighting")), axis)
    gsc_leaf = gsc.detach().requires_grad_(True)
    total = 0.0
    for i in pick:
        v = views[i]
        with torch.no_grad():
            inter = sweep.inter_image(gsc_leaf, v, eps, occ)
        inter.requires_grad_(True)
        with torch.enable_grad():
            img = sweep.warp(inter, v.lattice, v.uv)[..., :3]
            err = (img - targets[i]) ** 2
            if loss_rows is not None:
                err = err[:loss_rows]
            loss_v = torch.mean(err)
            (d_inter,) = torch.autograd.grad(loss_v / len(pick), inter)
        total = total + loss_v.detach()
        n_v = inter.shape[0]
        lo, hi = rows_of or (0, n_v)
        for r0 in range(lo, hi, row_block):
            rows = range(r0, min(r0 + row_block, hi))
            with torch.enable_grad():
                blk = sweep.inter_image(gsc_leaf, v, eps, occ, rows)
                blk.backward(d_inter[rows.start:rows.stop])
    with torch.enable_grad():
        gsc.backward(gsc_leaf.grad)
    return total / len(pick), leaf.grad


def leaf_norms(x):
    """The four channels' (density, r, g, b) L2 norms, float64 numpy: the
    leaves the fit's comparison is taken over."""
    return np.array([float(torch.linalg.vector_norm(x[..., c].double()))
                     for c in range(x.shape[-1])])


def follow(params0, views, targets, cfg, steps: int, seed: int,
           row_block: int = 128, fault=None):
    """Follow the first ``steps`` steps of a fit call from ``params0``.
    Returns (each step's loss, the first gradient's leaf norms, the
    parameters' change's leaf norms after the steps, each view list).

    ``fault`` plants one in the reference put in the system's place:
    'half_batch' (half the minibatch's views left out, the mean over the
    rest; with one view, half its image rows), 'no_exchange' (the
    gradient of the first of 4 ranks' rows alone) or 'altered' (every
    image scaled by 1.01 where the sweep produces it)."""
    adam = Adam(params0, cfg["lr"])
    p = params0.clone()
    losses, g_norms = [], None
    picks = draws(views, cfg, steps, seed)
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
                                rows_of, loss_rows)
        if fault == "altered":
            loss, g = loss * 1.01 ** 2, g * 1.01 ** 2
        if g_norms is None:
            g_norms = leaf_norms(g)
        losses.append(float(loss))
        p = adam.step(p, g)
        del g
    return losses, g_norms, leaf_norms(p - params0), picks
