"""The plane sweep, its pixel warp and the sky light, in plain PyTorch.

Per slice k the four channels are resampled separably, ``A_k @ S @ B_k``
with tent operators ``A_k[i, y] = max(0, 1 - |i*ay + by - y|)`` and
``B_k[x, j] = max(0, 1 - |j*ax + bx - x|)``; density is rectified, gated by
the slice enables, and turned into ``att = exp(-s * sigma * dt)``; colour
and transmittance composite front to back. With ``eps`` > 0 a ray stops
once its own transmittance falls below ``eps``. Everything is
differentiable by autograd; the training reference takes its gradient in
blocks of rows, so that the kept activations fit.

The dense tent products are exact up to the f32 sums of two non-zero
terms, which is why TF32 must be off (:func:`strict_f32`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vrbench.ref.geometry import GRID_PERM, PT_PERM, sweep_layout


def strict_f32():
    """Full f32 matrix products: TF32 would keep about 3 digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tents(ay, by, ax, bx, rows, n_y, n_x, n_u):
    """(K, R, Y) row and (K, X, U) column tent operators of K slices for
    the lattice rows ``rows``: ``ay`` ... ``bx`` are (K,) f32 tensors, and
    positions are formed in f32 as a product and then a sum."""
    dev = ay.device
    iv = torch.arange(rows.start, rows.stop, dtype=torch.float32,
                      device=dev)[None, :, None]
    yy = torch.arange(n_y, dtype=torch.float32, device=dev)[None, None, :]
    mat_a = torch.clamp_min(
        1.0 - torch.abs(iv * ay[:, None, None] + by[:, None, None] - yy), 0.0)
    ju = torch.arange(n_u, dtype=torch.float32, device=dev)[None, None, :]
    xx = torch.arange(n_x, dtype=torch.float32, device=dev)[None, :, None]
    mat_b = torch.clamp_min(
        1.0 - torch.abs(ju * ax[:, None, None] + bx[:, None, None] - xx), 0.0)
    return mat_a, mat_b


def _exclusive_cumprod(x, first):
    """``first`` times the product of the planes before each plane."""
    return first * torch.cumprod(torch.cat([torch.ones_like(x[:1]), x[:-1]]),
                                 dim=0)


def march(grid_sc, coeffs, enables, dt, reverse: bool, eps: float,
          rows=None, sigma_scale: float = 1.0, chunk: int = 32):
    """Sweep the (S, 4, Y, X) grid over the lattice rows ``rows`` (a range;
    all by default). ``coeffs`` are four (S,) tensors and ``enables`` (S,),
    both in traversal order; ``dt`` is the whole (V, U) plane. Returns
    (rgb (3, R, U), transmittance (R, U)).

    ``chunk`` slices at a time are resampled together and composited by
    products along the slices: a slice's transmittance is that entering
    the chunk times the product of the attenuations before it. A ray is
    live at a slice while the transmittance entering it is at least
    ``eps``; until then the sweep with and without termination agree, so
    liveness is read from the product without it."""
    s, _, n_y, n_x = grid_sc.shape
    n_v, n_u = dt.shape
    rows = rows or range(n_v)
    dt = dt[rows.start:rows.stop]
    rgb = grid_sc.new_zeros((3, len(rows), n_u))
    trans = grid_sc.new_ones((len(rows), n_u))
    walk = grid_sc.flip(0) if reverse else grid_sc  # traversal order
    for k0, slices in zip(range(0, s, chunk), walk.split(chunk)):
        ks = slice(k0, k0 + len(slices))
        mat_a, mat_b = tents(*(c[ks] for c in coeffs), rows, n_y, n_x, n_u)
        smp = (mat_a[:, None] @ slices) @ mat_b[:, None]
        att = torch.exp(-((sigma_scale * torch.relu(smp[:, 0])) * dt))
        att = torch.where(enables[ks, None, None] > 0, att,
                          torch.ones_like(att))
        if eps > 0.0:
            live = _exclusive_cumprod(att, trans).detach() >= eps
            att = torch.where(live, att, torch.ones_like(att))
        t_in = _exclusive_cumprod(att, trans)
        rgb = rgb + ((t_in * (1.0 - att))[:, None] * smp[:, 1:4]).sum(0)
        trans = t_in[-1] * att[-1]
    return rgb, trans


def slice_enables(grid_sc, reverse: bool, occupancy: bool):
    """(S,) 0/1 in traversal order: a slice whose largest density is <= 0
    adds nothing (with occupancy on)."""
    if not occupancy:
        return grid_sc.new_ones(grid_sc.shape[0])
    en = (torch.amax(grid_sc[:, 0].detach(), dim=(1, 2)) > 0.0).float()
    return en.flip(0) if reverse else en


def warp(inter, lattice, uv):
    """Bilinear gather of the (V, U, C) intermediate image at the pixels'
    base-plane points ``uv`` (H, W, 2), taps clamped into the image."""
    n_v, n_u = inter.shape[0], inter.shape[1]
    x = (uv[..., 0] - lattice[0]) / lattice[1]
    y = (uv[..., 1] - lattice[2]) / lattice[3]
    x0 = torch.clamp(torch.floor(x), 0, n_u - 2)
    y0 = torch.clamp(torch.floor(y), 0, n_v - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    return (inter[y0, x0] * ((1 - fy) * (1 - fx))[..., None]
            + inter[y0, x0 + 1] * ((1 - fy) * fx)[..., None]
            + inter[y0 + 1, x0] * (fy * (1 - fx))[..., None]
            + inter[y0 + 1, x0 + 1] * (fy * fx)[..., None])


def inter_image(grid_sc, v, eps: float, occupancy: bool, rows=None):
    """One view's (R, U, 4) intermediate image (rgb, transmittance)."""
    en = slice_enables(grid_sc, v.plan.reverse, occupancy) * v.visible
    rgb, trans = march(grid_sc, v.coeffs, en, v.dt, v.plan.reverse, eps,
                       rows)
    return torch.cat([rgb, trans[None]], dim=0).permute(1, 2, 0)


def render(grid, v, eps: float, occupancy: bool):
    """One view of a (Z, Y, X, 4) grid: (H, W, 3) rgb and (H, W) T."""
    with torch.no_grad():
        img = warp(inter_image(sweep_layout(grid, v.plan.axis), v, eps,
                               occupancy), v.lattice, v.uv)
    return img[..., :3], img[..., 3]


# The sky light: L = (sky / N) sum_w exp(-tau_w), tau_w the optical depth
# from each voxel to the sky along hemisphere direction w, swept plane by
# plane from the sky side inward.

def hemisphere_dirs(n: int, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Fibonacci-spiral unit directions (n, 3) around ``up``."""
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
        vx = np.asarray([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                         [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx / (1.0 + float(a @ up))
    return local @ rot.T


def tau(sig_p, d_y: float, d_x: float, dt: float):
    """(S, Y, X) optical depth to the sky of a density whose plane index
    rises toward the sky: tau[S-1] = 0 and tau[k] is tau[k+1] +
    dt * relu(sigma[k+1]) shifted by (d_y, d_x) with tent weights."""
    s, n_y, n_x = sig_p.shape
    one = sig_p.new_ones(1)
    mat_a, mat_b = (m[0] for m in tents(one, one * d_y, one, one * d_x,
                                        range(n_y), n_y, n_x, n_x))
    out = torch.empty_like(sig_p)
    t = sig_p.new_zeros((n_y, n_x))
    out[s - 1] = t
    for k in range(s - 2, -1, -1):
        t = (mat_a @ (t + dt * torch.relu(sig_p[k + 1]))) @ mat_b
        out[k] = t
    return out


def light_volume(sigma, n_dirs: int, sky: float = 1.0, up=(0.0, 0.0, 1.0)):
    """(Z, Y, X) mean hemisphere transmittance of a density, times
    ``sky``."""
    total = torch.zeros_like(sigma)
    for w in hemisphere_dirs(n_dirs, up):
        axis = int(np.argmax(np.abs(w)))
        wp = w[list(PT_PERM[axis])]
        dz = abs(float(wp[2]))
        sig_p = sigma.permute(GRID_PERM[axis][:3])
        flip = bool(wp[2] < 0)
        if flip:
            sig_p = sig_p.flip(0)
        t = tau(sig_p.contiguous(), float(wp[1]) / dz, float(wp[0]) / dz,
                1.0 / dz)
        if flip:
            t = t.flip(0)
        inv = tuple(int(i) for i in np.argsort(GRID_PERM[axis][:3]))
        total += torch.exp(-t.permute(inv))
    return (sky / n_dirs) * total


def lit(grid, lighting):
    """The grid with the (detached) sky light multiplied into emission;
    ``lighting`` is None or the configuration's dict."""
    if not lighting:
        return grid
    with torch.no_grad():
        ell = light_volume(grid[..., 0].detach(), lighting["n_samples"],
                           lighting["sky_intensity"], lighting["up"])
    return torch.cat([grid[..., :1], grid[..., 1:4] * ell[..., None]], dim=-1)
