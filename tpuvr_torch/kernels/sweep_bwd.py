"""Backward sweep: the CUDA kernel ``csrc/sweep_bwd.cu`` and its wrapper.

:func:`sweep_bwd` has the signature of the plain twin
:func:`~tpuvr_torch.kernels.sweep_torch.sweep_bwd_torch` (and of the JAX
package's ``sweep_bwd``), one view or a view batch. For CUDA tensors it
launches the kernel (or raises); for CPU tensors it runs the twin, or
:func:`~tpuvr_torch.kernels.sweep_torch.sweep_bwd_views_torch` for a
view batch.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep import (
    _check,
    check_sweep,
    scalar_table,
    view_rows,
)
from tpuvr_torch.kernels.sweep_torch import (
    PRECISIONS,
    sweep_bwd_torch,
    sweep_bwd_views_torch,
    sweep_dbias,
)
from tpuvr_torch.utils import trace

# Kernel launches so far (one per call; each call issues two CUDA launches
# per slab of slices), by the view count of the call; a run reads it to
# show that it went through the kernel.
launches: collections.Counter[int] = collections.Counter()
trace.counter(lambda: {
    "sweep_bwd": launches[1],
    "sweep_bwd_views": sum(n for v, n in launches.items() if v > 1)})

# Cotangent samples held per slab: slab * V * U float4 of at most this many
# bytes (16 slices at the c4 minibatch). Measured on the H100: a shorter
# slab costs each of the ray stage's launches its carry's round trip and
# its ramp and tail, more than keeping dS in the 50 MB L2 gains.
_SLAB_BYTES = 128 << 20


_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int])


def _entry():
    return _build.entry("sweep_bwd", "tpuvr_sweep_bwd", _ARGTYPES)


def scratch_floats(s, slab, n_v, n_u, n_y, n_x, views):
    """Floats of the kernel's scratch: two dS buffers of slab * V * U
    float4 (one when one slab covers the sweep), then the voxel-line plan,
    a float4 of weights and an int2 ray range per (slice, view, voxel row
    or column)."""
    n_buf = 2 if s > slab else 1
    return 4 * n_buf * slab * n_v * n_u + 6 * s * views * (n_y + n_x)


def slab_slices(s: int, n_v: int, n_u: int) -> int:
    """Slices per slab: as many as keep the cotangent buffer within
    ``_SLAB_BYTES``."""
    return max(1, min(s, _SLAB_BYTES // (16 * n_v * n_u)))


def rays_reaching(c, a, b, n):
    """The rays [lo, hi] of n whose tent can reach voxel line c (an int or
    an array of them): |i*a + b - c| < 1 solved for i, widened by one ray
    each side; lo > hi where none can. ``csrc/tent.cuh``'s rays_reaching
    in f32, operation for operation."""
    f32 = np.float32
    cf = np.asarray(c).astype(f32)
    a, b = f32(a), f32(b)
    if abs(a) < f32(1e-30):
        hit = np.abs(b - cf) < f32(1.0)
        return np.where(hit, 0, 1), np.where(hit, n - 1, 0)
    r0 = (cf - f32(1.0) - b) / a
    r1 = (cf + f32(1.0) - b) / a
    top = f32(n) + f32(1.0)
    rmin = np.fmin(np.fmax(np.fmin(r0, r1), f32(-2.0)), top)
    rmax = np.fmin(np.fmax(np.fmax(r0, r1), f32(-2.0)), top)
    return (np.maximum(0, np.floor(rmin).astype(np.int64) - 1),
            np.minimum(n - 1, np.ceil(rmax).astype(np.int64) + 1))


def line_rays(c, a, b, n, cut_lo=0):
    """The rays whose tent can be non-zero at voxel line c, as (first,
    count): rays_reaching's band of n rays cut below at ``cut_lo``, then
    trimmed by bisection to the rays whose floor(i*a + b) is c - 1 or c
    (every other ray's tent weight at c is 0). They are consecutive, since
    the positions are monotone in i. ``csrc/sweep_bwd.cu``'s line_rays, the
    table the voxel stage gathers over, in f32 operation for operation; a
    tile's footprint is the union of its lines'."""
    f32 = np.float32
    a, b = f32(a), f32(b)
    lo, hi = rays_reaching(c, a, b, n)
    lo, hi = max(int(lo), cut_lo), int(hi)
    if lo > hi:
        return 0, 0
    s = f32(-1.0) if a < f32(0.0) else f32(1.0)
    t = f32(c - 1) if s > f32(0.0) else -f32(c)

    def first_key(lo, t):
        h = hi + 1
        while lo < h:
            m = (lo + h) >> 1
            if s * np.floor(f32(m) * a + b) >= t:
                h = m
            else:
                lo = m + 1
        return lo

    first = first_key(lo, t)
    return first, first_key(first, t + f32(2.0)) - first


def sweep_bwd(
    grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color, d_trans,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False, carry=None, views=1, out=None,
    row0=0,
):
    """Gradient of the forward sweep with respect to ``grid_sc``.

    Returns the (S, 4, Y, X) gradient, or ``(grad, (trans_fin, q_fin))``
    when a ``carry`` (trans0, q0) is given. ``out``: a contiguous float32
    tensor of ``grid_sc``'s shape that receives the gradient (the kernel
    writes it there; on the CPU the twin's result is copied in) and is
    returned as it. ``views`` > 1: a view batch as
    in :func:`~tpuvr_torch.kernels.sweep.sweep_fwd` (ray planes and carry
    stacked along V); the gradient is the sum over the views. ``row0``:
    the planes are a row tile, as in
    :func:`~tpuvr_torch.kernels.sweep.sweep_fwd`. With
    ``early_stop_eps`` > 0 the kernel gives a ray zero gradient after its
    own T < eps, as the forward kernel stops it there; the twin stops all
    rays (of a view) at the global maximum.
    """
    kw = dict(reverse=reverse, sigma_scale=sigma_scale,
              early_stop_eps=early_stop_eps, precision=precision,
              softplus=softplus, carry=carry, row0=row0)
    args = (grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color,
            d_trans)
    if not grid_sc.is_cuda:
        if views == 1:
            res = sweep_bwd_torch(*args, **kw)
        else:
            view_rows(views, dt_map.shape[0])
            res = sweep_bwd_views_torch(*args, views=views, **kw)
        if out is None:
            return res
        if carry is None:
            return out.copy_(res)
        return out.copy_(res[0]), res[1]
    s, n_y, n_x, n_v, n_u, v_pv = check_sweep(grid_sc, dt_map, precision,
                                              views)
    dev = grid_sc.device
    if carry is None:
        trans0 = torch.ones((n_v, n_u), dtype=torch.float32, device=dev)
        q0 = torch.zeros((n_v, n_u), dtype=torch.float32, device=dev)
    else:
        trans0, q0 = carry
    for name, t, shape in (
        ("grid_sc", grid_sc, grid_sc.shape), ("dt_map", dt_map, (n_v, n_u)),
        ("c_final", c_final, (3, n_v, n_u)), ("t_final", t_final, (n_v, n_u)),
        ("d_color", d_color, (3, n_v, n_u)), ("d_trans", d_trans, (n_v, n_u)),
        ("trans0", trans0, (n_v, n_u)), ("q0", q0, (n_v, n_u)),
    ):
        _check(name, t, shape, dev)
    scal = scalar_table(coeffs, enables, views, s, dev)
    dbias = sweep_dbias(d_color, c_final, d_trans, t_final).contiguous()
    grid_sc, dt_map, d_color, trans0, q0 = (
        t.contiguous() for t in (grid_sc, dt_map, d_color, trans0, q0))
    slab = slab_slices(s, n_v, n_u)
    ds = torch.empty(scratch_floats(s, slab, n_v, n_u, n_y, n_x, views),
                     dtype=torch.float32, device=dev)
    if out is None:
        grad = torch.empty_like(grid_sc)
    else:
        _check("out", out, grid_sc.shape, dev)
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
        grad = out
    trans_fin = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    q_fin = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    _build.launch(
        _entry(), dev, grid_sc.data_ptr(), scal.data_ptr(),
        dt_map.data_ptr(), dbias.data_ptr(), d_color.data_ptr(),
        trans0.data_ptr(), q0.data_ptr(), grad.data_ptr(),
        trans_fin.data_ptr(), q_fin.data_ptr(), ds.data_ptr(), slab, s, n_y,
        n_x, v_pv, n_u, views, int(row0), int(bool(reverse)),
        float(sigma_scale), float(early_stop_eps),
        PRECISIONS.index(precision), int(bool(softplus)))
    launches[views] += 1
    if carry is None:
        return grad
    return grad, (trans_fin, q_fin)
