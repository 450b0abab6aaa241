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

# Kernel launches so far (one per call; each call issues two CUDA launches
# per slab of slices), by the view count of the call; a run reads it to
# show that it went through the kernel.
launches: collections.Counter[int] = collections.Counter()

# Cotangent samples held per slab: slab * V * U float4, at most this many
# floats (64 MB).
_SLAB_FLOATS = 1 << 24


def _entry():
    fn = _build.load("sweep_bwd").tpuvr_sweep_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def slab_slices(s: int, n_v: int, n_u: int) -> int:
    """Slices per slab: as many as keep the cotangent buffer within
    ``_SLAB_FLOATS``."""
    return max(1, min(s, _SLAB_FLOATS // (4 * n_v * n_u)))


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
    ds = torch.empty((slab, n_v, n_u, 4), dtype=torch.float32, device=dev)
    if out is None:
        grad = torch.empty_like(grid_sc)
    else:
        _check("out", out, grid_sc.shape, dev)
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
        grad = out
    trans_fin = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    q_fin = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            grid_sc.data_ptr(), scal.data_ptr(), dt_map.data_ptr(),
            dbias.data_ptr(), d_color.data_ptr(), trans0.data_ptr(),
            q0.data_ptr(), grad.data_ptr(), trans_fin.data_ptr(),
            q_fin.data_ptr(), ds.data_ptr(), slab, s, n_y, n_x, v_pv, n_u,
            views, int(row0), int(bool(reverse)),
            float(sigma_scale), float(early_stop_eps),
            PRECISIONS.index(precision), int(bool(softplus)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sweep_bwd kernel launch failed: CUDA error {err}")
    launches[views] += 1
    if carry is None:
        return grad
    return grad, (trans_fin, q_fin)
