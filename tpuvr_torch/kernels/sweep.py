"""Forward sweep: the CUDA kernel ``csrc/sweep_fwd.cu`` and its wrapper.

:func:`sweep_fwd` has the signature and layouts of the JAX package's
``sweep_fwd``, one view or a view batch. For CUDA tensors it launches the
kernel (or raises); for CPU tensors it runs the plain twin
:func:`sweep_fwd_torch`, or :func:`sweep_fwd_views_torch` for a view batch.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep_torch import (
    PRECISIONS,
    sweep_fwd_torch,
    sweep_fwd_views_torch,
)

# Kernel launches so far, by the view count of the launch; a run reads it to
# show that it went through the kernel.
launches: collections.Counter[int] = collections.Counter()

_MAX_SLICES = 2048  # (5, S) f32 per-slice scalars stay within 48 KB smem
_MAX_VIEWS = 65535  # the kernels put the view on gridDim.z


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int])


def _entry():
    return _build.entry("sweep_fwd", "tpuvr_sweep_fwd", _ARGTYPES)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, grid on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def view_rows(views: int, n_v: int) -> int:
    """Rows per view of a stacked (views * rows, U) plane."""
    if not 1 <= views <= _MAX_VIEWS:
        raise ValueError(f"{views} views; the kernel takes 1..{_MAX_VIEWS}")
    if n_v % views:
        raise ValueError(f"{n_v} stacked rows are not {views} equal views")
    return n_v // views


def check_sweep(grid_sc, dt_map, precision, views):
    """Validate a sweep's grid, image and precision for the kernels.
    Returns (S, Y, X, V, U, V per view)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if grid_sc.dim() != 4 or grid_sc.shape[1] != 4:
        raise ValueError(f"grid_sc must be (S, 4, Y, X), got "
                         f"{tuple(grid_sc.shape)}")
    s, _, n_y, n_x = grid_sc.shape
    if not 0 < s <= _MAX_SLICES:
        raise ValueError(f"{s} slices; the kernel takes 1..{_MAX_SLICES}")
    if dt_map.dim() != 2:
        raise ValueError(f"dt_map must be (V, U), got {tuple(dt_map.shape)}")
    n_v, n_u = dt_map.shape
    if min(n_y, n_x, n_v, n_u) <= 0:
        raise ValueError("empty grid plane or image")
    return s, n_y, n_x, n_v, n_u, view_rows(views, n_v)


def scalar_table(coeffs, enables, views, s, device):
    """The kernels' per-slice scalars (views, 5, S), after checking each
    (S,) input of one view or (views, S) input of a batch."""
    shape = (s,) if views == 1 else (views, s)
    for name, t in zip(("ay", "by", "ax", "bx", "enables"),
                       (*coeffs, enables)):
        _check(name, t, shape, device)
    return torch.stack((*coeffs, enables), dim=-2).reshape(views, 5, s)


def sweep_fwd(
    grid_sc, coeffs, enables, dt_map,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False, views=1, row0=0,
):
    """Forward sweep. Returns (rgb (3, V, U), trans (V, U)).

    grid_sc: (S, 4, Y, X); coeffs: (ay, by, ax, bx), four (S,) tensors in
    traversal order; enables: (S,) 0/1 in traversal order; dt_map: (V, U).
    ``softplus``: the density channel holds raw parameters, softplus'd
    per tap before resampling.
    ``views`` > 1: a view batch, as the JAX package's: coeffs and enables
    are (views, S), and dt_map and the outputs stack the views' planes
    along V (row r is row r % (V / views) of view r // (V / views)).
    ``row0``: the planes hold rows [row0, row0 + V / views) of each view's
    image, row v sampling where the whole image's row row0 + v does (one
    rank's row tile; 0 is the whole image).
    With ``early_stop_eps`` > 0 the kernel stops each ray at its own
    T < eps; the twin stops all rays (of a view) at the global max, and
    the two agree within eps * max|colour| (see the kernel source).
    """
    kw = dict(reverse=reverse, sigma_scale=sigma_scale,
              early_stop_eps=early_stop_eps, precision=precision,
              softplus=softplus, row0=row0)
    if not grid_sc.is_cuda:
        if views == 1:
            return sweep_fwd_torch(grid_sc, coeffs, enables, dt_map, **kw)
        view_rows(views, dt_map.shape[0])
        return sweep_fwd_views_torch(grid_sc, coeffs, enables, dt_map,
                                     views=views, **kw)
    s, n_y, n_x, n_v, n_u, v_pv = check_sweep(grid_sc, dt_map, precision,
                                              views)
    dev = grid_sc.device
    _check("grid_sc", grid_sc, grid_sc.shape, dev)
    _check("dt_map", dt_map, (n_v, n_u), dev)
    scal = scalar_table(coeffs, enables, views, s, dev)
    if not (grid_sc.is_contiguous() and dt_map.is_contiguous()):
        raise ValueError("grid_sc and dt_map must be contiguous")
    rgb = torch.empty((3, n_v, n_u), dtype=torch.float32, device=dev)
    trans = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    _build.launch(
        _entry(), dev, grid_sc.data_ptr(), scal.data_ptr(),
        dt_map.data_ptr(), rgb.data_ptr(), trans.data_ptr(), s, n_y, n_x,
        v_pv, n_u, views, int(row0), int(bool(reverse)), float(sigma_scale),
        float(early_stop_eps), PRECISIONS.index(precision),
        int(bool(softplus)))
    launches[views] += 1
    return rgb, trans
