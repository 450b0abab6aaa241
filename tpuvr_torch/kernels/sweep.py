"""Forward sweep: the CUDA kernel ``csrc/sweep_fwd.cu`` and its wrapper.

:func:`sweep_fwd` has the signature and layouts of the JAX package's
``sweep_fwd``, one view or a view batch. For CUDA tensors it launches the
kernel (or raises); for CPU tensors it runs the plain twin
:func:`sweep_fwd_torch`, or :func:`sweep_fwd_views_torch` for a view batch.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep_torch import (
    PRECISIONS,
    sweep_fwd_torch,
    sweep_fwd_views_torch,
)
from tpuvr_torch.utils import trace

# Kernel launches so far, by the view count of the launch; a run reads it to
# show that it went through the kernel.
launches: collections.Counter[int] = collections.Counter()
trace.counter(lambda: {
    "sweep_fwd": launches[1],
    "sweep_fwd_views": sum(n for v, n in launches.items() if v > 1)})

_MAX_SLICES = 2048  # (5, S) f32 per-slice scalars in shared memory
_MAX_VIEWS = 65535  # the kernels put the view on gridDim.z

# The forward kernel's ray tile and dense window (csrc/sweep_fwd.cu: kBlockV,
# kBlockU, kBoxRows, kWinCols): a block of TILE_V x TILE_U rays stages a
# slice's window through shared memory when it spans at most DENSE_ROWS x
# DENSE_COLS voxels ("dense"), and gathers ray by ray otherwise ("sparse").
TILE_V, TILE_U = 8, 32
DENSE_ROWS, DENSE_COLS = 12, 40
SKIP, DENSE, SPARSE = 0, 1, 2


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


def check_fwd(grid_sc, dt_map, precision, views):
    """check_sweep, and the forward kernel's 32-bit offsets within a
    (4, Y, X) slice."""
    dims = check_sweep(grid_sc, dt_map, precision, views)
    if 4 * dims[1] * dims[2] >= 2**31:
        raise ValueError(f"a (4, {dims[1]}, {dims[2]}) slice is past the "
                         "kernel's 32-bit offsets")
    return dims


def scalar_table(coeffs, enables, views, s, device):
    """The kernels' per-slice scalars (views, 5, S), after checking each
    (S,) input of one view or (views, S) input of a batch."""
    shape = (s,) if views == 1 else (views, s)
    for name, t in zip(("ay", "by", "ax", "bx", "enables"),
                       (*coeffs, enables)):
        _check(name, t, shape, device)
    return torch.stack((*coeffs, enables), dim=-2).reshape(views, 5, s)


def _rows(*arrays, dtype=None):
    """Arrays or tensors as numpy, (S,) taken as one view's (1, S)."""
    return tuple(np.atleast_2d(np.asarray(
        x.cpu() if hasattr(x, "cpu") else x, dtype=dtype)) for x in arrays)


def _axis_windows(a, b, n_rays, tile, n_vox, row0=0):
    """Per (view, slice, tile) of one axis: the first voxel line, the line
    count and whether any ray of the tile lies in the tents' support,
    (-1, n_vox); from the tile's first and last ray, with the kernel's f32
    position formula (a product, then a sum)."""
    first = np.arange(0, n_rays, tile)
    last = np.minimum(first + tile - 1, n_rays - 1)
    fa = (first + row0).astype(np.float32)
    fb = (last + row0).astype(np.float32)
    pa = a[..., None] * fa + b[..., None]
    pb = a[..., None] * fb + b[..., None]
    lo_p, hi_p = np.minimum(pa, pb), np.maximum(pa, pb)
    hit = (hi_p > -1.0) & (lo_p < np.float32(n_vox))
    with np.errstate(invalid="ignore"):
        lo = np.maximum(np.floor(lo_p), -1.0)
        hi = np.minimum(np.floor(hi_p) + 1.0, float(n_vox))
    lines = np.where(hit, hi - lo + 1.0, 0.0).astype(np.int64)
    return np.where(hit, lo, 0.0).astype(np.int64), lines, hit


def tile_windows(coeffs, enables, n_y, n_x, v_pv, n_u, row0=0):
    """The forward kernel's per-(tile, slice) windows and regimes, in numpy
    (for reports and tests; the kernel computes its own).

    ``coeffs`` (ay, by, ax, bx) and ``enables`` are (S,) for one view or
    (views, S) for a batch, arrays or tensors; the image is ``v_pv`` x
    ``n_u`` rays a view, rows [row0, row0 + v_pv). A block of TILE_V x
    TILE_U rays takes, per slice, the voxel rows [y_lo, y_lo + rows) and
    columns [x_lo, x_lo + cols) that its rays' taps can reach inside
    [-1, n]. Returns a dict of (views, S, tiles_v) row arrays ``y_lo``,
    ``rows``, (views, S, tiles_u) column arrays ``x_lo``, ``cols`` and the
    (views, S, tiles_v, tiles_u) ``regime``: SKIP (slice disabled, or no
    ray of the tile in range), DENSE (the window spans at most DENSE_ROWS x
    DENSE_COLS voxels, and X is a multiple of 4 so that the grid's rows
    are 16-B aligned for the copy engine) or SPARSE.
    """
    ay, by, ax, bx = _rows(*coeffs, dtype=np.float32)
    (en,) = _rows(enables)
    y_lo, rows, y_hit = _axis_windows(ay, by, v_pv, TILE_V, n_y, row0)
    x_lo, cols, x_hit = _axis_windows(ax, bx, n_u, TILE_U, n_x)
    on = (en != 0)[..., None, None] & y_hit[..., :, None] & x_hit[
        ..., None, :]
    fits = ((rows <= DENSE_ROWS)[..., :, None] & (cols <= DENSE_COLS)[
        ..., None, :]) & (n_x % 4 == 0)
    regime = np.where(on, np.where(fits, DENSE, SPARSE), SKIP).astype(
        np.int8)
    return {"y_lo": y_lo, "rows": rows, "x_lo": x_lo, "cols": cols,
            "regime": regime}


def window_stats(coeffs, enables, n_y, n_x, v_pv, n_u, row0=0):
    """Geometry counts of one sweep, from :func:`tile_windows` and the
    rays' f32 positions: the slopes' range over enabled slices, ray-slices
    of enabled slices, those inside the tents' support, the share of
    (warp of 32 rays, enabled slice) pairs with a ray in range, taps a
    voxel per enabled slice and view, the mean window (rows, cols) over
    non-skipped (tile, slice) pairs and the regime shares of all (tile,
    slice) pairs."""
    tw = tile_windows(coeffs, enables, n_y, n_x, v_pv, n_u, row0)
    ay, by, ax, bx = _rows(*coeffs, dtype=np.float32)
    en = _rows(enables)[0] != 0
    py = (ay[..., None] * np.arange(row0, row0 + v_pv, dtype=np.float32)
          + by[..., None])
    px = ax[..., None] * np.arange(n_u, dtype=np.float32) + bx[..., None]
    iy = (py > -1.0) & (py < n_y)
    ix = (px > -1.0) & (px < n_x)
    in_y, in_x = iy.sum(-1), ix.sum(-1)
    support = int((en * in_y * in_x).sum())
    pad = np.zeros((*ix.shape[:-1], -n_u % 32), dtype=bool)
    warps_x = np.concatenate((ix, pad), -1).reshape(
        *ix.shape[:-1], -1, 32).any(-1)
    warp_hit = (en[..., None, None] & iy[..., :, None]
                & warps_x[..., None, :])
    n_on = int(en.sum())
    reg = tw["regime"]
    live = reg != SKIP
    rows = np.broadcast_to(tw["rows"][..., :, None], reg.shape)[live]
    cols = np.broadcast_to(tw["cols"][..., None, :], reg.shape)[live]
    slopes = (np.abs(ay[en]), np.abs(ax[en]))
    return {
        "ay_abs": [float(slopes[0].min()), float(slopes[0].max())]
        if n_on else None,
        "ax_abs": [float(slopes[1].min()), float(slopes[1].max())]
        if n_on else None,
        "ray_slices": n_on * v_pv * n_u,
        "in_support": support,
        "warp_slices_in_range": float(warp_hit.sum()) / max(
            n_on * v_pv * warps_x.shape[-1], 1),
        "taps_per_voxel": 4.0 * support / max(n_on * n_y * n_x, 1),
        "window_mean": [float(rows.mean()), float(cols.mean())]
        if rows.size else None,
        "regime_shares": {name: float((reg == r).mean()) for name, r in
                          (("skip", SKIP), ("dense", DENSE),
                           ("sparse", SPARSE))},
    }


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
    s, n_y, n_x, n_v, n_u, v_pv = check_fwd(grid_sc, dt_map, precision,
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
