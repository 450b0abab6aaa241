"""The row-block pixel warp: the opt-in training-path warp (``TPUVR_WARP=rows``).

A perspective view's intermediate image is a lattice on the sweep's base
plane; the final warp resamples it bilinearly at every pixel's lattice
position. Here the output pixels are cut into (ty, tx) tiles, and each
tile reads the ``(f_v, U)`` row window of the channels-first ``(C, V, U)``
lattice image at a per-(view, tile) origin that is a multiple of 8. The
plan is host-side numpy (cameras are static) and is the JAX package's
(``tpuvr/ops/warp.py``, copied here so the port imports nothing of it),
bit for bit; the resample and its transpose are the kernels of
``tpuvr_torch.kernels.warp`` (the plain twins on CPU tensors).

The warp takes the same taps with the same weights as the 4-tap gather
(``tpuvr_torch.ops.geometry.warp_to_pixels_dynamic``), so the two agree to
f32 roundoff.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpuvr_torch.kernels.warp import warp_rows_bwd, warp_rows_fwd
from tpuvr_torch.kernels.warp_torch import (
    warp_rows_bwd_torch,
    warp_rows_fwd_torch,
)


class RowWarpPlan(NamedTuple):
    """Static plan of a view group's row-block warp: output pixels cut into
    (ty, tx) tiles, each reading an ``(f_v, U)`` window of the lattice."""

    ty: int
    tx: int
    f_v: int
    res_y: int
    res_x: int


_ROW_WARP_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    # row blocks (best when lattice rows track pixel rows) ...
    (8, 0), (16, 0), (32, 0), (64, 0),
    # ... and 2-D tiles for diagonal mappings (v varies along both pixel
    # axes, as in the steep 45-degree-azimuth orbit groups).
    (8, 128), (16, 64), (64, 16), (32, 32), (128, 8),
)


def lattice_positions(lattice, uv_pixel: np.ndarray, n_v: int, n_u: int):
    """Pixel base-plane points (H, W, 2) -> clipped lattice-unit positions
    (y, x), each (H, W), in the dtype of ``uv_pixel``."""
    u0, du, v0, dv = lattice
    x = (uv_pixel[..., 0] - u0) / du
    y = (uv_pixel[..., 1] - v0) / dv
    return np.clip(y, 0, n_v - 1), np.clip(x, 0, n_u - 1)


def _tiles(arr: np.ndarray, ty: int, tx: int) -> np.ndarray:
    """(res_y, res_x) -> (n_tiles, ty*tx), row-major tile order."""
    gy, gx = arr.shape[0] // ty, arr.shape[1] // tx
    return (
        arr.reshape(gy, ty, gx, tx)
        .transpose(0, 2, 1, 3)
        .reshape(gy * gx, ty * tx)
    )


def plan_row_warp(pos_views, n_v: int, n_u: int,
                  candidates: Sequence[Tuple[int, int]] = _ROW_WARP_CANDIDATES):
    """Plan the row-block warp for a view group.

    ``pos_views``: list of (y_pos, x_pos) (res_y, res_x) position maps
    (numpy). Picks the pixel tile minimizing the window height F (ties
    prefer fewer tiles); ``TPUVR_WARP_ROWS=TYxTX`` forces one tile (TX 0
    for full-width row blocks). Returns ``(plan, vb (views, n_tiles)
    int32, y_flat (views, n_tiles, P), x_flat (views, n_tiles, P))``, or
    None when V is not a multiple of 8 or no candidate gives a window
    shorter than V (callers keep the 4-tap gather).
    """
    res_y, res_x = pos_views[0][0].shape
    if n_v % 8:
        return None
    override = os.environ.get("TPUVR_WARP_ROWS")
    if override:
        ty, tx = (int(s) for s in override.split("x"))
        candidates = ((ty, tx),)
    best = None
    for ty, tx in candidates:
        tx = tx or res_x
        if res_y % ty or res_x % tx:
            continue
        n_tiles = (res_y // ty) * (res_x // tx)
        span = 0
        for y_pos, _ in pos_views:
            yb = _tiles(y_pos, ty, tx)
            lo = np.floor(yb.min(axis=1))
            hi = np.floor(yb.max(axis=1)) + 1
            span = max(span, int((hi - lo).max()) + 1)
        f_v = min(-(-(span + 7) // 8) * 8, n_v)
        key = (f_v, n_tiles)
        if best is None or key < best[0]:
            best = (key, RowWarpPlan(ty, tx, f_v, res_y, res_x))
    if best is None or best[1].f_v >= n_v:
        return None
    plan = best[1]
    vbs, ys, xs = [], [], []
    for y_pos, x_pos in pos_views:
        yb = _tiles(y_pos, plan.ty, plan.tx)
        lo = np.floor(yb.min(axis=1)).astype(np.int64)
        vb = np.clip((lo // 8) * 8, 0, n_v - plan.f_v).astype(np.int32)
        vbs.append(vb)
        ys.append(yb.astype(np.float32))
        xs.append(_tiles(x_pos, plan.ty, plan.tx).astype(np.float32))
    return plan, np.stack(vbs), np.stack(ys), np.stack(xs)


def row_warp_image(out, plan: RowWarpPlan):
    """(C, n_tiles, P) warp output -> (C, res_y, res_x) image."""
    n_c = out.shape[0]
    gy, gx = plan.res_y // plan.ty, plan.res_x // plan.tx
    return (
        out.reshape(n_c, gy, gx, plan.ty, plan.tx)
        .permute(0, 1, 3, 2, 4)
        .reshape(n_c, plan.res_y, plan.res_x)
    )


class _RowWarp(torch.autograd.Function):
    """(inter, y_t, x_t, vb) -> (C, n_tiles, P); the gradient flows to the
    lattice image only (positions and origins are geometry)."""

    @staticmethod
    def forward(ctx, inter, y_t, x_t, vb, spec):
        fwd, _, f_v = spec
        ctx.save_for_backward(y_t, x_t, vb)
        ctx.spec = spec
        ctx.lattice = tuple(inter.shape[1:])
        return fwd(inter, y_t, x_t, vb, f_v=f_v)

    @staticmethod
    def backward(ctx, d_out):
        y_t, x_t, vb = ctx.saved_tensors
        _, bwd, f_v = ctx.spec
        d_inter = None
        if ctx.needs_input_grad[0]:
            d_inter = bwd(d_out.contiguous(), y_t, x_t, vb, *ctx.lattice,
                          f_v=f_v)
        return d_inter, None, None, None, None


def row_warp_op(f_v: int, impl: str):
    """Differentiable row-block warp: ``(inter (C, V, U), y_t, x_t, vb) ->
    (C, n_tiles, P)``. ``impl`` 'cuda' runs the CUDA kernels both ways (a
    failed build or launch raises), 'torch' the plain twins."""
    if impl == "cuda":
        fwd, bwd = warp_rows_fwd, warp_rows_bwd
    elif impl == "torch":
        fwd, bwd = warp_rows_fwd_torch, warp_rows_bwd_torch
    else:
        raise ValueError(f"unknown warp impl: {impl!r}")
    spec = (fwd, bwd, int(f_v))

    def op(inter, y_t, x_t, vb):
        return _RowWarp.apply(inter, y_t, x_t, vb, spec)

    return op
