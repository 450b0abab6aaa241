"""The lit grid's assembly after the light bake: the CUDA kernels
``csrc/light_apply.cu`` (K9 forward, K10 backward), their wrapper, its
counters and the plain twins.

  L = scale * sum_d exp(-tau_d),  lit = (sigma, r L, g L, b L)

with the taus of a direction table as the tau sweeps return them, each in
its sweep axis's layout (``GRID_PERM``), and scale = sky / N. The light
volume is detached: the gradient goes to the grid alone,
dgrid = (G0, G1 L, G2 L, G3 L). :func:`light_apply` runs the kernels for
every grid that :func:`takes` (one launch each way, one more forward
launch for each further :data:`MAX_DIRS` directions). The twins are the
ATen passes that ``ops.lighting`` takes on every other route, and the
kernels give their bits.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tpuvr_torch.kernels import _build
from tpuvr_torch.ref.march import GRID_PERM
from tpuvr_torch.utils import trace

MAX_DIRS = 64  # directions a K9 launch takes (its parameter table)

# K9 and K10 launches on the card ("fwd", "bwd"), and the calls of
# ``ops.lighting.apply_lighting`` that took the ATen passes instead
# ("fallback").
launches: collections.Counter[str] = collections.Counter()
trace.counter(lambda: {f"light_apply_{k}": launches[k]
                       for k in ("fwd", "bwd", "fallback")})

# grid, taus, axes, count, Z, Y, X, scale, carry_in, carry_out, lit, ell.
_FWD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_void_p] * 4)
# g, strides, ell, Z, Y, X, dgrid.
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def grid_order(axis):
    """The permutation that takes a field in sweep axis ``axis``'s layout
    back to (Z, Y, X)."""
    return tuple(int(i) for i in np.argsort(GRID_PERM[axis][:3]))


def light_value_torch(taus, axes, scale):
    """Plain twin of K9's light value: (Z, Y, X) ``scale * sum_d
    exp(-tau_d)``, the sum from 0 in table order, each tau brought back
    from sweep axis ``axes[d]``'s layout."""
    shape = taus[0].permute(grid_order(axes[0])).shape
    total = taus[0].new_zeros(shape)
    for axis, tau in zip(axes, taus):
        total = total + torch.exp(-tau.permute(grid_order(axis)))
    return scale * total


def lit_grid_torch(grid, ell):
    """The (Z, Y, X, 4) grid with its emission channels times the (Z, Y, X)
    light value ``ell``; density unchanged."""
    return torch.cat([grid[..., :1], grid[..., 1:4] * ell[..., None]],
                     dim=-1)


def light_apply_torch(grid, taus, axes, scale):
    """Plain twin of :func:`light_apply`: the ATen passes."""
    return lit_grid_torch(grid, light_value_torch(taus, axes, scale))


def takes(grid):
    """Whether :func:`light_apply` runs for ``grid``: a float32 tensor on
    the card, in any layout."""
    return grid.is_cuda and grid.dtype == torch.float32


def _check(grid, taus, axes):
    z, y, x = grid.shape[:3] if grid.dim() == 4 else (0, 0, 0)
    if grid.dim() != 4 or grid.shape[-1] != 4 or min(z, y, x) <= 0:
        raise ValueError(f"the grid must be (Z, Y, X, 4), got "
                         f"{tuple(grid.shape)}")
    if grid.dtype != torch.float32 or not grid.is_contiguous():
        raise ValueError("the grid must be contiguous float32")
    if grid.data_ptr() % 16:
        raise ValueError("the grid must be 16-byte aligned")
    if not 0 < len(taus) == len(axes):
        raise ValueError("one tau a direction, at least one")
    for tau, axis in zip(taus, axes):
        want = tuple((z, y, x)[i] for i in GRID_PERM[axis][:3])
        if (tuple(tau.shape) != want or tau.dtype != torch.float32
                or not tau.is_contiguous() or tau.device != grid.device):
            raise ValueError(f"a tau of sweep axis {axis} must be a "
                             f"contiguous float32 {want} on the grid's "
                             f"device, got {tuple(tau.shape)} {tau.dtype}")
        if tau.requires_grad:
            raise ValueError("the taus take no gradient here (the light "
                             "volume is detached)")


def _forward(grid, taus, axes, scale, keep):
    """K9: the lit grid, and L when ``keep``. Each run of MAX_DIRS
    directions but the last leaves its running sums in a carry that the
    next launch starts from."""
    _check(grid, taus, axes)
    z, y, x = grid.shape[:3]
    lit = torch.empty_like(grid)
    ell = grid.new_empty((z, y, x)) if keep else None
    carry = grid.new_empty((z, y, x)) if len(taus) > MAX_DIRS else None
    fn = _build.entry("light_apply", "tpuvr_light_apply_fwd", _FWD_ARGS)
    for d0 in range(0, len(taus), MAX_DIRS):
        run = taus[d0:d0 + MAX_DIRS]
        k = len(run)
        last = d0 + k == len(taus)
        _build.launch(fn, grid.device, grid.data_ptr(),
                      (ctypes.c_void_p * k)(*[t.data_ptr() for t in run]),
                      (ctypes.c_int * k)(*axes[d0:d0 + k]), k, z, y, x,
                      scale, carry.data_ptr() if d0 else None,
                      None if last else carry.data_ptr(), lit.data_ptr(),
                      ell.data_ptr() if keep and last else None)
        launches["fwd"] += 1
    return lit, ell


def _backward(g, ell):
    """K10: (G0, G1 L, G2 L, G3 L) of the cotangent ``g``, any view."""
    z, y, x = ell.shape
    if (tuple(g.shape) != (z, y, x, 4) or g.dtype != torch.float32
            or g.device != ell.device):
        raise ValueError(f"the cotangent must be float32 {(z, y, x, 4)}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    dgrid = torch.empty((z, y, x, 4), dtype=g.dtype, device=g.device)
    fn = _build.entry("light_apply", "tpuvr_light_apply_bwd", _BWD_ARGS)
    _build.launch(fn, g.device, g.data_ptr(),
                  (ctypes.c_longlong * 4)(*g.stride()), ell.data_ptr(), z, y,
                  x, dgrid.data_ptr())
    launches["bwd"] += 1
    return dgrid


class _LightApply(torch.autograd.Function):
    """K9 forward, K10 backward. L is written and saved only where the
    backward can run (``keep``)."""

    @staticmethod
    def forward(ctx, grid, axes, scale, keep, *taus):
        lit, ell = _forward(grid, taus, axes, scale, keep)
        if keep:
            ctx.save_for_backward(ell)
        ctx.n_taus = len(taus)
        return lit

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ell,) = ctx.saved_tensors
        return (_backward(g, ell), None, None, None,
                *([None] * ctx.n_taus))


def light_apply(grid, taus, axes, scale):
    """The lit grid from a (Z, Y, X, 4) grid and a direction table's taus:
    ``taus[d]`` in sweep axis ``axes[d]``'s layout (0: (X, Y, Z), 1:
    (Y, Z, X), 2: (Z, Y, X)), as ``kernels.lighting.tau_sweep_dirs``
    returns them, and ``scale`` = sky / N. Differentiable in the grid
    alone, through K9 and K10, for a grid that :func:`takes` (a grid that
    is not contiguous or not on a 16-byte boundary is copied first) and
    contiguous float32 taus that take no gradient; else ValueError.
    :func:`light_apply_torch` is its plain twin."""
    if not takes(grid):
        raise ValueError(f"the kernels take a float32 grid on the card, got "
                         f"{grid.dtype} on {grid.device}")
    if not grid.is_contiguous() or grid.data_ptr() % 16:
        grid = grid.clone(memory_format=torch.contiguous_format)
    keep = torch.is_grad_enabled() and grid.requires_grad
    return _LightApply.apply(grid, tuple(int(a) for a in axes),
                             float(scale), keep, *taus)
