"""The lit grid's assembly after the light bake: the CUDA kernels
``csrc/light_apply.cu`` (K9 forward; K10 backward of a detached light
volume; K11 and K12 around the tau sweeps' adjoint K4 when the shadows take
a gradient), their wrappers, their counters and the plain twins.

  L = scale * sum_d exp(-tau_d),  lit = (sigma, r L, g L, b L)

with the taus of a direction table as the tau sweeps return them, each in
its sweep axis's layout (``GRID_PERM``), and scale = sky / N. With the light
volume detached the gradient goes to the grid alone,
dgrid = (G0, G1 L, G2 L, G3 L): :func:`light_apply` runs K9 and K10 for
every grid that :func:`takes` (one launch each way, one more forward
launch for each further :data:`MAX_DIRS` directions). With the shadows
differentiated (``ops.lighting``'s shadow route), :func:`shadow_cotangents`
(K11) gives dgrid and writes each tau's cotangent over it, and after K4
:func:`mask_sum` (K12) adds the masked adjoints into dgrid's density
channel. The twins are the ATen passes that ``ops.lighting`` takes on every
other route, and the kernels give their bits.
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

MAX_DIRS = 64  # directions a launch takes (the kernels' parameter table)

# K9, K10, K11 and K12 launches on the card ("fwd", "bwd", "shadow_bwd",
# "mask"), and the calls of ``ops.lighting.apply_lighting`` that took the
# ATen passes instead ("fallback").
launches: collections.Counter[str] = collections.Counter()
trace.counter(lambda: {f"light_apply_{k}": launches[k]
                       for k in ("fwd", "bwd", "shadow_bwd", "mask",
                                 "fallback")})

# grid, taus, axes, count, Z, Y, X, scale, carry_in, carry_out, lit, ell.
_FWD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_void_p] * 4)
# g, strides, ell, Z, Y, X, dgrid.
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# g, strides, grid, taus, axes, count, Z, Y, X, scale, split, carry_in,
# carry_out, dgrid.
_SHADOW_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)
# adjs, axes, count, sigma, strides, Z, Y, X, carry_in, carry_out, dgrid.
_MASK_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)


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
    """Plain twin of :func:`light_apply` and :func:`light_apply_fwd`: the
    ATen passes."""
    return lit_grid_torch(grid, light_value_torch(taus, axes, scale))


def shadow_cotangents_torch(g, grid, taus, axes, scale):
    """Plain twin of :func:`shadow_cotangents`: the ATen passes of
    autograd's chain back from the lit grid's cotangent ``g`` through
    :func:`lit_grid_torch` and :func:`light_value_torch`, in its order.
    Returns dgrid and writes each tau's cotangent,
    ``-((gL * scale) * exp(-tau))`` with ``gL`` the emission multiply's
    sum over the channels, over the tau."""
    ell = light_value_torch(taus, axes, scale)
    gs = (g[..., 1:4] * grid[..., 1:4]).sum(-1) * scale
    for axis, tau in zip(axes, taus):
        tau.copy_(-(gs.permute(GRID_PERM[axis][:3]) * torch.exp(-tau)))
    return torch.cat([g[..., :1], g[..., 1:4] * ell[..., None]], dim=-1)


def mask_sum_torch(dgrid, adjs, axes, sigma):
    """Plain twin of :func:`mask_sum`: ``dgrid[..., 0] += sum_d [sigma > 0]
    adjs[d]``, each adjoint brought back from its sweep axis's layout, the
    sum from the last direction to the first."""
    dsig = None
    for axis, adj in zip(axes[::-1], adjs[::-1]):
        d = adj.permute(grid_order(axis))
        term = torch.where(sigma > 0.0, d, torch.zeros_like(d))
        dsig = term if dsig is None else dsig + term
    dgrid[..., 0] += dsig


def takes(grid):
    """Whether :func:`light_apply` runs for ``grid``: a float32 tensor on
    the card, in any layout."""
    return grid.is_cuda and grid.dtype == torch.float32


def aligned(grid):
    """``grid``, or a contiguous copy of it (differentiable, so the gradient
    reaches the original) where it is not contiguous or not on a 16-byte
    boundary."""
    if not grid.is_contiguous() or grid.data_ptr() % 16:
        return grid.clone(memory_format=torch.contiguous_format)
    return grid


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


def _runs(fields, axes, reverse=False):
    """The launches of a direction table, one a run of MAX_DIRS directions,
    first to last (last to first with ``reverse``): for each, the C entries'
    field pointers, axes and count, and whether a run went before it and
    whether one comes after it (then it leaves its sums in a carry that the
    next launch starts from)."""
    starts = list(range(0, len(fields), MAX_DIRS))
    if reverse:
        starts.reverse()
    for i, d0 in enumerate(starts):
        run = fields[d0:d0 + MAX_DIRS]
        k = len(run)
        table = ((ctypes.c_void_p * k)(*[f.data_ptr() for f in run]),
                 (ctypes.c_int * k)(*axes[d0:d0 + k]), k)
        yield table, i > 0, i + 1 < len(starts)


def _carry(grid, n):
    """The (Z, Y, X) carry between the launches of ``n`` directions, or
    None where one launch takes them."""
    return grid.new_empty(grid.shape[:3]) if n > MAX_DIRS else None


def _forward(grid, taus, axes, scale, keep):
    """K9: the lit grid, and L when ``keep``."""
    _check(grid, taus, axes)
    z, y, x = grid.shape[:3]
    lit = torch.empty_like(grid)
    ell = grid.new_empty((z, y, x)) if keep else None
    carry = _carry(grid, len(taus))
    fn = _build.entry("light_apply", "tpuvr_light_apply_fwd", _FWD_ARGS)
    for table, after, more in _runs(taus, axes):
        _build.launch(fn, grid.device, grid.data_ptr(), *table, z, y, x,
                      scale, carry.data_ptr() if after else None,
                      carry.data_ptr() if more else None, lit.data_ptr(),
                      None if more or not keep else ell.data_ptr())
        launches["fwd"] += 1
    return lit, ell


def _check_cotangent(g, shape, device):
    if (tuple(g.shape) != shape or g.dtype != torch.float32
            or g.device != device):
        raise ValueError(f"the cotangent must be float32 {shape}, "
                         f"got {tuple(g.shape)} {g.dtype}")


def _backward(g, ell):
    """K10: (G0, G1 L, G2 L, G3 L) of the cotangent ``g``, any view."""
    z, y, x = ell.shape
    _check_cotangent(g, (z, y, x, 4), ell.device)
    dgrid = torch.empty((z, y, x, 4), dtype=g.dtype, device=g.device)
    fn = _build.entry("light_apply", "tpuvr_light_apply_bwd", _BWD_ARGS)
    _build.launch(fn, g.device, g.data_ptr(),
                  (ctypes.c_longlong * 4)(*g.stride()), ell.data_ptr(), z, y,
                  x, dgrid.data_ptr())
    launches["bwd"] += 1
    return dgrid


def light_apply_fwd(grid, taus, axes, scale):
    """K9 alone: the lit grid, with L neither written nor kept and no
    gradient, for a contiguous 16-byte aligned float32 grid on the card and
    the taus as :func:`light_apply` takes them. Its twin is
    :func:`light_apply_torch`."""
    return _forward(grid, taus, axes, scale, False)[0]


def channels_split(g):
    """Whether the card's sum over the channels of ATen's product of the
    (Z, Y, X, 4) cotangent ``g``'s emission channels with a contiguous
    grid's splits the three over two lanes, ((a + c) + b), where it
    otherwise sums them in order, ((a + b) + c). TensorIterator lays the
    product out in the order of ``g``'s strides (ties and zeros go to the
    grid's, whose channels are innermost) and splits the sum where the
    channels' stride is below that of the output's fastest dimension: x,
    or the next of size above 1."""
    sc = g.stride(3)
    for d in (2, 1, 0):
        if g.shape[d] > 1:
            sd = g.stride(d)
            return not (sc and sd and sc > sd)
    return True


def shadow_cotangents(g, grid, taus, axes, scale):
    """K11: the grid's gradient (G0, G1 L, G2 L, G3 L) from the lit grid's
    cotangent ``g`` (any view), with L recomputed from the taus, and each
    tau's cotangent ``-((gL * scale) * exp(-tau))``, gL = G1 r + G2 g + G3 b
    summed as ATen sums it on the card (:func:`channels_split`),
    written over the tau in its layout (what ``tau_sweep_adj_dirs`` reads).
    The grid and the taus as :func:`light_apply_fwd` takes them: one launch
    a run of MAX_DIRS directions, as K9's. Its twin is
    :func:`shadow_cotangents_torch`."""
    _check(grid, taus, axes)
    z, y, x = grid.shape[:3]
    _check_cotangent(g, (z, y, x, 4), grid.device)
    dgrid = torch.empty_like(grid)
    carry = _carry(grid, len(taus))
    strides = (ctypes.c_longlong * 4)(*g.stride())
    split = int(channels_split(g))
    fn = _build.entry("light_apply", "tpuvr_light_shadow_bwd", _SHADOW_ARGS)
    for table, after, more in _runs(taus, axes):
        _build.launch(fn, grid.device, g.data_ptr(), strides, grid.data_ptr(),
                      *table, z, y, x, scale, split,
                      carry.data_ptr() if after else None,
                      carry.data_ptr() if more else None, dgrid.data_ptr())
        launches["shadow_bwd"] += 1
    return dgrid


def mask_sum(dgrid, adjs, axes, sigma):
    """K12: adds ``sum_d [sigma > 0] adjs[d]``, from the last direction to
    the first, into channel 0 of ``dgrid`` (in place). ``adjs`` are
    ``tau_sweep_adj_dirs``' outputs, laid out as the taus, one launch a run
    of MAX_DIRS directions, the last run first; ``sigma`` a (Z, Y, X)
    float32 view on the card, any strides (the z sweep's copy, or the
    grid's channel 0). Its twin is :func:`mask_sum_torch`."""
    _check(dgrid, adjs, axes)
    z, y, x = dgrid.shape[:3]
    if (tuple(sigma.shape) != (z, y, x) or sigma.dtype != torch.float32
            or sigma.device != dgrid.device):
        raise ValueError(f"sigma must be float32 {(z, y, x)} on the "
                         f"gradient's device, got {tuple(sigma.shape)} "
                         f"{sigma.dtype}")
    carry = _carry(dgrid, len(adjs))
    strides = (ctypes.c_longlong * 3)(*sigma.stride())
    fn = _build.entry("light_apply", "tpuvr_light_mask", _MASK_ARGS)
    for table, after, more in _runs(adjs, axes, reverse=True):
        _build.launch(fn, dgrid.device, *table, sigma.data_ptr(), strides,
                      z, y, x, carry.data_ptr() if after else None,
                      carry.data_ptr() if more else None, dgrid.data_ptr())
        launches["mask"] += 1


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
    grid = aligned(grid)
    keep = torch.is_grad_enabled() and grid.requires_grad
    return _LightApply.apply(grid, tuple(int(a) for a in axes),
                             float(scale), keep, *taus)
