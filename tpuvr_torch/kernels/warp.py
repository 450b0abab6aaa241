"""Row-block pixel warp: the CUDA kernels ``csrc/warp_rows.cu`` and wrappers.

:func:`warp_rows_fwd` and :func:`warp_rows_bwd` have the signatures of the
JAX package's (``tpuvr/kernels/warp.py``). For CUDA tensors they launch
the kernels (or raise); for CPU tensors they run the plain twins of
``tpuvr_torch.kernels.warp_torch``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.warp_torch import (
    warp_rows_bwd_torch,
    warp_rows_fwd_torch,
)
from tpuvr_torch.utils import trace

# Kernel launches so far, by kernel ("warp_rows_fwd", "warp_rows_bwd"; one
# per call, though the backward call issues two CUDA launches); a run reads
# it to show that it went through the kernels.
launches: collections.Counter[str] = collections.Counter()
trace.counter(lambda: {k: launches[k]
                       for k in ("warp_rows_fwd", "warp_rows_bwd")})

# The backward's tile stage (csrc/warp_rows.cu) keeps a (C, f_v, 32)
# window slab, a 1024-pixel batch and its bins in shared memory, puts the
# tile on gridDim.y, and flags each (tile, 32-column slab) it reached.
_SLAB, _BATCH = 32, 1024
_SMEM_BYTES = 232448  # what one block may use on sm_90
_MAX_TILES = 65535
# The C entries' argument types before the stream: pointers, then ints.
_ARGTYPES = {name: [ctypes.c_void_p] * n + [ctypes.c_int] * 6
             for name, n in (("tpuvr_warp_rows_fwd", 5),
                             ("tpuvr_warp_rows_bwd", 7))}


def _launch(name, dev, *args):
    """Launch the C entry ``name`` on ``dev``'s current stream."""
    _build.launch(_build.entry("warp_rows", name, _ARGTYPES[name]), dev,
                  *args)


def _bwd_smem_bytes(n_c: int, f_v: int) -> int:
    """Shared memory of one backward tile-stage block: the window slab, the
    staged batch (positions and cotangents, again in bin order, bins,
    sorted order), the bins' counts and offsets, the scan's warp totals."""
    n_bins = (f_v + 1) * (_SLAB + 1)
    return 4 * (n_c * f_v * _SLAB + (6 + 2 * n_c) * _BATCH + 2 * n_bins
                + 33)


def _check(inter_shape, y_t, x_t, vbase, f_v, device):
    """Validate the tiles against a (C, V, U) lattice; returns (T, P). The
    common case passes one chained test; a failure raises the ValueError
    :func:`_explain` names it with."""
    n_c, n_v, n_u = inter_shape
    shape = y_t.shape
    if (y_t.device == x_t.device == vbase.device == device
            and y_t.dtype == x_t.dtype == torch.float32
            and vbase.dtype == torch.int32 and len(shape) == 2
            and x_t.shape == shape and vbase.shape == shape[:1]
            and y_t.is_contiguous() and x_t.is_contiguous()
            and vbase.is_contiguous()
            and min(n_c, n_v, n_u, *shape) > 0 and 0 < f_v <= n_v
            and shape[0] <= _MAX_TILES
            and _bwd_smem_bytes(n_c, f_v) <= _SMEM_BYTES):
        return shape
    raise _explain(inter_shape, y_t, x_t, vbase, f_v, device)


def _explain(inter_shape, y_t, x_t, vbase, f_v, device) -> ValueError:
    """The ValueError naming the first check of :func:`_check` that
    fails."""
    n_c, n_v, n_u = inter_shape
    for name, t in (("y_t", y_t), ("x_t", x_t), ("vbase", vbase)):
        if t.device != device:
            return ValueError(f"{name} is on {t.device}, the image on "
                              f"{device}")
        if not t.is_contiguous():
            return ValueError(f"{name} must be contiguous")
    if y_t.dtype != torch.float32 or x_t.dtype != torch.float32:
        return ValueError(f"positions must be float32, got {y_t.dtype} and "
                          f"{x_t.dtype}")
    if vbase.dtype != torch.int32:
        return ValueError(f"vbase must be int32, got {vbase.dtype}")
    if y_t.dim() != 2 or x_t.shape != y_t.shape:
        return ValueError(f"y_t and x_t must be one (n_tiles, P) shape, got "
                          f"{tuple(y_t.shape)} and {tuple(x_t.shape)}")
    n_tiles, p = y_t.shape
    if vbase.shape != (n_tiles,):
        return ValueError(f"vbase has shape {tuple(vbase.shape)}, expected "
                          f"({n_tiles},)")
    if min(n_c, n_v, n_u, n_tiles, p) <= 0:
        return ValueError("empty image or tiles")
    if not 0 < f_v <= n_v:
        return ValueError(f"window height f_v={f_v} outside (0, V={n_v}]")
    if n_tiles > _MAX_TILES:
        return ValueError(f"{n_tiles} tiles; the kernels take at most "
                          f"{_MAX_TILES}")
    return ValueError(f"a {n_c}-channel window of {f_v} rows needs "
                      f"{_bwd_smem_bytes(n_c, f_v)} bytes of shared "
                      f"memory; a block has {_SMEM_BYTES}")


def warp_rows_fwd(inter_cvu, y_t, x_t, vbase, *, f_v: int):
    """(C, V, U) lattice -> (C, n_tiles, P) warped tiles.

    ``y_t``/``x_t``: (n_tiles, P) lattice positions, row-major flattened
    tiles; ``vbase``: (n_tiles,) int32 window origins, 8-aligned with
    ``vbase + f_v <= V`` (``tpuvr_torch.ops.warp.plan_row_warp``; the
    kernels re-align and clip any other origin into [0, V - f_v])."""
    if not inter_cvu.is_cuda:
        return warp_rows_fwd_torch(inter_cvu, y_t, x_t, vbase, f_v=f_v)
    if inter_cvu.dim() != 3 or inter_cvu.dtype != torch.float32:
        raise ValueError(f"inter_cvu must be a float32 (C, V, U) image, got "
                         f"{inter_cvu.dtype} {tuple(inter_cvu.shape)}")
    if not inter_cvu.is_contiguous():
        raise ValueError("inter_cvu must be contiguous")
    dev = inter_cvu.device
    n_c, n_v, n_u = inter_cvu.shape
    n_tiles, p = _check((n_c, n_v, n_u), y_t, x_t, vbase, f_v, dev)
    out = inter_cvu.new_empty((n_c, n_tiles, p))
    _launch("tpuvr_warp_rows_fwd", dev, inter_cvu.data_ptr(), y_t.data_ptr(),
            x_t.data_ptr(), vbase.data_ptr(), out.data_ptr(), n_c, n_v, n_u,
            n_tiles, p, int(f_v))
    launches["warp_rows_fwd"] += 1
    return out


def warp_rows_bwd(d_out, y_t, x_t, vbase, n_v: int, n_u: int, *, f_v: int):
    """Transpose of :func:`warp_rows_fwd`: (C, n_tiles, P) cotangent ->
    (C, V, U) lattice gradient, the tiles' window gradients summed in tile
    order (deterministic: the same inputs give the same bits)."""
    if not d_out.is_cuda:
        return warp_rows_bwd_torch(d_out, y_t, x_t, vbase, n_v, n_u, f_v=f_v)
    if d_out.dim() != 3 or d_out.dtype != torch.float32:
        raise ValueError(f"d_out must be a float32 (C, n_tiles, P) "
                         f"cotangent, got {d_out.dtype} "
                         f"{tuple(d_out.shape)}")
    if not d_out.is_contiguous():
        raise ValueError("d_out must be contiguous")
    dev = d_out.device
    n_c = d_out.shape[0]
    n_tiles, p = _check((n_c, n_v, n_u), y_t, x_t, vbase, f_v, dev)
    if tuple(d_out.shape[1:]) != (n_tiles, p):
        raise ValueError(f"d_out has shape {tuple(d_out.shape)}, expected "
                         f"({n_c}, {n_tiles}, {p})")
    # One scratch allocation: the (T, slabs, C, f_v, 32) window gradients,
    # then the (T, slabs) int32 flags of the slabs each tile reached.
    slabs = -(-n_u // _SLAB)
    n_part = n_tiles * slabs * n_c * f_v * _SLAB
    scratch = d_out.new_empty(n_part + n_tiles * slabs)
    d_inter = d_out.new_empty((n_c, n_v, n_u))
    ptr = scratch.data_ptr()
    _launch("tpuvr_warp_rows_bwd", dev, d_out.data_ptr(), y_t.data_ptr(),
            x_t.data_ptr(), vbase.data_ptr(), ptr, ptr + 4 * n_part,
            d_inter.data_ptr(), n_c, n_v, n_u, n_tiles, p, int(f_v))
    launches["warp_rows_bwd"] += 1
    return d_inter
