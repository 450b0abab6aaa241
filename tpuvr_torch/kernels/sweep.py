"""Forward sweep: the CUDA kernel ``csrc/sweep_fwd.cu`` and its wrapper.

:func:`sweep_fwd` has the signature and layouts of the JAX package's
``sweep_fwd``. For CUDA tensors it launches the kernel (or raises); for
CPU tensors it runs the plain twin :func:`sweep_fwd_torch`.
"""

from __future__ import annotations

import ctypes

import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep_torch import PRECISIONS, sweep_fwd_torch

# Kernel launches so far; a run reads it to show that it went through the
# kernel.
launches = 0

_MAX_SLICES = 2048  # (5, S) f32 per-slice scalars stay within 48 KB smem


def _entry():
    fn = _build.load("sweep_fwd").tpuvr_sweep_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, grid on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def sweep_fwd(
    grid_sc, coeffs, enables, dt_map,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False,
):
    """Forward sweep. Returns (rgb (3, V, U), trans (V, U)).

    grid_sc: (S, 4, Y, X); coeffs: (ay, by, ax, bx), four (S,) tensors in
    traversal order; enables: (S,) 0/1 in traversal order; dt_map: (V, U).
    ``softplus``: the density channel holds raw parameters, softplus'd
    per tap before resampling.
    With ``early_stop_eps`` > 0 the kernel stops each ray at its own
    T < eps; the twin stops all rays at the global max, and the two agree
    within eps * max|colour| (see the kernel source).
    """
    global launches
    if not grid_sc.is_cuda:
        return sweep_fwd_torch(
            grid_sc, coeffs, enables, dt_map, reverse=reverse,
            sigma_scale=sigma_scale, early_stop_eps=early_stop_eps,
            precision=precision, softplus=softplus,
        )
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
    dev = grid_sc.device
    _check("grid_sc", grid_sc, grid_sc.shape, dev)
    _check("dt_map", dt_map, (n_v, n_u), dev)
    for name, t in zip(("ay", "by", "ax", "bx", "enables"),
                       (*coeffs, enables)):
        _check(name, t, (s,), dev)
    if not (grid_sc.is_contiguous() and dt_map.is_contiguous()):
        raise ValueError("grid_sc and dt_map must be contiguous")
    scal = torch.stack((*coeffs, enables))
    rgb = torch.empty((3, n_v, n_u), dtype=torch.float32, device=dev)
    trans = torch.empty((n_v, n_u), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            grid_sc.data_ptr(), scal.data_ptr(), dt_map.data_ptr(),
            rgb.data_ptr(), trans.data_ptr(),
            s, n_y, n_x, n_v, n_u, int(bool(reverse)),
            float(sigma_scale), float(early_stop_eps),
            PRECISIONS.index(precision), int(bool(softplus)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sweep_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return rgb, trans
