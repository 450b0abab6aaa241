"""Directional tau sweep and its adjoint: the CUDA kernels
``csrc/tau_sweep.cu`` and ``csrc/tau_adj.cu``, their wrappers and their
plain twins.

  tau[S-1] = 0,  tau[k] = shift_(d_y,d_x)(tau[k+1] + dt * relu(sigma[k+1]))

and, for g = dL/dtau, plane-ascending with A[-1] = 0,

  h = shift_(-d_y,-d_x)(A[k-1]),  ds[k] = dt * h,  A[k] = g[k] + h

with ds = dL/d(relu(sigma)). :func:`tau_sweep` and :func:`tau_sweep_adj`
launch the kernels for CUDA tensors (or raise) and run the twins for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep_torch import (
    PRECISIONS,
    _interp_matrices,
    resample,
)

# Wrapper calls that launched each kernel (one per direction; each issues
# S-1 plane launches on the card): tau_sweep, tau_sweep_adj.
launches = 0
adj_launches = 0


def tau_sweep_torch(sig_p, *, d_y, d_x, dt, precision="highest"):
    """Plain twin: the shift-scan of the JAX package's ``lax.scan`` path.

    sig_p: (S, Y, X) density, plane index rising toward the sky.
    Returns (S, Y, X) tau.
    """
    s, n_y, n_x = sig_p.shape
    dtype = sig_p.dtype
    mat_a, mat_b = _interp_matrices(1.0, d_y, 1.0, d_x,
                                    n_y, n_y, n_x, n_x, dtype)
    mat_a, mat_b = mat_a.to(sig_p.device), mat_b.to(sig_p.device)
    tau = torch.zeros((n_y, n_x), dtype=dtype, device=sig_p.device)
    taus = [tau]
    for k in range(s - 2, -1, -1):
        f = tau + dt * torch.clamp_min(sig_p[k + 1], 0.0)
        tau = resample(f, mat_a, mat_b, precision)
        taus.append(tau)
    return torch.stack(taus[::-1])


def tau_sweep_adj_torch(g, *, d_y, d_x, dt, precision="highest"):
    """Plain twin of the adjoint: g (S, Y, X) = dL/dtau, plane-ascending.
    Returns (S, Y, X) dL/d(relu(sigma)), zero on plane 0."""
    s, n_y, n_x = g.shape
    dtype = g.dtype
    mat_a, mat_b = _interp_matrices(1.0, -d_y, 1.0, -d_x,
                                    n_y, n_y, n_x, n_x, dtype)
    mat_a, mat_b = mat_a.to(g.device), mat_b.to(g.device)
    acc = torch.zeros((n_y, n_x), dtype=dtype, device=g.device)
    out = []
    for k in range(s):
        h = resample(acc, mat_a, mat_b, precision)
        out.append(dt * h)
        acc = g[k] + h
    return torch.stack(out)


def _adj_entry():
    fn = _build.load("tau_adj").tpuvr_tau_adj
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tau_sweep_adj(g, *, d_y, d_x, dt, precision="highest"):
    """Adjoint of :func:`tau_sweep`: dL/d(relu(sigma)) (S, Y, X) from
    g = dL/dtau (S, Y, X) float32; the caller applies the relu mask."""
    global adj_launches
    if not g.is_cuda:
        return tau_sweep_adj_torch(g, d_y=d_y, d_x=d_x, dt=dt,
                                   precision=precision)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if g.dim() != 3 or g.dtype != torch.float32:
        raise ValueError(f"g must be (S, Y, X) float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    s, n_y, n_x = g.shape
    if min(s, n_y, n_x) <= 0:
        raise ValueError(f"empty cotangent field {tuple(g.shape)}")
    g = g.contiguous()
    ds = torch.empty_like(g)
    acc = torch.empty((2, n_y, n_x), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _adj_entry()(
            g.data_ptr(), ds.data_ptr(), acc.data_ptr(), s, n_y, n_x,
            float(d_y), float(d_x), float(dt), PRECISIONS.index(precision),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tau_adj kernel launch failed: CUDA error {err}")
    adj_launches += 1
    return ds


def _entry():
    fn = _build.load("tau_sweep").tpuvr_tau_sweep
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tau_sweep(sig_p, *, d_y, d_x, dt, precision="highest"):
    """Optical depth to the sky for every voxel of a permuted field.

    sig_p: (S, Y, X) float32, plane index rising toward the sky; |d| <= 1.
    Returns (S, Y, X) tau with tau[S-1] = 0.
    """
    global launches
    if not sig_p.is_cuda:
        return tau_sweep_torch(sig_p, d_y=d_y, d_x=d_x, dt=dt,
                               precision=precision)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if sig_p.dim() != 3 or sig_p.dtype != torch.float32:
        raise ValueError(f"sig_p must be (S, Y, X) float32, got "
                         f"{tuple(sig_p.shape)} {sig_p.dtype}")
    if not sig_p.is_contiguous():
        raise ValueError("sig_p must be contiguous")
    s, n_y, n_x = sig_p.shape
    if min(s, n_y, n_x) <= 0:
        raise ValueError(f"empty density field {tuple(sig_p.shape)}")
    tau = torch.empty_like(sig_p)
    with torch.cuda.device(sig_p.device):
        err = _entry()(
            sig_p.data_ptr(), tau.data_ptr(), s, n_y, n_x,
            float(d_y), float(d_x), float(dt), PRECISIONS.index(precision),
            torch.cuda.current_stream(sig_p.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tau_sweep kernel launch failed: CUDA error {err}")
    launches += 1
    return tau
