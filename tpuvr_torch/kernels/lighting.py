"""Directional tau sweep and its adjoint: the CUDA kernels
``csrc/tau_sweep.cu`` and ``csrc/tau_adj.cu``, their wrappers and their
plain twins.

  tau[S-1] = 0,  tau[k] = shift_(d_y,d_x)(tau[k+1] + dt * relu(sigma[k+1]))

and, for g = dL/dtau, plane-ascending with A[-1] = 0,

  h = shift_(-d_y,-d_x)(A[k-1]),  ds[k] = dt * h,  A[k] = g[k] + h

with ds = dL/d(relu(sigma)). :func:`tau_sweep_dirs` and
:func:`tau_sweep_adj_dirs` take a table of directions, each a field and
whether to walk its planes in reverse memory order, and run them all in one
launch of the cluster kernel for CUDA tensors (or raise), the twins for CPU
tensors. :func:`tau_sweep` and :func:`tau_sweep_adj` are a table of one.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels.sweep_torch import (
    PRECISIONS,
    _interp_matrices,
    resample,
)
from tpuvr_torch.utils import trace

# The cluster route (csrc/tau_cluster.cuh): one cluster of n CTAs a
# direction, CTA r keeping rows [r R, r R + R) of the carried plane, R =
# ceil(Y / n) >= 2, and the HALO rows beside them (one below, two above) in
# two zero-padded shared buffers, and its rows of the next input in a shared
# stage; each thread a column (X <= THREADS) and the rows of it a CTA row of
# threads apart. The C entry chooses the cluster size (or the plane loop)
# and reports it; cluster_plan and cluster_map are the tests' twins of its
# layout.
CLUSTERS = (4, 8, 16)
THREADS = 1024
HALO = 3
TAP_ROW_BYTES = 16
MAX_DIRS = 64  # directions a launch takes (the kernel's parameter table)

# Kernel launches on the card by cluster size, 0 for the plane loop (which
# counts each of its S-1 plane launches a direction), and the directions
# swept by each: K2 (launches, directions) and K4 (adj_launches,
# adj_directions).
launches: collections.Counter[int] = collections.Counter()
directions: collections.Counter[int] = collections.Counter()
adj_launches: collections.Counter[int] = collections.Counter()
adj_directions: collections.Counter[int] = collections.Counter()
trace.counter(lambda: {
    "tau_sweep_dirs": sum(directions.values()),
    "tau_adj_dirs": sum(adj_directions.values()),
    **{f"tau_sweep_c{k}": n for k, n in launches.items()},
    **{f"tau_adj_c{k}": n for k, n in adj_launches.items()}})

# srcs, outs, dims, coefs, count, the route (in: asked for, out: taken),
# precision.
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int])


def _round_up(a, b):
    return -(-a // b) * b


def cluster_plan(n_y, n_x, n):
    """The cluster route's layout of a (Y, X) plane over n CTAs, as the
    kernel computes it (``tau_cluster.cuh:make_plan``): rows a CTA keeps,
    thread columns and rows, cells a thread keeps at most, dynamic shared
    bytes (the tap-row table, two buffers of rows + HALO rows of X + 2 and
    the input stage) and whether its shape suits the route (``ok``: a
    thread a column, strips of two rows or more; the C entry also holds
    ``smem`` to the card's opt-in shared memory a block)."""
    rows = -(-n_y // n)
    bx = _round_up(n_x, 32)
    by = THREADS // bx if bx <= THREADS else 0
    smem = (_round_up(rows * TAP_ROW_BYTES, 16)
            + 4 * (2 * _round_up((rows + HALO) * (n_x + 2) + 1, 4)
                   + _round_up(rows * n_x, 4)))
    ok = by >= 1 and rows >= 2
    return dict(rows=rows, bx=bx, by=by, cells=-(-rows // by) if by else None,
                smem=smem, ok=ok)


def cluster_map(n_y, n_x, n, d_y):
    """numpy twin of the cluster kernel's map of a (Y, X) plane over n CTAs
    for a y shift d_y (|d_y| <= 1; the adjoint's negated one for K4): for
    each CTA, its first row ``r0`` and rows ``own``, the (thread, slot) ->
    (row, column) cells it keeps (``cells``, (THREADS, slots, 2), -1 where
    none), the two tap rows of each of its rows (``taps``, from f32
    positions as the kernel forms them, ``inside`` the plane or not), and
    its halo rows (``halo``: plane row -> the CTA that writes it there)."""
    p = cluster_plan(n_y, n_x, n)
    rows, bx, by = p["rows"], p["bx"], max(p["by"], 1)
    t = np.arange(THREADS)
    col, trow = t % bx, t // bx
    on = (col < n_x) & (trow < p["by"])
    local = trow[:, None] + np.arange(p["cells"] or 1)[None, :] * by
    out = []
    for r in range(n):
        r0 = r * rows
        own = max(0, min(rows, n_y - r0))
        keep = on[:, None] & (local < own)
        cells = np.where(keep[..., None], np.stack(
            [r0 + local, np.broadcast_to(col[:, None], local.shape)], -1), -1)
        pos = np.arange(r0, r0 + own).astype(np.float32) + np.float32(d_y)
        i0 = np.floor(pos).astype(np.int64)
        taps = np.stack([i0, i0 + 1], -1)
        halo = {}
        if r > 0:
            halo[r0 - 1] = r - 1
        if r + 1 < n:
            halo.update({r0 + rows: r + 1, r0 + rows + 1: r + 1})
        out.append(dict(r0=r0, own=own, cells=cells, taps=taps,
                        inside=(taps >= 0) & (taps < n_y), halo=halo))
    return out


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


def _flipped(twin, rows, precision):
    """Each row (field, flip, d_y, d_x, dt) through a one-direction twin,
    the field's planes reversed around it when flip."""
    out = []
    for field, flip, d_y, d_x, dt in rows:
        f = field.flip(0) if flip else field
        r = twin(f, d_y=d_y, d_x=d_x, dt=dt, precision=precision)
        out.append(r.flip(0) if flip else r)
    return out


def tau_sweep_dirs_torch(rows, precision="highest"):
    """Plain twin of :func:`tau_sweep_dirs`: :func:`tau_sweep_torch` a
    direction."""
    return _flipped(tau_sweep_torch, rows, precision)


def tau_sweep_adj_dirs_torch(rows, precision="highest"):
    """Plain twin of :func:`tau_sweep_adj_dirs`: :func:`tau_sweep_adj_torch`
    a direction."""
    return _flipped(tau_sweep_adj_torch, rows, precision)


def _check(rows, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if not rows:
        raise ValueError("no directions")
    dev = rows[0][0].device
    for field, *_ in rows:
        if field.dim() != 3 or field.dtype != torch.float32:
            raise ValueError(f"fields must be (S, Y, X) float32, got "
                             f"{tuple(field.shape)} {field.dtype}")
        if not field.is_contiguous():
            raise ValueError("fields must be contiguous")
        if min(field.shape) <= 0:
            raise ValueError(f"empty field {tuple(field.shape)}")
        if field.device != dev:
            raise ValueError("fields lie on several devices")
    if any(abs(r[2]) > 1.0 or abs(r[3]) > 1.0 for r in rows):
        raise ValueError("|d_y| and |d_x| must be at most 1")
    return dev


def _launch(lib, name, rows, precision, cluster, counts):
    """One C call a chunk of MAX_DIRS rows; returns the outputs. cluster:
    the route asked for (None: the C entry chooses), counted by the route
    taken."""
    dev = _check(rows, precision)
    outs = [torch.empty_like(r[0]) for r in rows]
    fn = _build.entry(lib, name, _ARGTYPES)
    launched, swept = counts
    route = ctypes.c_int()
    for c0 in range(0, len(rows), MAX_DIRS):
        chunk = rows[c0:c0 + MAX_DIRS]
        shapes = [tuple(r[0].shape) for r in chunk]
        k = len(chunk)
        srcs = (ctypes.c_void_p * k)(*[r[0].data_ptr() for r in chunk])
        dsts = (ctypes.c_void_p * k)(
            *[o.data_ptr() for o in outs[c0:c0 + k]])
        dims = (ctypes.c_int * (4 * k))(*[
            v for (s, y, x), r in zip(shapes, chunk)
            for v in (s, y, x, int(bool(r[1])))])
        coefs = (ctypes.c_float * (3 * k))(*[
            float(v) for r in chunk for v in r[2:5]])
        route.value = -1 if cluster is None else cluster
        _build.launch(fn, dev, srcs, dsts, dims, coefs, k,
                      ctypes.byref(route), PRECISIONS.index(precision))
        n = route.value
        launched[n] += sum(s - 1 for s, _, _ in shapes) if n == 0 else 1
        swept[n] += k
    return outs


def tau_sweep_dirs(rows, precision="highest", *, _cluster=None):
    """Optical depth to the sky for every voxel, for several directions.

    rows: (sigma, flip, d_y, d_x, dt) a direction, sigma an (S, Y, X)
    float32 contiguous field whose plane index rises toward the sky (or
    falls, when flip: the sweep then walks the planes in reverse memory
    order); |d| <= 1; rows may share a field. Returns one (S, Y, X) tau a
    direction, in its field's plane order, tau = 0 on the sky plane. The
    C entry chooses the route: clusters of 4, 8 or 16 CTAs by plane size
    and direction count, or the plane loop for a plane they cannot hold.
    ``_cluster`` (tests only) asks for a route: 4, 8, 16 or 0 (the plane
    loop); a size that cannot take the planes raises.
    """
    if not rows[0][0].is_cuda:
        return tau_sweep_dirs_torch(rows, precision)
    return _launch("tau_sweep", "tpuvr_tau_sweep_dirs", rows, precision,
                   _cluster, (launches, directions))


def tau_sweep_adj_dirs(rows, precision="highest", *, _cluster=None):
    """Adjoint of :func:`tau_sweep_dirs`: rows (g, flip, d_y, d_x, dt) with
    g = dL/dtau in the forward's layout; returns dL/d(relu(sigma)) a
    direction (the caller applies the relu mask), zero on the plane
    farthest from the sky. ``_cluster`` as in :func:`tau_sweep_dirs`."""
    if not rows[0][0].is_cuda:
        return tau_sweep_adj_dirs_torch(rows, precision)
    return _launch("tau_adj", "tpuvr_tau_adj_dirs", rows, precision,
                   _cluster, (adj_launches, adj_directions))


def tau_sweep(sig_p, *, d_y, d_x, dt, precision="highest"):
    """Optical depth to the sky for every voxel of a permuted field.

    sig_p: (S, Y, X) float32, plane index rising toward the sky; |d| <= 1.
    Returns (S, Y, X) tau with tau[S-1] = 0.
    """
    return tau_sweep_dirs([(sig_p, False, d_y, d_x, dt)], precision)[0]


def tau_sweep_adj(g, *, d_y, d_x, dt, precision="highest"):
    """Adjoint of :func:`tau_sweep`: dL/d(relu(sigma)) (S, Y, X) from
    g = dL/dtau (S, Y, X) float32; the caller applies the relu mask."""
    return tau_sweep_adj_dirs([(g.contiguous(), False, d_y, d_x, dt)],
                              precision)[0]
