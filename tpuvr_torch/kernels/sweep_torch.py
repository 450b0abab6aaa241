"""Plain PyTorch forward sweep: the twin of the CUDA sweep kernel.

It mirrors the JAX package's ``lax.scan`` twin step for step: per slice,
the two tent operators A (V, Y) and B (X, U) resample the four channels
as ``A @ S_c @ B``; density is rectified, gated by the slice enables and
turned into ``att = exp(-s * sigma * dt)``; colour and transmittance
composite front to back. Early ray termination checks the global maximum
transmittance after every slice, as that twin does; no host sync is
needed because the check is a masked ``where``.

It runs wherever its tensors are. The CPU tests hold it against the JAX
package, and the card's smoke run holds the CUDA kernel against it.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "high", "default")


def _interp_matrices(ay, by, ax, bx, n_v, n_y, n_x, n_u, dtype):
    """Tent operators of one slice.

    A[i, y] = max(0, 1 - |i*ay + by - y|)   (V, Y) row resample
    B[x, j] = max(0, 1 - |j*ax + bx - x|)   (X, U) column resample

    The scalars may be 0-d tensors or floats; positions are evaluated in
    at least f32 and only the finished weights are cast to ``dtype``.
    """
    pt = torch.promote_types(dtype, torch.float32)
    dev = ay.device if torch.is_tensor(ay) else "cpu"

    def scalar(a):
        return torch.as_tensor(a, dtype=pt, device=dev)

    ay, by, ax, bx = scalar(ay), scalar(by), scalar(ax), scalar(bx)
    iv = torch.arange(n_v, dtype=pt, device=dev)[:, None]
    yy = torch.arange(n_y, dtype=pt, device=dev)[None, :]
    mat_a = torch.clamp_min(1.0 - torch.abs(iv * ay + by - yy), 0.0)
    ju = torch.arange(n_u, dtype=pt, device=dev)[None, :]
    xx = torch.arange(n_x, dtype=pt, device=dev)[:, None]
    mat_b = torch.clamp_min(1.0 - torch.abs(ju * ax + bx - xx), 0.0)
    return mat_a.to(dtype), mat_b.to(dtype)


def round_bf16(x):
    """Round f32 to the nearest bf16 value (ties to even), returned as f32.

    Bit-level, as the JAX package's 'high' split does it; assumes finite
    inputs.
    """
    ui = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    odd = (ui >> 16) & 1
    r = (ui + 0x7FFF + odd) & 0xFFFF0000
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)
    return r.view(torch.float32)


def sweep_dot(a, b, precision: str):
    """``a @ b`` (broadcast over leading dims) in a precision tier.

    For f32 operands:
    - 'highest': plain f32.
    - 'high': ``a_hi b_hi + a_lo b_hi + a_hi b_lo`` with the bf16 split of
      each operand; every product of two bf16 values is exact in f32.
    - 'default': both operands rounded to bf16, products summed in f32
      (one bf16 pass). A resample's row stage followed by its column
      stage thus rounds the row-stage partial to bf16 again.
    Other dtypes (f64 oracles) always use the plain product.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if a.dtype != torch.float32 or precision == "highest":
        return a @ b
    if precision == "default":
        return round_bf16(a) @ round_bf16(b)
    a_hi = round_bf16(a)
    b_hi = round_bf16(b)
    a_lo = (a - a_hi).to(torch.bfloat16).to(torch.float32)
    b_lo = (b - b_hi).to(torch.bfloat16).to(torch.float32)
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def resample(sl, mat_a, mat_b, precision: str):
    """(C, Y, X) slice -> (C, V, U) samples: row stage, then column."""
    return sweep_dot(sweep_dot(mat_a, sl, precision), mat_b, precision)


def sweep_fwd_torch(
    grid_sc, coeffs, enables, dt_map,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest",
):
    """Forward sweep. Returns (rgb (3, V, U), trans (V, U)).

    grid_sc: (S, 4, Y, X) channels (sigma, r, g, b); coeffs: four (S,)
    tensors (ay, by, ax, bx) in traversal order; enables: (S,) 0/1 in
    traversal order; dt_map: (V, U). ``reverse`` visits grid slices in
    descending order.
    """
    dtype = grid_sc.dtype
    s, _, n_y, n_x = grid_sc.shape
    n_v, n_u = dt_map.shape
    ay, by, ax, bx = coeffs
    rgb = torch.zeros((3, n_v, n_u), dtype=dtype, device=grid_sc.device)
    trans = torch.ones((n_v, n_u), dtype=dtype, device=grid_sc.device)
    tmax = torch.ones((), dtype=dtype, device=grid_sc.device)
    ert = early_stop_eps > 0.0
    for k in range(s):
        sl = grid_sc[s - 1 - k if reverse else k]
        go = enables[k] > 0
        if ert:
            go = go & (tmax >= early_stop_eps)
        mat_a, mat_b = _interp_matrices(
            ay[k], by[k], ax[k], bx[k], n_v, n_y, n_x, n_u, dtype
        )
        smp = resample(sl, mat_a, mat_b, precision)
        sigma = torch.clamp_min(smp[0], 0.0)
        att = torch.exp(-((sigma_scale * sigma) * dt_map))
        att = torch.where(go, att, torch.ones_like(att))
        w = trans * (1.0 - att)
        rgb = rgb + w[None] * smp[1:4]
        trans = trans * att
        if ert:
            tmax = torch.where(go, torch.max(trans), tmax)
    return rgb, trans
