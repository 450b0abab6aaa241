"""Plain PyTorch forward and backward sweeps: the twins of the CUDA sweep
kernels.

They mirror the JAX package's ``lax.scan`` twins step for step: per
slice, the two tent operators A (V, Y) and B (X, U) resample the four
channels as ``A @ S_c @ B``; density is rectified, gated by the slice
enables and turned into ``att = exp(-s * sigma * dt)``; colour and
transmittance composite front to back. Early ray termination checks the
global maximum transmittance after every slice, as those twins do; no
host sync is needed because the check is a masked ``where``.

The backward re-marches with O(1) state per ray (no stored per-slice
activations): the transmittance T and the channel-contracted colour
prefix ``q = sum_c dC_c * prefix_c``, with the constant suffix terms
folded into ``dbias = sum_c dC_c * C_fin,c + dT * T_fin``, so that

  d sigma_k = [sigma_raw > 0] * s * dt
              * (sum_c dC_c T_k att_k c_k + q_k - dbias)
  d c_k     = dC * T_k * (1 - att_k)

and each slice's gradient is ``A^T dS B^T``, written once.

They run wherever their tensors are. The CPU tests hold them against the
JAX package, and the card's smoke run holds the CUDA kernels against
them.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "high", "default")


def _interp_matrices(ay, by, ax, bx, n_v, n_y, n_x, n_u, dtype, row0=0):
    """Tent operators of one slice.

    A[i, y] = max(0, 1 - |(row0 + i)*ay + by - y|)   (V, Y) row resample
    B[x, j] = max(0, 1 - |j*ax + bx - x|)   (X, U) column resample

    The scalars may be 0-d tensors or floats; positions are evaluated in
    at least f32 and only the finished weights are cast to ``dtype``.
    """
    pt = torch.promote_types(dtype, torch.float32)
    dev = ay.device if torch.is_tensor(ay) else "cpu"

    def scalar(a):
        return torch.as_tensor(a, dtype=pt, device=dev)

    ay, by, ax, bx = scalar(ay), scalar(by), scalar(ax), scalar(bx)
    iv = torch.arange(row0, row0 + n_v, dtype=pt, device=dev)[:, None]
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


def softplus_slice(sl):
    """softplus on the density channel (dim 0) of a (4, ...) slice, in the
    overflow-free form of the JAX kernels: max(x, 0) + log(1 + e^-|x|)."""
    raw = sl[:1]
    sp = (torch.clamp_min(raw, 0.0)
          + torch.log(1.0 + torch.exp(-torch.abs(raw))))
    return torch.cat([sp, sl[1:]], dim=0)


def sweep_fwd_torch(
    grid_sc, coeffs, enables, dt_map,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False, row0=0,
):
    """Forward sweep. Returns (rgb (3, V, U), trans (V, U)).

    grid_sc: (S, 4, Y, X) channels (sigma, r, g, b); coeffs: four (S,)
    tensors (ay, by, ax, bx) in traversal order; enables: (S,) 0/1 in
    traversal order; dt_map: (V, U). ``reverse`` visits grid slices in
    descending order. ``softplus``: the density channel holds raw
    parameters, and each slice's density is softplus'd before resampling.
    ``row0``: dt_map holds rows [row0, row0 + V) of the image, row v
    sampling at (row0 + v)*ay + by (a row tile; 0 is the whole image).
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
        if softplus:
            sl = softplus_slice(sl)
        go = enables[k] > 0
        if ert:
            go = go & (tmax >= early_stop_eps)
        mat_a, mat_b = _interp_matrices(
            ay[k], by[k], ax[k], bx[k], n_v, n_y, n_x, n_u, dtype, row0
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


def sweep_dbias(d_color, c_final, d_trans, t_final):
    """The backward's constant suffix plane (V, U):
    ``sum_c dC_c * C_fin,c + dT * T_fin``."""
    return (d_color * c_final).sum(dim=0) + d_trans * t_final


def sweep_bwd_torch(
    grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color, d_trans,
    *, reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
    precision="highest", softplus=False, carry=None, row0=0,
):
    """Backward sweep: the (S, 4, Y, X) gradient of the forward's outputs'
    cotangents ``d_color`` (3, V, U) and ``d_trans`` (V, U) with respect to
    ``grid_sc`` (raw parameters on the density channel when ``softplus``).

    ``c_final``/``t_final`` are the forward's outputs. ``carry``: optional
    (trans0, q0) recompute state entering this call, for a slab of the
    slices; with it the call returns ``(grad, (trans_fin, q_fin))``. The
    identity carry is (ones, zeros). ``row0``: a row tile, as in
    :func:`sweep_fwd_torch`.
    """
    dtype = grid_sc.dtype
    dev = grid_sc.device
    s = grid_sc.shape[0]
    n_y, n_x = grid_sc.shape[2], grid_sc.shape[3]
    n_v, n_u = dt_map.shape
    ay, by, ax, bx = coeffs
    dbias = sweep_dbias(d_color, c_final, d_trans, t_final)
    if carry is None:
        trans = torch.ones((n_v, n_u), dtype=dtype, device=dev)
        q = torch.zeros((n_v, n_u), dtype=dtype, device=dev)
    else:
        trans, q = carry
    tmax = torch.max(trans)
    ert = early_stop_eps > 0.0
    sdt = sigma_scale * dt_map
    grads = []
    for k in range(s):
        raw = grid_sc[s - 1 - k if reverse else k]
        sl = softplus_slice(raw) if softplus else raw
        go = enables[k] > 0
        if ert:
            go = go & (tmax >= early_stop_eps)
        mat_a, mat_b = _interp_matrices(
            ay[k], by[k], ax[k], bx[k], n_v, n_y, n_x, n_u, dtype, row0
        )
        smp = resample(sl, mat_a, mat_b, precision)
        sig_raw = smp[0]
        sigma = torch.clamp_min(sig_raw, 0.0)
        att = torch.exp(-((sigma_scale * sigma) * dt_map))
        att = torch.where(go, att, torch.ones_like(att))
        w = trans * (1.0 - att)
        dsig = -dbias
        dsmp = []
        for c in range(3):
            q = q + (d_color[c] * w) * smp[c + 1]
            dsig = dsig + d_color[c] * (trans * att) * smp[c + 1]
            dsmp.append(d_color[c] * w)
        dsig = (dsig + q) * sdt
        dsig = torch.where(sig_raw > 0.0, dsig, torch.zeros_like(dsig))
        dsmp = torch.stack([dsig] + dsmp)  # (4, V, U)
        # A^T dS B^T: the row stage over v, then the column stage over u.
        grad = sweep_dot(sweep_dot(mat_a.T, dsmp, precision), mat_b.T,
                         precision)
        grad = torch.where(go, grad, torch.zeros_like(grad))
        if softplus:
            sig = 1.0 / (1.0 + torch.exp(-raw[0]))
            grad = torch.cat([grad[:1] * sig, grad[1:]], dim=0)
        grads.append(grad)
        trans = trans * att
        if ert:
            tmax = torch.where(go, torch.max(trans), tmax)
    if reverse:
        grads = grads[::-1]
    grad = torch.stack(grads)
    if carry is None:
        return grad
    return grad, (trans, q)


def sweep_fwd_views_torch(grid_sc, coeffs, enables, dt_map, *, views, **kw):
    """View-batched forward sweep: the views' intermediate planes stacked
    along V (``dt_map`` (views * V, U)), coeffs four (views, S) tensors and
    enables (views, S). A loop of :func:`sweep_fwd_torch` over the views
    with stacked outputs, as the JAX package's ``_xla_views_fwd``."""
    ay, by, ax, bx = coeffs
    n_v = dt_map.shape[0] // views
    rgbs, ts = [], []
    for w in range(views):
        rgb, t = sweep_fwd_torch(
            grid_sc, (ay[w], by[w], ax[w], bx[w]), enables[w],
            dt_map[w * n_v:(w + 1) * n_v], **kw)
        rgbs.append(rgb)
        ts.append(t)
    return torch.cat(rgbs, dim=1), torch.cat(ts, dim=0)


def sweep_bwd_views_torch(
    grid_sc, coeffs, enables, dt_map, c_final, t_final, d_color, d_trans,
    *, views, carry=None, **kw,
):
    """Gradient of :func:`sweep_fwd_views_torch`: the per-view gradients of
    :func:`sweep_bwd_torch`, summed in view order. ``carry`` (trans0, q0)
    is (views * V, U), as the outputs; with it the call returns
    ``(grad, (trans_fin, q_fin))``. Mirrors ``_xla_views_bwd``."""
    ay, by, ax, bx = coeffs
    n_v = dt_map.shape[0] // views
    grad = None
    t_fins, q_fins = [], []
    for w in range(views):
        sl = slice(w * n_v, (w + 1) * n_v)
        c_w = None if carry is None else (carry[0][sl], carry[1][sl])
        out = sweep_bwd_torch(
            grid_sc, (ay[w], by[w], ax[w], bx[w]), enables[w], dt_map[sl],
            c_final[:, sl], t_final[sl], d_color[:, sl], d_trans[sl],
            carry=c_w, **kw)
        if carry is not None:
            out, (t_f, q_f) = out
            t_fins.append(t_f)
            q_fins.append(q_f)
        grad = out if grad is None else grad + out
    if carry is None:
        return grad
    return grad, (torch.cat(t_fins, dim=0), torch.cat(q_fins, dim=0))
