"""Plain PyTorch versions of the row-block warp kernels (``csrc/warp_rows.cu``).

Twins of the JAX package's ``_warp_rows_xla`` (``tpuvr/ops/warp.py``) and
of the transpose its Pallas backward computes: per tile k, the ``(C, f_v,
U)`` row window of the lattice at origin ``vb_k``, the ``(P, U)`` and
``(P, f_v)`` tents ``max(0, 1 - |i - pos|)`` from ``arange``, and the
contraction over u first, then over v. The CPU tests and ``chip_smoke.py``
use them; the card's main path does not.

The contractions are matrix products: on the card they need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default), or
they keep about three decimal digits.
"""

from __future__ import annotations

import torch


def _window_origins(vbase, f_v: int, n_v: int):
    """The kernels' window origins: ``vbase`` re-aligned to 8 rows, as the
    TPU kernels align it, and clipped so the window lies inside [0, V)."""
    return torch.clamp((vbase.clamp_min(0) // 8) * 8, max=n_v - f_v)


def _tents(pos, n: int):
    """(T, P) positions -> (T, P, n) tents ``max(0, 1 - |i - pos|)``."""
    i = torch.arange(n, dtype=pos.dtype, device=pos.device)
    return torch.clamp_min(1.0 - torch.abs(i - pos[..., None]), 0.0)


def _tile_tents(y_t, x_t, vb, f_v: int, n_u: int):
    tent_u = _tents(x_t, n_u)                              # (T, P, U)
    tent_v = _tents(y_t - vb.to(y_t.dtype)[:, None], f_v)  # (T, P, F)
    return tent_u, tent_v


def warp_rows_fwd_torch(inter_cvu, y_t, x_t, vbase, *, f_v: int):
    """(C, V, U) lattice -> (C, n_tiles, P) warped tiles.

    ``y_t``/``x_t``: (n_tiles, P) lattice positions; ``vbase``: (n_tiles,)
    int32 window origins, re-aligned and clipped as the kernels do."""
    n_c, n_v, n_u = inter_cvu.shape
    vb = _window_origins(vbase, f_v, n_v).long()
    rows = vb[:, None] + torch.arange(f_v, device=vb.device)  # (T, F)
    foot = inter_cvu[:, rows, :]                               # (C, T, F, U)
    tent_u, tent_v = _tile_tents(y_t, x_t, vb, f_v, n_u)
    part = torch.einsum("tpu,ctfu->ctpf", tent_u, foot)
    return torch.einsum("tpf,ctpf->ctp", tent_v, part)


def warp_rows_bwd_torch(d_out, y_t, x_t, vbase, n_v: int, n_u: int, *,
                        f_v: int):
    """Transpose of :func:`warp_rows_fwd_torch`: (C, n_tiles, P) cotangent
    -> (C, V, U) lattice gradient. Per tile, ``d_foot = d_partᵀ tent_u``
    with ``d_part = tent_v * d_out``, added into its window tile by tile,
    k ascending, as the TPU kernel accumulates it."""
    n_c = d_out.shape[0]
    vb = _window_origins(vbase, f_v, n_v)
    tent_u, tent_v = _tile_tents(y_t, x_t, vb, f_v, n_u)
    d_part = tent_v[None] * d_out[..., None]                   # (C, T, P, F)
    d_foot = torch.einsum("ctpf,tpu->ctfu", d_part, tent_u)    # (C, T, F, U)
    d_inter = d_out.new_zeros((n_c, n_v, n_u))
    for k, v0 in enumerate(vb.tolist()):
        d_inter[:, v0:v0 + f_v] += d_foot[:, k]
    return d_inter
