"""Front-to-back emission-absorption compositing.

Per sample, with accumulated colour C and transmittance T:

    alpha_i = 1 - exp(-sigma_i * dt_i)
    C      += T * alpha_i * c_i
    T      *= 1 - alpha_i

The segment merge ``(C1, T1) ⊕ (C2, T2) = (C1 + T1*C2, T1*T2)`` is
associative, which lets ray segments from grid slabs be folded in depth
order (the z-sharded grid's folds keep their own copy of it).
"""

from __future__ import annotations

import torch


def alpha_from_sigma(sigma, dt):
    """Opacity of a homogeneous segment: ``1 - exp(-sigma * dt)``."""
    return 1.0 - torch.exp(-sigma * dt)


def composite_step(color_acc, trans, sample_rgb, sigma, dt):
    """One front-to-back step. Returns updated ``(color_acc, trans)``.

    Shapes: ``color_acc``/``sample_rgb`` (..., 3); ``trans``/``sigma``/``dt``
    (...,) or broadcastable.
    """
    att = torch.exp(-sigma * dt)
    alpha = 1.0 - att
    color_acc = color_acc + (trans * alpha)[..., None] * sample_rgb
    trans = trans * att
    return color_acc, trans


def segment_compose(seg_a, seg_b):
    """Associative merge of two consecutive ray segments (a in front of b).

    ``seg = (C, T)`` with C (..., 3) and T (...,):
    ``(Ca + Ta*Cb, Ta*Tb)``.
    """
    ca, ta = seg_a
    cb, tb = seg_b
    return ca + ta[..., None] * cb, ta * tb


def composite_ray(rgbs, sigmas, dts):
    """Composite whole rays from per-sample emissions and densities.

    Args:
      rgbs: (..., S, 3) per-sample emission.
      sigmas: (..., S) per-sample density.
      dts: (..., S) or a scalar per-sample segment length.

    Returns:
      (color (..., 3), transmittance (...,)), in closed form through the
      exclusive prefix of optical depth:
      T_i = exp(-sum_{j<i} sigma_j dt_j),  C = sum_i T_i * alpha_i * rgb_i.
    """
    tau = sigmas * dts
    tau_cum = torch.cumsum(tau, dim=-1)
    t_excl = torch.exp(-(tau_cum - tau))
    alpha = 1.0 - torch.exp(-tau)
    w = t_excl * alpha
    color = torch.sum(w[..., None] * rgbs, dim=-2)
    trans = torch.exp(-tau_cum[..., -1])
    return color, trans
