"""Speed-of-light model of the sweep on the card.

A measured time becomes a fraction of the least time the card could take
for the same work: the larger of the bytes the sweep must move over the
memory rate and the operations it must do over the peak rate. The work is
that of the function, not of an implementation: each input read once and
each output written once, and a fixed count of operations for each sample
inside the tents' support (a sample outside it reads only zero taps).
``chip_smoke.py`` takes its kernel bounds from here too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float   # tensor-core peak, dense bf16
    f32_tflops: float    # f32 outside the tensor cores
    hbm_gbps: float      # device memory, GB/s


# NVIDIA's data sheet for the H100 SXM (dense rates, at its 700 W limit).
CHIPS: Dict[str, ChipSpec] = {
    "h100_sxm": ChipSpec("h100_sxm", 989.0, 67.0, 3350.0),
}

HBM_BYTES_PER_S = CHIPS["h100_sxm"].hbm_gbps * 1e9
F32_FLOP_PER_S = CHIPS["h100_sxm"].f32_tflops * 1e12
SWEEP_FLOPS_PER_SAMPLE = 40  # tent weights, 16 taps x 4 ch, exp, composite
# Backward sweep per sample: the forward's recompute (40), the adjoint
# arithmetic (about 30), and the transposed resample of 4 channels (40).
BWD_FLOPS_PER_SAMPLE = 110


def support_samples(args, row0=0):
    """Ray-slices of enabled slices whose two positions lie in the tents'
    support (-1, n), with the kernels' f32 position formula (a product,
    then a sum): the samples that need work (the others read only zero
    taps). The coefficients and enables are (S,) for one view or (views,
    S) for a view batch; the rays are rows [row0, row0 + V / views)."""
    grid_sc, coeffs, enables, dt_map = args
    _, _, n_y, n_x = grid_sc.shape
    ay, by, ax, bx = (np.atleast_2d(c.detach().cpu().numpy().astype(
        np.float32)) for c in coeffs)
    en = np.atleast_2d(enables.detach().cpu().numpy()) != 0
    n_v, n_u = dt_map.shape
    v = np.arange(row0, row0 + n_v // en.shape[0], dtype=np.float32)
    u = np.arange(n_u, dtype=np.float32)
    py = ay[..., None] * v + by[..., None]
    px = ax[..., None] * u + bx[..., None]
    in_y = ((py > -1.0) & (py < n_y)).sum(-1)
    in_x = ((px > -1.0) & (px < n_x)).sum(-1)
    return int((en * in_y * in_x).sum())


def sweep_work(args, row0=0):
    """(grid bytes of the slices enabled in any view, scalar bytes, ray
    plane bytes, ray-slice samples of enabled slices, those samples inside
    the tents' support) of one sweep; the enables are (S,) for one view or
    (views, S) for a view batch."""
    grid_sc, coeffs, enables, dt_map = args
    s, _, n_y, n_x = grid_sc.shape
    n_v, n_u = dt_map.shape
    on = (enables > 0).reshape(-1, s)
    samples = int(on.sum()) * (n_v // on.shape[0]) * n_u
    return (int(on.any(0).sum()) * 4 * n_y * n_x * 4, 5 * on.numel() * 4,
            n_v * n_u * 4, samples, support_samples(args, row0))


def sweep_fwd_bound(args, row0=0):
    """(bytes ms, operations ms): each input read once (only enabled
    slices of the grid), each output written once; SWEEP_FLOPS_PER_SAMPLE
    per sample inside the tents' support (a sample outside it reads only
    zero taps and changes nothing). That is the work these inputs need
    when no ray terminates early."""
    grid_b, scal_b, plane_b, _, support = sweep_work(args, row0)
    return ((grid_b + scal_b + 5 * plane_b) / HBM_BYTES_PER_S * 1e3,
            SWEEP_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)


def sweep_bwd_bound(args, row0=0):
    """(bytes ms, operations ms) of one backward sweep: the grid's enabled
    slices, the scalars and 9 ray planes (dt, rgb, T, their cotangents)
    read once, the gradient written once; BWD_FLOPS_PER_SAMPLE per sample
    inside the tents' support."""
    grid_b, scal_b, plane_b, _, support = sweep_work(args, row0)
    grad_b = args[0].numel() * 4
    return ((grid_b + grad_b + scal_b + 9 * plane_b) / HBM_BYTES_PER_S * 1e3,
            BWD_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)


def sweep_cost(n_planes: int, n_y: int, n_x: int, n_v: int, n_u: int,
               channels: int = 4, itemsize: int = 4,
               active_fraction: float = 1.0, backward: bool = False,
               args=None):
    """Per-frame (flops, hbm_bytes) of the sweep; with ``backward`` of the
    forward and backward together, as a fwd+bwd time measures them.

    The bytes are the JAX package's: the grid streamed once (three times
    with ``backward``: read, re-read, gradient written), times the active
    fraction, so that the two packages' fractions read the same bytes.
    The kernel table's :func:`sweep_fwd_bound` and :func:`sweep_bwd_bound`
    count each input and output of one kernel launch: the enabled slices,
    and also the per-slice scalars and the ray planes (at the headline
    frame and the H100's rates, 0.0817 ms against this count's 0.0801).
    Only the flops are one
    count with those bounds.

    The flops differ from that package's on purpose. It counts the TPU's
    dense resample, ``channels * (2 V Y X + 2 V X U)`` a slice,
    zeros of the tent matrices included, so its count depends on which
    implementation did the work (the card's kernels fetch the 2x2 taps) and
    it would put the speed of light above the card's measured time. Here
    the flops are ``SWEEP_FLOPS_PER_SAMPLE`` (plus ``BWD_FLOPS_PER_SAMPLE``
    with ``backward``) per sample: the samples inside the tents' support
    when the sweep's arguments ``args`` (grid_sc, coeffs, enables, dt_map)
    are given (:func:`support_samples`), else the upper bound
    ``n_planes * n_v * n_u * active_fraction``. There is no ``window``: it
    modelled the TPU's banded contraction, and one kernel serves banded
    and dense frames alike.
    """
    if args is not None:
        samples = support_samples(args)
    else:
        samples = n_planes * n_v * n_u * active_fraction
    per_sample = SWEEP_FLOPS_PER_SAMPLE + (BWD_FLOPS_PER_SAMPLE if backward
                                           else 0)
    bytes_grid = n_planes * channels * n_y * n_x * itemsize
    if backward:
        bytes_grid *= 3
    return per_sample * samples, bytes_grid * active_fraction


def measured_active_fraction(grid, cam, cfg) -> float:
    """Share of the slices the sweep works on for this view: the slice
    enables (occupancy) times the plan's visible-plane mask, both in
    traversal order. ERT cuts the work further but depends on the rays,
    and is left out."""
    from tpuvr_torch.ops.geometry import plan_sweep, plan_valid_mask
    from tpuvr_torch.ops.render import grid_to_sweep_layout, slice_enables
    from tpuvr_torch.ref.camera import dominant_axis

    axis = dominant_axis(cam)
    plan, _ = plan_sweep(cam, tuple(grid.shape), axis)
    enables = slice_enables(grid_to_sweep_layout(grid, axis), plan.reverse,
                            cfg.use_occupancy)
    enables = enables * plan_valid_mask(plan, enables.dtype, enables.device)
    return float(enables.mean())


def roofline_report(frame_seconds: float, n_planes: int, n_y: int,
                    n_x: int, n_v: int, n_u: int, chip: str = "h100_sxm",
                    precision: str = "highest", backward: bool = False,
                    active_fraction: float = 1.0, args=None):
    """Measured time -> achieved TFLOP/s, GB/s and share of the speed of
    light (see :func:`sweep_cost` for ``args``)."""
    spec = CHIPS[chip]
    flops, byts = sweep_cost(n_planes, n_y, n_x, n_v, n_u,
                             active_fraction=active_fraction,
                             backward=backward, args=args)
    # Every tier runs on the f32 CUDA cores: no kernel of the port uses the
    # tensor cores, even at 'default' (bf16 values, f32 sums). The bf16
    # entry is for the day one does.
    peak_tf = spec.f32_tflops
    t_compute = flops / (peak_tf * 1e12)
    t_memory = byts / (spec.hbm_gbps * 1e9)
    sol = max(t_compute, t_memory)
    return {
        "chip": chip,
        "precision": precision,
        "active_fraction": active_fraction,
        "flops_per_frame": flops,
        "bytes_per_frame": byts,
        "achieved_tflops": flops / frame_seconds / 1e12,
        "achieved_gbps": byts / frame_seconds / 1e9,
        "speed_of_light_s": sol,
        "sol_fraction": sol / frame_seconds,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "rays_per_s": n_v * n_u / frame_seconds,
    }
