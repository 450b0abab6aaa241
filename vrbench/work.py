"""The work a step or a frame needs, counted as the function's and not as
an implementation's: each input read once, each output written once, and
a fixed count of operations per sample inside the tents' support. The
least time of a stage is the larger of its bytes over the card's memory
rate and its operations over its f32 rate (no kernel of the system uses
the tensor cores).

The sweep bounds are a frozen copy of ``tpuvr_torch/bench/roofline.py``'s
``support_samples``, ``sweep_work``, ``sweep_fwd_bound`` and
``sweep_bwd_bound``; the tests hold the two equal. The bake, warp and Adam
counts are the benchmark's own.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA's data sheet for the H100 SXM (dense rates, at its 700 W limit).
HBM_BYTES_PER_S = 3350e9
F32_FLOP_PER_S = 67e12
SWEEP_FLOPS_PER_SAMPLE = 40  # tent weights, 16 taps x 4 ch, exp, composite
# The forward's recompute (40), the adjoint arithmetic (about 30), and the
# transposed resample of 4 channels (40).
BWD_FLOPS_PER_SAMPLE = 110
TAU_FLOPS_PER_VOXEL = 20  # tent weights, 4 taps, relu/fma, row + column
# Adam per parameter: parameter, gradient and both moments read, the
# parameter and both moments written, 4 bytes each.
ADAM_BYTES_PER_PARAM = 7 * 4


def support_samples(args, row0=0):
    """Ray-slices of enabled slices whose two positions lie in the tents'
    support (-1, n), with the kernels' f32 position formula (a product,
    then a sum). The coefficients and enables are (S,) for one view or
    (views, S) for a view batch; the rays are rows [row0, row0 + V /
    views)."""
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
    plane bytes, ray-slice samples of enabled slices, those inside the
    tents' support) of one sweep."""
    grid_sc, coeffs, enables, dt_map = args
    s, _, n_y, n_x = grid_sc.shape
    n_v, n_u = dt_map.shape
    on = (enables > 0).reshape(-1, s)
    samples = int(on.sum()) * (n_v // on.shape[0]) * n_u
    return (int(on.any(0).sum()) * 4 * n_y * n_x * 4, 5 * on.numel() * 4,
            n_v * n_u * 4, samples, support_samples(args, row0))


def sweep_fwd_bound(args, row0=0):
    """(bytes ms, operations ms) of one forward sweep: the enabled slices,
    the scalars and the dt plane read, rgb and T written."""
    grid_b, scal_b, plane_b, _, support = sweep_work(args, row0)
    return ((grid_b + scal_b + 5 * plane_b) / HBM_BYTES_PER_S * 1e3,
            SWEEP_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)


def sweep_bwd_bound(args, row0=0):
    """(bytes ms, operations ms) of one backward sweep: the enabled
    slices, the scalars and 9 ray planes read, the gradient written."""
    grid_b, scal_b, plane_b, _, support = sweep_work(args, row0)
    grad_b = args[0].numel() * 4
    return ((grid_b + grad_b + scal_b + 9 * plane_b) / HBM_BYTES_PER_S * 1e3,
            BWD_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)


def tile_bound(args, row0, backward: bool):
    """(bytes ms, operations ms) of a sweep over a rank's row tile
    [row0, row0 + V / views): as :func:`sweep_fwd_bound` (or
    :func:`sweep_bwd_bound`), but each enabled slice is read only in the
    grid rows that every one of the tile's rows reaches with its tent, at
    least (a quarter of the rows reads about a quarter of the grid; the
    whole gradient is still written)."""
    grid_sc, coeffs, enables, dt_map = args
    s, _, n_y, n_x = grid_sc.shape
    ay, by = (np.atleast_2d(c.detach().cpu().numpy().astype(np.float32))
              for c in coeffs[:2])
    en = np.atleast_2d(enables.detach().cpu().numpy()) != 0
    n_v, n_u = dt_map.shape
    v = np.arange(row0, row0 + n_v // en.shape[0], dtype=np.float32)
    py = ay[..., None] * v + by[..., None]  # (views, S, rows)
    lo = np.clip(np.ceil(py.min(-1)), 0, n_y - 1)
    hi = np.clip(np.floor(py.max(-1)), 0, n_y - 1)
    rows = np.where(en, hi - lo + 1, 0).max(0)  # per slice, the most views
    grid_b = int(rows.sum()) * n_x * 4 * 4
    _, scal_b, plane_b, _, support = sweep_work(args, row0)
    if backward:
        return ((grid_b + grid_sc.numel() * 4 + scal_b + 9 * plane_b)
                / HBM_BYTES_PER_S * 1e3,
                BWD_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)
    return ((grid_b + scal_b + 5 * plane_b) / HBM_BYTES_PER_S * 1e3,
            SWEEP_FLOPS_PER_SAMPLE * support / F32_FLOP_PER_S * 1e3)


def tau_ms(voxels: int, directions: int) -> float:
    """Least ms of a light bake: the density read once, each direction's
    optical depth written once."""
    return max((1 + directions) * voxels * 4 / HBM_BYTES_PER_S * 1e3,
               TAU_FLOPS_PER_VOXEL * directions * voxels
               / F32_FLOP_PER_S * 1e3)


def adam_ms(params: int) -> float:
    return params * ADAM_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3


def warp_ms(n_v: int, n_u: int, h: int, w: int) -> float:
    """Least ms of a pixel warp: the (V, U, 4) intermediate image and the
    (H, W, 2) pixel points read, the (H, W, 4) image written."""
    return (n_v * n_u * 4 + h * w * 6) * 4 / HBM_BYTES_PER_S * 1e3


def sweep_args(grid_shape, views, enables_by_axis, rows=None):
    """The sweep's arguments for a batch of reference ``views`` of one
    group (a shape-only grid on the meta device): the group's enables in
    memory order for its axis are gated by each view's visible planes and
    put in traversal order; ``rows`` (first, count) cuts each view's ray
    plane to a rank's rows."""
    from vrbench.ref.geometry import GRID_PERM

    p0 = views[0].plan
    perm = GRID_PERM[p0.axis]
    s, n_y, n_x = (grid_shape[perm[0]], grid_shape[perm[1]],
                   grid_shape[perm[2]])
    grid_sc = torch.empty((s, 4, n_y, n_x), device="meta")
    en_mem = torch.as_tensor(np.asarray(enables_by_axis[p0.axis],
                                        dtype=np.float32))
    en = en_mem.flip(0) if p0.reverse else en_mem
    coeffs = tuple(torch.stack([v.coeffs[i].cpu() for v in views])
                   for i in range(4))
    enables = torch.stack([en * v.visible.cpu() for v in views])
    r0, count = rows or (0, p0.n_v)
    dt = torch.cat([v.dt[r0:r0 + count].cpu() for v in views])
    if len(views) == 1:
        coeffs = tuple(c[0] for c in coeffs)
        enables = enables[0]
    return (grid_sc, coeffs, enables, dt), r0
