"""The least work of what an undetached light adds to a fit step, counted
as :mod:`vrbench.work` counts (each input read once, each output written
once, on the card's published rates): the tau sweeps' adjoint (K4) and
the lit grid's assembly each way.
"""

from __future__ import annotations

from vrbench.work import F32_FLOP_PER_S, HBM_BYTES_PER_S, TAU_FLOPS_PER_VOXEL


def tau_adj_ms(voxels: int, directions: int) -> float:
    """Least ms of the adjoint of a bake's tau sweeps: each direction's
    cotangent read once and its gradient written once (the adjoint reads
    no density: the relu mask is applied after it)."""
    return max(2 * directions * voxels * 4 / HBM_BYTES_PER_S * 1e3,
               TAU_FLOPS_PER_VOXEL * directions * voxels
               / F32_FLOP_PER_S * 1e3)


def assembly_ms(voxels: int, directions: int) -> float:
    """Least ms of the lit grid's assembly from the taus, with the light
    differentiated, both ways. Forward: the grid's 4 channels and every
    direction's tau read, the lit grid's 4 written. Backward: the lit
    grid's cotangent (4 channels), the emission (3) and the taus read, the
    grid's gradient (4) and every tau's cotangent written."""
    volumes = (4 + directions + 4) + (4 + 3 + directions + 4 + directions)
    return volumes * voxels * 4 / HBM_BYTES_PER_S * 1e3
