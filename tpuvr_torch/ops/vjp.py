"""The sweep op and row chunking.

Forward only in this package so far: on the card, a grid that asks for a
gradient is refused (``tpuvr_torch.device.check_no_cuda_grad``); on the
CPU the plain twin is ordinary autograd-able PyTorch.
"""

from __future__ import annotations

import torch

from tpuvr_torch.device import check_no_cuda_grad
from tpuvr_torch.kernels.sweep import sweep_fwd
from tpuvr_torch.kernels.sweep_torch import sweep_fwd_torch


def resolve_impl(impl: str | None, t: torch.Tensor) -> str:
    """'auto'/None -> 'cuda' for a CUDA tensor, 'torch' for a CPU one."""
    if impl in (None, "auto"):
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA tensor")
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown sweep impl: {impl!r}")
    return impl


def sweep_op(
    reverse: bool,
    sigma_scale: float,
    early_stop_eps: float,
    impl: str,
    precision: str = "highest",
):
    """(grid_sc, coeffs, enables, dt_map) -> (rgb (3, V, U), T (V, U)).

    ``impl`` 'cuda' runs the CUDA kernel, 'torch' the plain twin.
    """
    fwd = sweep_fwd if impl == "cuda" else sweep_fwd_torch

    def op(grid_sc, coeffs, enables, dt_map):
        check_no_cuda_grad(grid_sc, "sweep_op")
        return fwd(
            grid_sc, coeffs, enables, dt_map, reverse=reverse,
            sigma_scale=sigma_scale, early_stop_eps=early_stop_eps,
            precision=precision,
        )

    return op


def chunked_sweep(op, grid_sc, coeffs, enables, dt_map, max_rows=None):
    """Apply a sweep op over row chunks of the intermediate image.

    Row ``r0 + v`` of the full image samples at ``(r0 + v)*ay + by``, so a
    chunk is exactly the full op with ``by := by + r0*ay``. Per-chunk early
    termination is at least as aggressive as whole-image termination and
    keeps the same error bound. ``max_rows`` None disables chunking.
    """
    n_v = dt_map.shape[0]
    if max_rows is None or n_v <= max_rows:
        return op(grid_sc, coeffs, enables, dt_map)
    n_chunks = -(-n_v // max_rows)
    while n_v % n_chunks:
        n_chunks += 1
    rows = n_v // n_chunks
    ay, by, ax, bx = coeffs
    rgbs, ts = [], []
    for i in range(n_chunks):
        r0 = i * rows
        rgb_i, t_i = op(grid_sc, (ay, by + r0 * ay, ax, bx), enables,
                        dt_map[r0:r0 + rows])
        rgbs.append(rgb_i)
        ts.append(t_i)
    return torch.cat(rgbs, dim=1), torch.cat(ts, dim=0)
