"""Scaling table: rays/s of one frame on one card, and on a mesh of ranks.

Times come from CUDA events around a loop of frames on the card (the
events are read after a synchronize) and from the host clock on the CPU.
The loop grows until it lasts ``min_wall`` seconds.
"""

from __future__ import annotations

import torch

from tpuvr_torch.bench.judged import loop_seconds
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.device import resolve_device


def _time_frames(frame, on_card: bool, min_wall: float, mesh=None) -> float:
    """Seconds per frame over a loop that lasts at least ``min_wall``
    seconds (starting at 4 frames, 4 times longer each try, at most
    4096). On a mesh every rank takes rank 0's time, so that all ranks run
    the same number of frames, hence of collectives."""
    from tpuvr_torch.dist.init import broadcast

    frame()
    if on_card:
        torch.cuda.synchronize()
    iters = 4
    while True:
        wall, _ = loop_seconds(lambda _: frame(), None, iters, on_card)
        if mesh is not None:
            t = torch.tensor([wall], dtype=torch.float64,
                             device="cuda" if on_card else "cpu")
            wall = float(broadcast(t, mesh))
        if wall >= min_wall or iters >= 4096:
            return wall / iters
        iters *= 4


def scaling_table(grid, cam, cfg: RenderConfig = RenderConfig(),
                  min_wall: float = 2.0, mesh=None, device=None):
    """rays/s of ``render_view`` on one card and, with a
    :class:`~tpuvr_torch.dist.init.DataMesh`, of ``render_view_dp`` over
    its ranks. Every rank of the mesh calls it with the same arguments and
    times the same frames; rank 0's list holds the n-rank row, with its
    ``efficiency`` against n times the one-card rate. Both rows run the
    CUDA kernels on the card and the plain versions on the CPU, as
    ``render_view`` does. Returns a list of row dicts."""
    from tpuvr_torch.dist.replicated import render_view_dp
    from tpuvr_torch.ops.render import render_view

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    grid = torch.as_tensor(grid, device=dev)
    rays = cam.res_x * cam.res_y
    with torch.no_grad():
        t1 = _time_frames(lambda: render_view(grid, cam, cfg, device=dev),
                          on_card, min_wall, mesh)
    rows = [{"devices": 1, "hosts": 1, "ms_per_frame": t1 * 1e3,
             "rays_per_s": rays / t1, "efficiency": 1.0}]
    if mesh is not None and mesh.world > 1:
        tn = _time_frames(lambda: render_view_dp(grid, cam, mesh, cfg,
                                                 device=dev),
                          on_card, min_wall, mesh)
        if mesh.rank == 0:
            rows.append({"devices": mesh.world, "hosts": 1,
                         "ms_per_frame": tn * 1e3, "rays_per_s": rays / tn,
                         "efficiency": (rays / tn) / (mesh.world * rays
                                                      / t1)})
    return rows
