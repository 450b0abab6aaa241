"""The orbit traffic: a closed-loop viewer with one client.

Set-up makes the scene and a ring of poses from the seed and runs the
system's ``prepare_grid`` once (sweep layouts for the ring's axes,
occupancy, the light baked in), then renders every pose a few times. The
window renders a fixed number of frames, sized from the warm-up's rate,
through ``render_prepared``, pose after pose around the ring; each frame
is timed from the loop's request to its image on the host, copied there
before the next is asked for. A sample of frames drawn from the seed is
kept for the check.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from vrbench import check, fitjob, scene, trace, work
from vrbench.ref import geometry as G


def run(cfg, traffic, seed, seconds, traced, device, precision=None,
        window=True):
    """One run of the viewer on ``device``. Returns (readings, inputs):
    ``frames``, ``window_s``, ``latency_s`` and ``issue_s`` (a frame's
    request to its image on the host, and to ``render_prepared``'s
    return), the peak memory, the kept frames ``{frame: (pose, rgb)}``
    and the prepared grid (for the check), with ``traced`` the profile's
    summary. Without ``window`` only the kept sample of one pass of warm-up
    frames."""
    from tpuvr_torch.ops.render import prepare_grid, render_prepared

    n = cfg["grid_n"]
    draw = scene.Draw(seed, n)
    cams = fitjob.cameras(cfg, traffic, draw)
    pcams = fitjob.program_cameras(cams)
    rcfg, lcfg = fitjob.program_configs(cfg, precision)
    grid = scene.smoke_scene(n, draw, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    axes = tuple(sorted({G.dominant_axis(c) for c in cams}))
    prep = prepare_grid(grid, axes=axes, lighting=lcfg,
                        precision=rcfg.precision, device=device)
    del grid
    res = cfg["res"]
    pin = device.type == "cuda"
    host = torch.empty((res, res, 3), pin_memory=pin)
    n_poses = len(cams)

    def frame(i, dst):
        t_req = time.perf_counter()
        rgb, _ = render_prepared(prep, pcams[i % n_poses], rcfg, device=device)
        t_issue = time.perf_counter()
        dst.copy_(rgb, non_blocking=pin)
        fitjob.sync(device)
        return t_req, t_issue, time.perf_counter()

    out = {}
    for i in range((traffic["warmup_rounds"] - 1) * n_poses):
        frame(i, host)
    t0 = time.perf_counter()  # the last round: every pose's plan cached
    for i in range(n_poses):
        frame(i, host)
    per_frame = (time.perf_counter() - t0) / n_poses

    def frames_for(s):
        return max(1, math.floor(s / per_frame / n_poses)) * n_poses

    n_frames = frames_for(seconds) if window else n_poses
    rng = np.random.default_rng([seed, 1])
    sample = sorted(rng.choice(n_frames, size=min(traffic["check_frames"],
                                                  n_frames), replace=False))
    kept = {int(f): torch.empty((res, res, 3), pin_memory=pin)
            for f in sample}
    if not window:
        for f in kept:
            frame(f, kept[f])
        out["kept"] = {f: (f % n_poses, img) for f, img in kept.items()}
        out["prep"] = prep
        return out, cams
    lat = np.empty(n_frames)
    issue = np.empty(n_frames)
    out["t_window"] = time.time()
    t_start = time.perf_counter()
    for i in range(n_frames):
        t_req, t_issue, t_done = frame(i, kept.get(i, host))
        lat[i] = t_done - t_req
        issue[i] = t_issue - t_req
    out["window_s"] = time.perf_counter() - t_start
    if traced:  # a steady part of the same loop, so the trace reads in time
        n_tr = frames_for(min(seconds, trace.SECONDS))
        with trace.window() as win:
            for i in range(n_tr):
                frame(i, host)
        out["trace_frames"] = n_tr
        out["trace"] = trace.summarize(win.prof)
    out["frames"] = n_frames
    out["latency_s"] = lat
    out["issue_s"] = issue
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    out["kept"] = {f: (f % n_poses, img) for f, img in kept.items()}
    out["prep"] = prep
    out["failed"] = int(sum(not bool(torch.isfinite(img).all())
                            for _, img in out["kept"].values()))
    return out, cams


def scene_enables(cfg, seed, device) -> dict:
    """{axis: (S,) bool} slices of the seed's scene with density above 0."""
    n = cfg["grid_n"]
    grid = scene.smoke_scene(n, scene.Draw(seed, n), device)
    return fitjob.axis_enables(grid, dict(cfg, density_softplus=False))


def bounds(cfg, prog, cams, enables) -> dict:
    """Least ms of the profiled frames' forward sweeps and pixel warps."""
    shape = (cfg["grid_n"],) * 3 + (4,)
    fwd = warp = 0.0
    per_pose = prog["trace_frames"] / len(cams)
    for cam in cams:
        v = G.view(cam, shape, "cpu")
        args, r0 = work.sweep_args(shape, [v], enables)
        fwd += per_pose * max(work.sweep_fwd_bound(args, r0))
        warp += per_pose * work.warp_ms(v.plan.n_v, v.plan.n_u, cam.res_y,
                                        cam.res_x)
    return {"sweep_fwd": fwd, "warp": warp}


def cell(cfg, traffic, args, device):
    """Run the cell: (readings, the numbers compared, frames attempted)."""
    prog, cams = run(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                     device)
    t0 = time.perf_counter()
    numbers = check.view_numbers(cfg, args.seed, cams, prog.pop("kept"),
                                 prog.pop("prep"), device)
    print(f"vrbench: the reference took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if args.trace:
        prog["bounds"] = bounds(cfg, prog, cams,
                                scene_enables(cfg, args.seed, device))
    return prog, numbers, prog["frames"] + prog.get("trace_frames", 0)
