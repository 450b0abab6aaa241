"""The fit traffic: the system's ``fit_grid`` recovering a grid from the
benchmark's posed views.

Set-up makes the scene and the orbit from the seed, renders the targets
with the plain reference, and makes the starting parameters. Then one
training run goes through ``fit_grid`` calls that continue one another
(the parameters passed on, and Adam's state through :class:`Carry`): the
check call (its first steps are what the reference follows), one whole
cycle of view groups (every shape warmed, and the step rate read), and
the window, one call sized to fill ``--seconds``; a traced run then
profiles one more call, a steady part of the same work. On a mesh (the
mix's ``ranks`` > 1) every rank does the same with ``mesh=data_mesh()``.

The options of ``TrainConfig`` and the keywords of ``fit_grid`` are taken
by name from the configuration's file, so a configuration that runs the
fit otherwise (a checkpoint interval, the gradient ring, fused steps) is
a data file.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import sys
import tempfile
import time

import numpy as np
import torch

from vrbench import check, guard, scene, trace, work
from vrbench.ref import geometry as G
from vrbench.ref import sweep as S
from vrbench.ref import train as RT


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Carry:
    """The system's own Adam, carried from one ``fit_grid`` call to the
    next: ``init`` hands back the state the last call ended with, and the
    first ``update`` keeps the leaf norms of the gradient as Adam got it,
    worked out from its state (mu / (1 - b1))."""

    def __init__(self, adam):
        self.adam, self.state, self.first = adam, None, None

    def init(self, params):
        return self.state if self.state is not None else self.adam.init(params)

    def update(self, grads, state):
        updates, self.state = self.adam.update(grads, state)
        if self.first is None:
            mu = self.state[0]
            self.first = [torch.linalg.vector_norm(mu[..., c].double())
                          / (1.0 - self.adam.b1) for c in range(mu.shape[-1])]
        return updates, self.state


def cameras(cfg, traffic, draw):
    n_views = traffic.get("poses", cfg["n_views"])
    return G.orbit(n_views, cfg["grid_n"], cfg["res"],
                   traffic.get("elevation_deg", cfg["elevation_deg"]),
                   draw.azimuth_deg, cfg["distance_factor"], cfg["fov_y_deg"])


def program_cameras(cams):
    from tpuvr_torch.ref.camera import PerspectiveCamera

    return [PerspectiveCamera(**G.cam_fields(c)) for c in cams]


def program_configs(cfg, precision=None):
    from tpuvr_torch.config import LightingConfig, RenderConfig

    rcfg = RenderConfig(early_stop_eps=cfg["early_stop_eps"],
                        use_occupancy=cfg["use_occupancy"],
                        precision=precision or cfg["precision"])
    light = cfg.get("lighting")
    lcfg = None if not light else LightingConfig(
        mode=light["mode"], n_samples=light["n_samples"],
        sky_intensity=light["sky_intensity"], up=tuple(light["up"]),
        detach=light["detach"])
    return rcfg, lcfg


# Set by the job itself, never by a configuration.
JOB_OWNS = {"steps", "seed", "ckpt_dir", "targets", "cams", "grid_shape",
            "cfg", "render_cfg", "mesh", "run_dir", "resume", "lighting",
            "params_init", "opt", "device"}


def train_config(cfg, steps, seed):
    """The system's ``TrainConfig``: every field that the configuration's
    file names, with the job's step count and seed (checkpoints, when on,
    go under the run's temporary directory)."""
    from tpuvr_torch.config import TrainConfig

    opts = {f.name: cfg[f.name] for f in dataclasses.fields(TrainConfig)
            if f.name in cfg and f.name not in JOB_OWNS}
    return TrainConfig(steps=steps, seed=seed, **opts)


def fit_options(cfg):
    """``fit_grid``'s keywords that the configuration's file names
    (``grad_buckets``, ``grad_ring``, ``fused``, ...)."""
    from tpuvr_torch.train.fit import fit_grid

    return {k: cfg[k] for k in inspect.signature(fit_grid).parameters
            if k in cfg and k not in JOB_OWNS}


def render_targets(grid, views, cfg):
    """(N, H, W, 3) reference renders of the lit scene, one sweep layout a
    sweep axis."""
    lit = S.lit(grid, cfg.get("lighting"))
    out = [None] * len(views)
    for axis in sorted({v.plan.axis for v in views}):
        gsc = G.sweep_layout(lit, axis)
        for i, v in enumerate(views):
            if v.plan.axis == axis:
                with torch.no_grad():
                    inter = S.inter_image(gsc, v, cfg["early_stop_eps"],
                                          cfg["use_occupancy"])
                    out[i] = S.warp(inter, v.lattice, v.uv)[..., :3]
        del gsc
    return torch.stack(out)


class Inputs:
    """The run's inputs, made from its seed on ``device``."""

    def __init__(self, cfg, traffic, seed, device):
        n = cfg["grid_n"]
        self.draw = scene.Draw(seed, n)
        self.shape = (n, n, n, 4)
        self.cams = cameras(cfg, traffic, self.draw)
        self.views = [G.view(c, self.shape, device) for c in self.cams]
        grid = scene.smoke_scene(n, self.draw, device)
        self.targets = render_targets(grid, self.views, cfg)
        del grid


def cycle(cfg, views):
    """Steps of one pass over every view group."""
    return len(RT.groups(views)) * max(int(cfg["steps_per_call"]), 1)


def axis_enables(params, cfg):
    """{axis: (S,) bool} per sweep axis, memory order: slices whose largest
    density is above 0 (all, with softplus density)."""
    dens = params[..., 0]
    out = {}
    for axis, dim in ((0, 2), (1, 1), (2, 0)):
        if cfg["density_softplus"] or not cfg["use_occupancy"]:
            out[axis] = np.ones(params.shape[dim], bool)
        else:
            other = tuple(d for d in range(3) if d != dim)
            out[axis] = (torch.amax(dens, dim=other) > 0).cpu().numpy()
    return out


def run(cfg, traffic, seed, seconds, traced, device, mesh=None,
        precision=None, window=True):
    """One run of the fit on ``device`` (this rank's card on a mesh).

    Returns (readings, inputs): the program's readings of the check steps
    (``losses``, ``grad_norms``, ``change_norms``), and with ``window`` the
    window's ``steps``, ``window_s``, ``t_window`` (wall-clock start), the
    peak memory and the enables at the window's start and at the run's end;
    with ``traced`` the profiled call's ``trace_steps`` and its profile's
    summary. ``precision`` overrides the configuration's (the control)."""
    from tpuvr_torch.train.fit import Adam, fit_grid

    inp = Inputs(cfg, traffic, seed, device)
    pcams = program_cameras(inp.cams)
    rcfg, lcfg = program_configs(cfg, precision)
    params = RT.initial_params(cfg, device)
    carry = Carry(Adam(cfg["lr"]))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {}
    kw = dict(render_cfg=rcfg, lighting=lcfg, opt=carry, mesh=mesh,
              device=device, **fit_options(cfg))

    def call(steps, fit_seed, p, run_dir):
        _, p_out, hist = fit_grid(inp.targets, pcams, inp.shape,
                                  train_config(cfg, steps, fit_seed),
                                  params_init=p, run_dir=run_dir, **kw)
        return p_out, hist

    with tempfile.TemporaryDirectory(prefix="vrbench_fit_") as run_dir:
        params, hist = call(check.CHECK_STEPS, inp.draw.fit_seed, params,
                            run_dir)
        out["losses"] = [float(x) for x in hist["loss"]]
        out["grad_norms"] = [float(x) for x in carry.first]
        out["change_norms"] = RT.leaf_norms(
            params - RT.initial_params(cfg, device)).tolist()
        if not window:
            return out, inp
        k = cycle(cfg, inp.views)
        t0 = time.perf_counter()
        params, hist = call(k, inp.draw.fit_seed + 1, params, run_dir)
        sync(device)
        wall = time.perf_counter() - t0
        per_step = float(np.median(hist["step_ms"][1:] or hist["step_ms"]))
        overhead = max(wall * 1e3 - sum(hist["step_ms"]), 0.0)

        def steps_for(s):
            n = max(1, math.floor((s * 1e3 - overhead) / per_step / k)) * k
            if mesh is not None:  # every rank runs the same count
                t = torch.tensor([n], device=device)
                torch.distributed.all_reduce(
                    t, op=torch.distributed.ReduceOp.MIN)
                n = int(t.item())
            return n

        def start():
            sync(device)
            if mesh is not None:
                torch.distributed.barrier()
                sync(device)

        n = steps_for(seconds)
        out["enables_start"] = axis_enables(params, cfg)
        start()
        out["t_window"] = time.time()
        t0 = time.perf_counter()
        params, hist = call(n, inp.draw.fit_seed + 2, params, run_dir)
        sync(device)
        out["window_s"] = time.perf_counter() - t0
        out["steps"] = n
        losses = list(hist["loss"])
        if traced:  # a steady part of the same work, so the trace reads in time
            n_tr = steps_for(min(seconds, trace.SECONDS))
            start()
            with trace.window() as win:
                params, hist = call(n_tr, inp.draw.fit_seed + 3, params,
                                    run_dir)
                sync(device)
            out["trace_steps"] = n_tr
            out["trace"] = trace.summarize(win.prof)
            losses += list(hist["loss"])
        out["failed"] = int(sum(not math.isfinite(x) for x in losses))
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
        out["enables_end"] = axis_enables(params, cfg)
    return out, inp


def bounds(cfg, prog, views, world: int) -> dict:
    """Least ms of the traced call's stages on rank 0: the sweeps over each
    group's least-work minibatch (on a mesh the rank's row tile, which
    reads only the grid rows its rays reach: :func:`work.tile_bound`), with
    the slice enables of the window's start or the run's end, whichever
    needs less; the bake and Adam over the whole grid, every step."""
    shape = (cfg["grid_n"],) * 3 + (4,)
    grp = RT.groups(views)
    steps = prog["trace_steps"]
    steps_per_group = steps / len(grp)
    fwd = bwd = 0.0
    for _, idxs in grp:
        k = min(cfg["views_per_batch"], len(idxs))
        n_v = views[idxs[0]].plan.n_v
        rows = (0, n_v // world) if world > 1 else None
        best = None
        for en in (prog["enables_start"], prog["enables_end"]):
            sizes = sorted(
                (work.support_samples(work.sweep_args(
                    shape, [views[i]], en, rows)[0], 0), i) for i in idxs)
            args, r0 = work.sweep_args(shape, [views[i] for _, i in sizes[:k]],
                                       en, rows)
            if rows is None:
                pair = (max(work.sweep_fwd_bound(args, r0)),
                        max(work.sweep_bwd_bound(args, r0)))
            else:
                pair = (max(work.tile_bound(args, r0, False)),
                        max(work.tile_bound(args, r0, True)))
            best = pair if best is None or sum(pair) < sum(best) else best
        fwd += steps_per_group * best[0]
        bwd += steps_per_group * best[1]
    vox = cfg["grid_n"] ** 3
    light = cfg.get("lighting")
    return {"sweep_fwd": fwd, "sweep_bwd": bwd,
            "tau": steps * work.tau_ms(vox, light["n_samples"])
            if light else 0.0,
            "adam": steps * work.adam_ms(4 * vox)}


def cell(cfg, traffic, args, device):
    """Run the cell: (readings, the numbers compared, requests attempted).
    A mix with ``ranks`` > 1 starts one process a card (gloo on the CPU,
    for the tests) and reads rank 0's, with the largest peak and the mean
    busy and window seconds of the ranks' traces."""
    world = traffic.get("ranks", 1)
    if world > 1:
        from tpuvr_torch.dist.launch import spawn

        on_card = device.type == "cuda"
        ranks = spawn(rank_main, world, "nccl" if on_card else "gloo",
                      device.type, args=(cfg, traffic, args.seed, args.seconds,
                                         bool(args.trace)), timeout_s=900.0)
        prog = ranks[0]
        prog["peak_bytes"] = max(r["peak_bytes"] for r in ranks)
        prog["failed"] = max(r["failed"] for r in ranks)
        prog["forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
        if args.trace:
            prog["busy_s"] = float(np.mean([r["trace"]["busy_s"]
                                            for r in ranks]))
            prog["trace_window_s"] = float(np.mean(
                [r["trace"]["window_s"] for r in ranks]))
        inp = Inputs(cfg, traffic, args.seed, device)
    else:
        prog, inp = run(cfg, traffic, args.seed, args.seconds,
                        bool(args.trace), device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = check.fit_reference(cfg, inp, device)
    numbers = check.fit_numbers(prog, ref)
    print(f"vrbench: the reference took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if args.trace:
        prog["bounds"] = bounds(cfg, prog, inp.views, world)
    return prog, numbers, prog["steps"] + prog.get("trace_steps", 0)


def rank_device():
    """This rank's device: its card under NCCL, the CPU under gloo (the
    tests)."""
    if torch.distributed.get_backend() == "nccl":
        torch.set_num_threads(1)
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_main(cfg, traffic, seed, seconds, traced):
    """One rank of a multi-card fit (``tpuvr_torch.dist.launch.spawn``
    brought its process group up: NCCL, one card a rank)."""
    from tpuvr_torch.dist.init import data_mesh

    mesh = data_mesh()
    out, _ = run(cfg, traffic, seed, seconds, traced, rank_device(), mesh=mesh)
    out["rank"] = mesh.rank
    out["forbidden"] = guard.forbidden_modules()  # this rank's, after its window
    return out
