"""tpuvr_torch command line: render / turntable / fit / bench / gradcheck.

Each subcommand drives the package at full scale from one of its configs
(``tpuvr_torch.configs.CONFIGS``) with ``--set field=value`` overrides::

  python -m tpuvr_torch.cli render --config c3 --out c3.png --scale 0.25
  python -m tpuvr_torch.cli fit --config c4 --scale 0.125 --steps 200
  python -m tpuvr_torch.cli bench --config c1
  python -m tpuvr_torch.cli gradcheck

``--scale`` shrinks grid and resolution; 1.0 is the configs' own shape.
Every command runs on the card (the CUDA kernels) unless given
``--device cpu`` (the plain PyTorch versions); a missing card is an error.
``fit`` with a config that has a mesh starts one rank per card when the
machine has more than one (NCCL); one card, or the CPU, trains without a
mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import tempfile
import time

from tpuvr_torch.configs import CAMERAS, CONFIGS

# A rank of a multi-card fit that has not returned within this many
# seconds (or waits as long on a collective) fails the run.
_RANK_TIMEOUT_S = 24 * 3600.0


def _load_config(name: str, scale: float, sets=None):
    cfg = dict(CONFIGS[name])
    cfg["grid_n"] = max(8, int(cfg["grid_n"] * scale))
    cfg["res"] = max(8, int(cfg["res"] * scale))
    return _apply_overrides(cfg, sets or [])


def _apply_overrides(cfg, sets):
    """Apply ``--set field=value`` overrides to the config dataclasses.

    The field is looked up across the render / train / lighting /
    mesh_cfg dataclasses (plus the top-level int keys grid_n / res /
    n_views); values parse by the field's current type. Example:
    ``--set ert_chunks=8 --set steps_per_call=16 --set grid_n=128``.
    """
    for kv in sets:
        key, _, raw = kv.partition("=")
        if not _:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        if key in ("grid_n", "res", "n_views"):
            cfg[key] = int(raw)
            continue
        for slot in ("render", "train", "lighting", "mesh_cfg"):
            dc = cfg.get(slot)
            if dc is None or not dataclasses.is_dataclass(dc):
                continue
            fields = {f.name: f for f in dataclasses.fields(dc)}
            if key not in fields:
                continue
            cur = getattr(dc, key)
            if raw in ("None", "none"):
                val = None
            elif isinstance(cur, bool):
                val = raw.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            else:
                # None-defaulted Optional fields and strings: try int,
                # then float, then keep the string.
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
            cfg[slot] = dataclasses.replace(dc, **{key: val})
            break
        else:
            raise SystemExit(
                f"--set: no config field named {key!r} in "
                "render/train/lighting/mesh_cfg"
            )
    return cfg


def _scene_and_camera(cfg, device):
    from tpuvr_torch.io.synth import smoke_sphere

    grid = smoke_sphere(cfg["grid_n"], device=device)
    cam = CAMERAS[cfg.get("camera") or "front_ortho"](cfg["grid_n"],
                                                      cfg["res"])
    return grid, cam


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cmd_render(args):
    """One view to a PNG. Returns the image (H, W, 3) as numpy."""
    from tpuvr_torch.io.image import host_array, write_png
    from tpuvr_torch.ops.render import render_view

    cfg = _load_config(args.config, args.scale, args.sets)
    grid, cam = _scene_and_camera(cfg, args.device)
    t0 = time.time()
    rgb, _ = render_view(grid, cam, cfg["render"],
                         lighting=cfg.get("lighting"), device=args.device)
    rgb = host_array(rgb)
    dt = time.time() - t0
    print(f"rendered {cfg['res']}x{cfg['res']} in {dt:.2f}s "
          f"(incl. compile); mean {rgb.mean():.4f}")
    if args.out:
        write_png(args.out, rgb)
        print(f"wrote {args.out}")
    return rgb


def cmd_turntable(args):
    """Orbit render loop: the volume is prepared once (layout, occupancy,
    lighting) and each frame costs one sweep and one pixel warp
    (``render_prepared``). Returns the printed record."""
    from tpuvr_torch.io.image import write_png
    from tpuvr_torch.io.synth import orbit_cameras
    from tpuvr_torch.ops.render import prepare_grid, render_prepared
    from tpuvr_torch.ref.camera import dominant_axis

    cfg = _load_config(args.config, args.scale, args.sets)
    grid, _ = _scene_and_camera(cfg, args.device)
    cams = orbit_cameras(args.frames, cfg["grid_n"], res=cfg["res"])
    os.makedirs(args.out_dir, exist_ok=True)
    axes = tuple(sorted({dominant_axis(c) for c in cams}))
    prep = prepare_grid(grid, axes=axes, lighting=cfg.get("lighting"),
                        precision=cfg["render"].precision, device=args.device)
    t0 = time.time()
    for i, cam in enumerate(cams):
        rgb, _ = render_prepared(prep, cam, cfg["render"], device=args.device)
        write_png(f"{args.out_dir}/frame_{i:04d}.png", rgb)
    dt = time.time() - t0
    out = {
        "frames": len(cams), "out_dir": args.out_dir,
        "s_per_frame_incl_io_and_compile": round(dt / len(cams), 4),
    }
    print(json.dumps(out))
    return out


def _fit_layout(cfg, device):
    """(ranks, zshard) of a fit: the config's MeshConfig (a c5-style
    ``mesh_cfg``, or the ``"mesh": "data"`` key as ``MeshConfig(data=0)``,
    every card) over the cards of this machine. One card, or the CPU,
    gives (1, 1): no mesh. ``zshard`` > 1 takes a ``('data', 'z')`` mesh
    when there are at least twice as many cards, as the JAX package's
    CLI does."""
    import torch

    from tpuvr_torch.config import MeshConfig

    mesh_cfg = cfg.get("mesh_cfg")
    if mesh_cfg is None and cfg.get("mesh") == "data":
        mesh_cfg = MeshConfig(data=0)
    if mesh_cfg is None or torch.device(device).type != "cuda":
        return 1, 1
    n_dev = torch.cuda.device_count()
    if mesh_cfg.zshard > 1 and n_dev >= 2 * mesh_cfg.zshard:
        n_data = mesh_cfg.data or n_dev // mesh_cfg.zshard
        return n_data * mesh_cfg.zshard, mesh_cfg.zshard
    if n_dev > 1:
        return mesh_cfg.data or n_dev, 1
    return 1, 1


def cmd_fit(args):
    """Inverse rendering: target views of the smoke scene, ``fit_grid``,
    then ``evaluate_psnr``. Returns rank 0's printed record."""
    from tpuvr_torch.dist.launch import spawn

    cfg = _load_config(args.config, args.scale, args.sets)
    world, zshard = _fit_layout(cfg, args.device)
    if world > 1:
        return spawn(_fit_rank, world, "nccl", "cuda", (args, zshard),
                     timeout_s=_RANK_TIMEOUT_S)[0]
    return _fit(args, None)


def _fit_rank(args, zshard):
    """One rank of a multi-card fit: its mesh, then the command's body."""
    import torch.distributed as dist

    from tpuvr_torch.dist.init import data_mesh, grid_mesh

    world = dist.get_world_size()
    mesh = (grid_mesh(world // zshard, zshard) if zshard > 1
            else data_mesh())
    return _fit(args, mesh)


def _fit(args, mesh):
    import torch

    from tpuvr_torch.dist.init import GridMesh, all_gather
    from tpuvr_torch.io.synth import orbit_cameras, smoke_sphere
    from tpuvr_torch.train.fit import (
        evaluate_psnr,
        fit_grid,
        render_all_views,
    )

    main_rank = mesh is None or mesh.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    device = args.device
    if mesh is not None and device == "cuda":  # the card this rank took
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = _load_config(args.config, args.scale, args.sets)
    n = cfg["grid_n"]
    n_views = cfg.get("n_views", 16)
    tcfg = cfg["train"]
    if args.steps:
        tcfg = dataclasses.replace(tcfg, steps=args.steps)
    grid_true = smoke_sphere(n, device=device)
    cams = orbit_cameras(n_views, n, res=cfg["res"])
    say(f"rendering {n_views} target views at {cfg['res']}^2 ...")
    targets = render_all_views(grid_true, cams, cfg["render"], device=device)
    mesh_cfg = cfg.get("mesh_cfg")
    kw = {}
    if mesh is not None and mesh_cfg is not None:
        kw = dict(grad_buckets=mesh_cfg.grad_buckets,
                  bwd_chunks=mesh_cfg.bwd_chunks,
                  grad_ring=mesh_cfg.grad_ring)
    say(f"fitting {n}^3 grid from {n_views} views "
        f"(mesh={dict(mesh.shape) if mesh else None}) ...")
    grid, _, hist = fit_grid(
        targets, cams, tuple(grid_true.shape), tcfg, cfg["render"],
        mesh=mesh, run_dir=args.run_dir, resume=args.resume, device=device,
        **kw)
    if isinstance(mesh, GridMesh):  # the rank's z slab: gather the grid
        with torch.no_grad():
            grid = all_gather(grid, mesh.z).flatten(0, 1)
    psnr = evaluate_psnr(grid, cams, targets, cfg["render"], device=device)
    out = {"final_loss": hist["loss"][-1], "psnr_db": psnr,
           "steps": len(hist["loss"])}
    say(json.dumps(out))
    return out


def _device_name(device) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def cmd_bench(args):
    """rays/s, the roofline share and, with ``--profile``, a trace of one
    warm frame. Every printed row names the device it ran on. Returns the
    printed records."""
    from tpuvr_torch.bench.roofline import (
        measured_active_fraction,
        roofline_report,
    )
    from tpuvr_torch.bench.sweep import scaling_table

    cfg = _load_config(args.config, args.scale, args.sets)
    grid, cam = _scene_and_camera(cfg, args.device)
    device = _device_name(args.device)
    out = []
    if args.profile:
        out.append(_profile_frame(grid, cam, cfg["render"], args.device,
                                  args.profile))
        print(json.dumps(out[-1]))
    rows = scaling_table(grid, cam, cfg["render"], device=args.device)
    for row in rows:
        out.append(dict(row, device=device))
        print(json.dumps(out[-1]))
    af = measured_active_fraction(grid, cam, cfg["render"])
    rep = roofline_report(
        rows[0]["ms_per_frame"] / 1e3,
        cfg["grid_n"], cfg["grid_n"], cfg["grid_n"],
        cam.res_y, cam.res_x,
        chip=args.chip, precision=cfg["render"].precision,
        active_fraction=af,
    )
    out.append(dict(rep, device=device))
    print(json.dumps(out[-1]))
    return out


def _profile_frame(grid, cam, cfg, device, trace_dir):
    """A ``torch.profiler`` Chrome trace of one warm frame, written to
    ``trace_dir/trace.json`` (view it in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpuvr_torch.ops.render import render_view

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.no_grad():
        render_view(grid, cam, cfg, device=device)
        _sync(device)
        with profile(activities=activities) as prof:
            render_view(grid, cam, cfg, device=device)
            _sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return {"trace_dir": trace_dir}


def cmd_gradcheck(args):
    """The grid gradient of ``sum(rgb^2) + sum(T)`` against central
    differences at ``--probes`` random voxels. Returns the printed
    record."""
    import numpy as np
    import torch

    from tpuvr_torch.config import RenderConfig
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops.render import render_view
    from tpuvr_torch.ref.camera import look_at_perspective

    n, res = args.grid_n, args.res
    grid = smoke_sphere(n, device=args.device)
    c = (n - 1) / 2.0
    cam = look_at_perspective((c, c - 3.0 * n, c + 0.7 * n), (c, c, c),
                              res_x=res, res_y=res)
    rcfg = RenderConfig(early_stop_eps=0.0)

    def loss(g):
        rgb, t = render_view(g, cam, rcfg, device=args.device)
        return torch.sum(rgb**2) + torch.sum(t)

    leaf = grid.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(leaf), leaf)
    rng = np.random.default_rng(0)
    h, worst = 1e-3, 0.0
    with torch.no_grad():
        for _ in range(args.probes):
            idx = tuple(int(rng.integers(0, s)) for s in grid.shape)
            up, down = grid.clone(), grid.clone()
            up[idx] += h
            down[idx] -= h
            fd = float((loss(up) - loss(down)) / (2 * h))
            worst = max(worst, abs(float(g[idx]) - fd))
    out = {"max_abs_err_vs_fd": worst, "probes": args.probes}
    print(json.dumps(out))
    return out


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns."""
    from tpuvr_torch.bench.roofline import CHIPS

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(prog="tpuvr_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tmp = tempfile.gettempdir()

    def device_flag(sp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="'cuda': the card's kernels (the default); "
                             "'cpu': the plain PyTorch versions")

    def common(sp):
        sp.add_argument("--config", default="c1", choices=sorted(CONFIGS))
        sp.add_argument("--scale", type=float, default=1.0)
        device_flag(sp)
        sp.add_argument("--set", action="append", default=[],
                        metavar="FIELD=VALUE", dest="sets",
                        help="override any config dataclass field, "
                             "e.g. --set ert_chunks=8")

    sp = sub.add_parser("render", help="render one view to PNG")
    common(sp)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("turntable", help="orbit render loop to PNGs")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--out-dir", default=os.path.join(tmp, "tpuvr_turntable"))
    sp.set_defaults(fn=cmd_turntable)

    sp = sub.add_parser("fit", help="inverse rendering")
    common(sp)
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--run-dir", default=os.path.join(tmp, "tpuvr_run"))
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("bench", help="rays/s + roofline + scaling")
    common(sp)
    sp.add_argument("--chip", default="h100_sxm", choices=sorted(CHIPS))
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one frame")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("gradcheck", help="finite-difference gradcheck")
    sp.add_argument("--grid-n", type=int, default=12)
    sp.add_argument("--res", type=int, default=16)
    sp.add_argument("--probes", type=int, default=10)
    device_flag(sp)
    sp.set_defaults(fn=cmd_gradcheck)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    # Through the package's own module, so that what a multi-card fit's
    # ranks unpickle (this module's functions) imports by name.
    from tpuvr_torch.cli import main as _main

    _main()
