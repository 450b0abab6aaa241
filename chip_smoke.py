#!/usr/bin/env python3
"""Drive tpuvr_torch on one NVIDIA card and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. build the CUDA kernels from tpuvr_torch/csrc (into tpuvr_torch/_build);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, and the whole render path against device="cpu" on
     a small input;
  3. the main path at full size through the entry points (device=None):
     c1, c2 and the 256^3 @ 512^2 headline frame as frame loops, and c3 lit
     (16-direction light bake, then frames), timed with CUDA events; the
     kernels' launch counts are zeroed before and read after;
  4. print one JSON line per kernel (time, bound, plain and library
     yardsticks), the card's name and power limit from nvidia-smi, and last
     {"ok": true, "device": {...}}.
Without a card it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
SWEEP_FLOPS_PER_SAMPLE = 40  # tent weights, 16 taps x 4 ch, exp, composite
TAU_FLOPS_PER_VOXEL = 20     # tent weights, 4 taps, relu/fma, row+column


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time per call from torch.profiler (the device-side kernel
    and memcpy events over ``reps`` calls; the host ops that launched them
    report the same time and are skipped), and the three largest entries
    by name; None if the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = e.self_device_time_total
        if e.device_type != DeviceType.CPU and t > 0:
            per[e.key[:48]] = per.get(e.key[:48], 0.0) + t / 1e3 / reps
    if not per:
        return None, []
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return sum(per.values()), top


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import _build
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels.sweep_torch import sweep_fwd_torch
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    log(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} "
        f"card {torch.cuda.get_device_name(0)}")

    # 1. Build.
    t0 = time.time()
    logs = _build.build()
    log(f"[build] {sorted(_build.SOURCES)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 2. Kernels against their plain versions, on the card.
    def scene(name):
        cfg = configs.CONFIGS[name]
        grid = smoke_sphere(cfg["grid_n"], device=dev)
        cam = configs.camera(cfg)
        axis = dominant_axis(cam)
        prep = render.prepare_grid(grid, axes=(axis,),
                                   precision=cfg["render"].precision,
                                   device=dev)
        plan, _, args = render.sweep_inputs(prep, cam, cfg["render"], dev)
        return cfg, grid, cam, plan, args

    def sweep_bound(args):
        """(bytes ms, operations ms): each input read once (only enabled
        slices of the grid), each output written once; 40 flop per
        sample of an enabled slice. That is the work these inputs need
        when no ray terminates early (the caller logs how many did)."""
        grid_sc, coeffs, enables, dt_map = args
        s, _, n_y, n_x = grid_sc.shape
        n_v, n_u = dt_map.shape
        n_en = int((enables > 0).sum())
        nbytes = (n_en * 4 * n_y * n_x + 5 * s + 5 * n_v * n_u) * 4
        return (nbytes / HBM_BYTES_PER_S * 1e3,
                SWEEP_FLOPS_PER_SAMPLE * n_v * n_u * n_en
                / F32_FLOP_PER_S * 1e3)

    def grid_sample_ms(args):
        """Yardstick: one grid_sample of slice 0 at its sample positions,
        times S (the port never calls it)."""
        grid_sc, coeffs, _, dt_map = args
        s, _, n_y, n_x = grid_sc.shape
        n_v, n_u = dt_map.shape
        ay, by, ax, bx = (c[0] for c in coeffs)
        ys = (torch.arange(n_v, device=dev) * ay + by) / (n_y - 1) * 2 - 1
        xs = (torch.arange(n_u, device=dev) * ax + bx) / (n_x - 1) * 2 - 1
        pos = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]),
                          dim=-1)[None]
        one = grid_sc[:1]
        return s * cuda_ms(lambda: torch.nn.functional.grid_sample(
            one, pos, mode="bilinear", padding_mode="zeros",
            align_corners=True), 20)

    sweep_err = 0.0
    sweep_ms = {}
    for name in ("c1", "c2", "headline"):
        cfg, grid, cam, plan, args = scene(name)
        cmax = float(grid[..., 1:].abs().max())
        outs = {}
        for prec in ("highest", "default"):
            for eps in (0.0, 1e-4):
                kw = dict(reverse=plan.reverse, early_stop_eps=eps,
                          precision=prec,
                          sigma_scale=cfg["render"].sigma_scale)
                k = ksweep.sweep_fwd(*args, **kw)
                p = sweep_fwd_torch(*args, **kw)
                torch.cuda.synchronize()
                err = max_err(k, p)
                # eps = 0: f32 roundoff. eps > 0: the kernel stops each
                # ray at its own T < eps, the plain version at the global
                # max, so |d rgb| <= eps*max|c| and |d T| <= eps.
                tol = 1e-5 + eps * max(cmax, 1.0)
                log(f"[kernel] sweep_fwd {name} S={args[0].shape[0]} "
                    f"V,U={tuple(args[3].shape)} reverse={plan.reverse} "
                    f"{prec} eps={eps:g}: max abs err {err:.3e} "
                    f"(tol {tol:.1e})")
                check(err <= tol, f"sweep_fwd {name} {prec} eps={eps}")
                check(all(bool(torch.isfinite(t).all()) for t in k),
                      "non-finite kernel output")
                if eps == 0.0 and prec == "highest":
                    sweep_err = max(sweep_err, err)
                outs[(prec, eps)] = k
        # 'default' rounds weights, values, the row partial and the column
        # weights to bf16: four roundings of <= 2^-9 relative per sample,
        # <= 7.8e-3 * |sample| before the transmittance change it causes.
        tier = max_err(outs[("default", 0.0)], outs[("highest", 0.0)])
        log(f"[kernel] sweep_fwd {name}: 'default' vs 'highest' max abs "
            f"{tier:.3e} (tol 1e-2; the config states ~5e-3)")
        check(tier <= 1e-2, f"'default' tier error at {name}")
        run = cfg["render"]
        kw = dict(reverse=plan.reverse, early_stop_eps=run.early_stop_eps,
                  precision=run.precision, sigma_scale=run.sigma_scale)
        bytes_ms, ops_ms = sweep_bound(args)
        t_run = outs[(run.precision, run.early_stop_eps)][1]
        sweep_ms[name] = dict(
            ms=cuda_ms(lambda: ksweep.sweep_fwd(*args, **kw), 10),
            plain_ms=cuda_ms(lambda: sweep_fwd_torch(*args, **kw), 2),
            bytes_ms=bytes_ms, ops_ms=ops_ms,
            library_ms=grid_sample_ms(args),
            rays_terminated=int((t_run < run.early_stop_eps).sum()))
        log(f"[kernel] sweep_fwd {name} ({run.precision}, eps "
            f"{run.early_stop_eps:g}): " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in sweep_ms[name].items()))
        del grid, args, outs

    # K2 at 256^3: positive d; negative d on a flipped, permuted axis.
    sigma = smoke_sphere(256, device=dev)[..., 0].contiguous()
    tau_err = 0.0
    tau_cases = [
        (sigma, 0.31, 0.52),
        (sigma.permute(2, 1, 0).flip(0).contiguous(), -0.44, -0.9),
    ]
    for sig_p, d_y, d_x in tau_cases:
        dt = (1.0 + d_y * d_y + d_x * d_x) ** 0.5
        for prec in ("highest", "default"):
            kw = dict(d_y=d_y, d_x=d_x, dt=dt, precision=prec)
            k = klight.tau_sweep(sig_p, **kw)
            p = klight.tau_sweep_torch(sig_p, **kw)
            torch.cuda.synchronize()
            scale = float(p.abs().max())
            err = float((k - p).abs().max())
            log(f"[kernel] tau_sweep 256^3 d=({d_y:g},{d_x:g}) {prec}: "
                f"max abs err {err:.3e}, {err / scale:.3e} of max tau "
                f"{scale:.3f} (tol 1e-5 of max tau)")
            check(err <= 1e-5 * scale and bool(torch.isfinite(k).all()),
                  f"tau_sweep d=({d_y},{d_x}) {prec}")
            if prec == "highest":
                tau_err = max(tau_err, err)
    tau_kw = dict(d_y=0.31, d_x=0.52, dt=(1 + 0.31**2 + 0.52**2) ** 0.5)
    tau_ms = cuda_ms(lambda: klight.tau_sweep(sigma, **tau_kw), 5)
    tau_plain_ms = cuda_ms(lambda: klight.tau_sweep_torch(sigma, **tau_kw),
                           2)
    log(f"[kernel] tau_sweep 256^3: {tau_ms:.4f} ms/direction "
        f"(plain {tau_plain_ms:.4f})")

    # Whole render path: card against device="cpu" on small inputs.
    for name, n, res, n_dirs in (("c2", 32, 48, None), ("c3", 24, 40, 4)):
        cfg = configs.CONFIGS[name]
        cam = configs.camera(cfg, n, res)
        lighting = cfg["lighting"]
        if lighting is not None:
            lighting = type(lighting)(mode=lighting.mode, n_samples=n_dirs)
        g = smoke_sphere(n, device="cpu")
        ref = render.render_view(g, cam, cfg["render"], lighting=lighting,
                                 device="cpu")
        out = render.render_view(g.to(dev), cam, cfg["render"],
                                 lighting=lighting)
        err = max_err([o.cpu() for o in out], ref)
        tol = 1e-5 + cfg["render"].early_stop_eps
        log(f"[path] render_view {name} {n}^3 @ {res}^2 card vs cpu: "
            f"max abs err {err:.3e} (tol {tol:.1e})")
        check(err <= tol, f"render_view {name} card vs cpu")

    tau_planes = sigma.shape[0]
    tau_bytes = 2 * sigma.numel() * 4
    tau_bytes_ms = tau_bytes / HBM_BYTES_PER_S * 1e3
    tau_ops_ms = TAU_FLOPS_PER_VOXEL * sigma.numel() / F32_FLOP_PER_S * 1e3
    del sigma, tau_cases

    # 3. The main path at full size, through the entry points.
    ksweep.launches = 0
    klight.launches = 0
    frames = {}
    for name in ("c1", "c2", "headline", "c3"):
        cfg = configs.CONFIGS[name]
        run = cfg["render"]
        cam = configs.camera(cfg)
        grid = smoke_sphere(cfg["grid_n"])
        axis = dominant_axis(cam)
        n_frames = 5 if name == "c3" else 20
        bake_ms = bake_dev = None
        if cfg["lighting"] is not None:
            torch.cuda.synchronize()
            t0 = time.time()
            before = klight.launches
            prep = render.prepare_grid(grid, axes=(axis,),
                                       lighting=cfg["lighting"],
                                       precision=run.precision)
            torch.cuda.synchronize()
            bake_ms = (time.time() - t0) * 1e3
            check(klight.launches - before == cfg["lighting"].n_samples,
                  "light bake did not go through the tau kernel")
            bake_dev, bake_top = device_ms(lambda: render.prepare_grid(
                grid, axes=(axis,), lighting=cfg["lighting"],
                precision=run.precision), 1)
            log(f"[main] c3 light bake ({cfg['lighting'].n_samples} "
                f"directions, prepare_grid): {bake_ms:.2f} ms; device " + (
                    "time not measured" if bake_dev is None else
                    f"{bake_dev:.3f} ms; by kernel " + "; ".join(
                        f"{k} {v:.3f} ms" for k, v in bake_top)))
        else:
            prep = render.prepare_grid(grid, axes=(axis,),
                                       precision=run.precision)
        rgb, t = render.render_prepared(prep, cam, run)
        ms = cuda_ms(lambda: render.render_prepared(prep, cam, run),
                     n_frames, warmup=0)
        rgb, t = render.render_prepared(prep, cam, run)
        torch.cuda.synchronize()
        check(rgb.shape == (cam.res_y, cam.res_x, 3)
              and t.shape == (cam.res_y, cam.res_x), f"{name} shapes")
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(t).all()),
              f"{name} non-finite image")
        check(float(t.min()) >= 0.0 and float(t.max()) <= 1.0,
              f"{name} T outside [0, 1]")
        check(float(rgb.abs().max()) > 0.0, f"{name} black image")
        rays = cam.res_x * cam.res_y
        dev_ms, top = device_ms(
            lambda: render.render_prepared(prep, cam, run), n_frames)
        frames[name] = dict(ms_per_frame=ms, rays_per_s=rays / ms * 1e3,
                            device_ms_per_frame=dev_ms,
                            device_busy=(None if dev_ms is None
                                         else dev_ms / ms),
                            bake_ms=bake_ms, bake_device_ms=bake_dev)
        log(f"[main] {name} {cfg['grid_n']}^3 @ {cam.res_x}^2 "
            f"{run.precision} eps {run.early_stop_eps:g}: {ms:.4f} ms/frame, "
            f"{rays / ms * 1e3:.4g} rays/s, T in [{float(t.min()):.3g}, "
            f"{float(t.max()):.3g}], max rgb {float(rgb.max()):.3g}")
        log(f"[main] {name} device time per frame: " + (
            "not measured (the profiler saw no device activity)"
            if dev_ms is None else f"{dev_ms:.4f} ms, busy "
            f"{dev_ms / ms:.3f} of the frame; by kernel " + "; ".join(
                f"{k} {v:.4f} ms" for k, v in top)))
        del prep, grid, rgb, t
    launches = {"sweep_fwd": ksweep.launches, "tau_sweep": klight.launches}
    log(f"[main] launches on the main path: {launches}")
    check(launches["sweep_fwd"] > 0, "main path never launched sweep_fwd")
    check(launches["tau_sweep"] > 0, "main path never launched tau_sweep")

    # 4. Summary.
    head = sweep_ms["headline"]
    kernels = [
        {
            "name": "sweep_fwd", "route": "cuda",
            "source": "tpuvr_torch/csrc/sweep_fwd.cu",
            "replaces": "tpuvr/kernels/sweep.py:179",
            "also_replaces": "tpuvr/kernels/sweep.py:491",
            "launches": launches["sweep_fwd"],
            "max_abs_err": sweep_err,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": max(head["bytes_ms"], head["ops_ms"]),
            "bound_by": ("bytes" if head["bytes_ms"] >= head["ops_ms"]
                         else "operations"),
            "library_ms": head["library_ms"],
            "library_call": "grid_sample of one slice x S (yardstick)",
            "shape": "headline 256^3 @ 512^2, default, eps 1e-4",
            "by_config": sweep_ms,
        },
        {
            "name": "tau_sweep", "route": "cuda",
            "source": "tpuvr_torch/csrc/tau_sweep.cu",
            "replaces": "tpuvr/kernels/lighting.py:33",
            "launches": launches["tau_sweep"],
            "plane_launches_per_call": tau_planes - 1,
            "max_abs_err": tau_err,
            "ms": tau_ms,
            "plain_ms": tau_plain_ms,
            "bound_ms": max(tau_bytes_ms, tau_ops_ms),
            "bound_by": ("bytes" if tau_bytes_ms >= tau_ops_ms
                         else "operations"),
            "library_ms": None,
            "shape": "one direction at 256^3, highest",
        },
    ]
    log(json.dumps({"frames": frames}))
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"chip_smoke: done in {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
