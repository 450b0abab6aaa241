#!/usr/bin/env python3
"""Drive tpuvr_torch on one NVIDIA card and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. build the CUDA kernels from tpuvr_torch/csrc (into tpuvr_torch/_build),
     one nvcc per source, all at once;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (the backward sweep also against autograd of a
     per-ray-terminating plain forward at eps > 0; the sweep pair over the
     c4 minibatch, 8 views of one c4 group, also against the same kernels
     run view by view; the tau sweep and its adjoint (K2, K4) over c3's 16
     directions in one launch each way, also at c5's 512^2 planes and, for
     a plane too wide for their cluster route, through the plane loop),
     the row-block warp pair (K7, K8) at the c4 row plans
     against its plain versions and grid_sample (K8 also against itself over
     two calls; each timed with CUDA events in turns with its grid_sample
     call, by the profiler, and by the host's issue time), and the whole
     render path against device="cpu" on a small input; the 'persample'
     light volume (the exact oracle, plain PyTorch, no kernel) at 64^3
     against the CPU and the K2 bake, a 'persample'-lit render_view's image
     and grid gradient and the oracle's 16^3 gradient against the CPU;
  3. the render path at full size through the entry points (device=None):
     c1, c2 and the 256^3 @ 512^2 headline frame as frame loops, and c3 lit
     (16-direction light bake, then frames), timed with CUDA events;
  4. the training path: c4 at full width (256^3 from 64 views at 256^2,
     8 views a step) through fit_grid, as configured and in the fused
     layout-resident mode, each with the view-batched sweep (the default)
     and view by view (TPUVR_VIEW_BATCH=0); one batched step held against
     the same step through the plain versions and against the view-by-view
     step; the configured and fused runs again with the row-block warp
     (TPUVR_WARP=rows), a rows step against the gather step, and
     evaluate_psnr over the 64 views through render_views_grouped under
     rows against the gather render; then a lit fit_grid with
     differentiable shadows at 128^3. Before each main path the kernels'
     launch counts are set to 0, and they are read after it;
  5. the data-parallel path (dist): c4 at full width through
     fit_grid(mesh=data_mesh()) on 4 ranks started by
     tpuvr_torch.dist.launch.spawn, 3 steps under each gradient reduction
     (bucketed, chunked, the ring backward), one mesh step held against the
     single-process step, the ring backward (B11's port) against K6 in
     one call then one all-reduce, timed, render_view_dp's gradient at the
     headline frame ('default' and 'highest') against each rank's one-card
     render_view gradient, with its launches and collectives and ms per
     forward+backward, and the scaling table at the
     headline frame (render_view on each rank's card, render_view_dp over
     the 4 ranks, and the mesh row's efficiency). With 4 cards or more
     each rank takes a card and the ranks talk over NCCL; with fewer the 4
     ranks share card 0 over gloo (NCCL refuses two ranks on one card), so
     their times say nothing of several cards. Each rank resets and reads
     its own launch and collective counts around each run;
  6. the z-sharded grid (zshard) at 512^3 on 4 ranks, laid out as phase 5
     lays them out: the 1024^2 top-down frame on a (1, 4) mesh in each
     segment fold (all_gather, ring, retile) against the single-card
     render at eps 0 and 'highest', each followed by a forward+backward of
     sum(rgb^2) + sum(T) (and the retile's on the (2, 2) mesh) whose slab
     gradient is held against the single-card render_view gradient, zero
     outside the slab, with its launches and collectives, ms and device
     time; K1 and K3 at every rank's slab shape against their plain
     versions; and fit_grid from 2 top-down views at
     256^2 on a (2, 2) mesh, 3 steps in the retile branch and in a row
     band, each branch's first-step gradient held slab by slab against the
     single-card step; launches and collectives per frame and per fit on
     every rank, ms/frame, ms/step and peak memory per rank;
  7. the benchmark's judged core (bench): tpuvr_torch.bench.judged.run at
     the 256^3 @ 512^2 headline frame (the frame loop, fwd+bwd, the
     raw-grid and fused train steps, K3's pixel-gradient error against the
     f64 oracle beside the plain version's, the roofline fractions; the
     extended set under TPUVR_BENCH_FULL=1) printed as one "bench" JSON
     line, with the K1/K3 launches its loop lengths predict and no other
     kernel; slab-chunked early ray termination (ert_chunks 4 and 8) at
     the headline frame against one slab, the ERT bound and the plain
     versions, with the live slabs, its K1/K3 launches (ert_chunks a row
     chunk) and no host sync; the scaling table's one-card row (its mesh
     row is phase 5's); the c1 frame with
     mode='fixed_dt' against device="cpu" and against the plane sweep;
  8. c5 (configs/c5.py: 512^3 at 1024^2, lit by 16 sky directions;
     ROADMAP A3), shaped like tools/c5_train.py: the lit targets of 4
     orbit views; the lit frame through render_view at eps 0 and 1e-4, the
     whole 512^3 bake (one K2 launch, clusters of 16) and the first fit
     step's gradient against the plain versions on the card; fit_grid for
     4 steps (raw density from a faint fog, one view a step) with its
     losses, ms/step, device-busy share, host issue time, peak memory and
     launches by kernel; the lit viewer's times (tools/run_judged.py's c5
     command); then the fit on a 'data' mesh for 3 steps, its first step's
     gradient against the one-card step, and the scaling table at c5's
     frame (the one-card row on every rank, the mesh row through
     render_view_dp): 4 ranks one a card over NCCL with 4 cards or more,
     else 2 gloo ranks sharing card 0 (four ranks of 20-26 GiB do not fit
     in 80 GB);
  9. the outer shell (shell; ROADMAP A7): the TVOL codec at 256^3, native
     against numpy both ways, bit for bit, timed; hollow_shell(256)
     through render_view at the headline frame against device="cpu";
     render_with_geom against render_view on a c2 orbit view at
     oversample 2; the command line at full width through
     tpuvr_torch.cli.main (render c3 to a PNG decoded back with zlib,
     turntable c2 of 8 frames, fit c4 for 3 steps, bench c1 with a
     profiler trace, gradcheck against its CPU run), each with its wall
     time and launches; and tpuvr_torch.entry.dryrun_multichip(4) (4 ranks
     one a card over NCCL with 4 cards, else 4 gloo ranks sharing card 0)
     against its one-process step on the card;
 10. print one JSON line per kernel (time, bound, plain and library
     yardsticks), the cards nvidia-smi lists, the card's name and power
     limit from nvidia-smi, and last {"ok": true, "device": {...}}.
Without a card it exits non-zero before printing any result.

``--phase dist`` runs the build and phase 5 alone (for a machine with
four cards), ``--phase zshard`` the build and phase 6 alone; ``--phase warp`` runs the build and the row warp's kernel
checks and times (K7, K8 at c4's row plans) alone; ``--phase bwd`` runs
the build and the backward sweep's checks and times alone (K6 at the c4
minibatch, also on a rank's row tiles and at other slab heights, K3 at
the c4 view, c2 and the headline), with each stage's device time and a
SHA-256 digest of each gradient, for holding a redesign bit for bit
against its parent in one call. ``--phase fwd`` does the same for the
forward sweep (K1 at c1, c2, c3's geometry, the headline and a c4 view;
K5 at the c4 minibatch, also with softplus, at eps 1e-2 and on a rank's
row tiles): SHA-256 digests of rgb and T, interleaved CUDA-event times,
device times, bounds and per-tile window counts. ``--phase light`` does the
same for the light bake's tau sweep and its adjoint (K2, K4 at c3's 16
directions, c3's prepare_grid, the lit fit's first-step gradient), also in
a tree that has only the one-direction tau wrappers. ``--phase bench``
runs the build (K1, K3) and phase 7 alone, ``--phase c5`` the build (K1,
K2, K3, K9/K10) and phase 8 alone (on one card, or with four cards its mesh
over NCCL), ``--phase shell`` the build (K1-K4, K9/K10) and phase 9 alone.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpuvr_torch.bench.roofline import (
    F32_FLOP_PER_S,
    HBM_BYTES_PER_S,
    sweep_bwd_bound,
    sweep_fwd_bound,
    sweep_work,
)

TAU_FLOPS_PER_VOXEL = 20     # tent weights, 4 taps, relu/fma, row+column
# Row warp per pixel and channel, either way: 4 tap products and 3 sums, and
# the pixel's 4 tent weights shared over the channels.
WARP_FLOPS_PER_SAMPLE = 10
# Backward kernel against its plain version, as a share of max|grad|: f32
# sums in another order at 'highest' and 'high'; at 'default' one bf16
# rounding (2^-8) of a row-stage partial that the two orders may round to
# neighbouring bf16 values.
GRAD_TOL = {"highest": 1e-5, "high": 1e-5, "default": 4e-3}
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink 4, each direction
DIST_RANKS = 4
SCALING_MIN_WALL = 0.5  # seconds a timed loop of the dist scaling rows lasts
RING_CHUNKS = 4
# fit_grid's gradient reductions on a mesh (MeshConfig's fields).
# The z-sharded grid (ROADMAP A1): the render's and the fit's meshes
# (data, z), the grid edge, the fit's steps and its band's rays a view.
ZSHARD_RANKS = 4
ZSHARD_RENDER = (1, 4)
ZSHARD_FIT = (2, 2)
ZSHARD_GRID = 512
ZSHARD_STEPS = 3
ZSHARD_BAND_RAYS = 256 * 64
DIST_MODES = {"bucketed": dict(grad_buckets=4),
              "chunked": dict(bwd_chunks=RING_CHUNKS),
              "ring": dict(grad_ring=True, bwd_chunks=RING_CHUNKS)}
# c5 (ROADMAP A3): configs/c5.py's 512^3 grid lit at 1024^2, trained as
# tools/c5_train.py trains it (4 views, one a step, from a fog of density
# 0.01 and emission 0.5), then on a 'data' mesh: one rank a card over NCCL
# on a machine with C5_CARD_RANKS cards, else C5_SHARED_RANKS gloo ranks
# sharing card 0 (a rank holds the whole grid, its Adam state and the
# bake's 16 tau volumes, 20-26 GiB at its peak: four do not fit in 80 GB).
C5_VIEWS = 4
C5_STEPS = 4
C5_MESH_STEPS = 3
C5_CARD_RANKS = 4
C5_SHARED_RANKS = 2
# The 'persample' lighting checks (ROADMAP A6): the oracle's grid edge and
# the planes its CPU reference marches, the lit render's (grid, frame) edges
# and the gradient check's grid edge.
PERSAMPLE_N = 64
PERSAMPLE_CPU_PLANES = (0, 21, 42, 63)
PERSAMPLE_RENDER = (32, 64)
PERSAMPLE_GRAD_N = 16


def log(msg):
    print(msg, flush=True)


def ptxas_report(text):
    """One line per kernel instantiation from nvcc's ``-Xptxas -v`` output:
    its name (template arguments as numbers), spills and registers."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          m.group(1))
            name = m.group(1)[:48]
            if k:
                args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {spill}; {line.split(':', 1)[-1].strip()}")
    return out


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


def interleaved_ms(fns, reps, rounds=5):
    """{name: median over ``rounds`` of cuda_ms(fn, reps)}, the functions
    taken in turn in every round."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, reps))
    return {name: float(np.median(t)) for name, t in times.items()}


def device_per_name(averages, reps):
    """{kernel name: device ms per call} from a profile's ``key_averages()``
    over ``reps`` calls: the device-side kernel and memcpy events. The host
    ops that launched them report the same time and are skipped, and so
    are user annotations (``record_function`` ranges such as the port's
    ``tpuvr.*`` spans), whose device range covers the kernels inside it."""
    from torch.autograd import DeviceType

    per = {}
    for e in averages:
        t = e.self_device_time_total
        if (e.device_type != DeviceType.CPU and t > 0
                and not getattr(e, "is_user_annotation", False)):
            name = kernel_name(e.key)
            per[name] = per.get(name, 0.0) + t / 1e3 / reps
    return per


def device_ms(fn, reps, n_top=3):
    """Device time per call from torch.profiler (:func:`device_per_name`
    over ``reps`` calls), the ``n_top`` largest entries by name, and the
    top-level ATen ops the host dispatched per call; (None, [], ops) if the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    per = device_per_name(prof.key_averages(), reps)
    if not per:
        return None, [], ops / reps
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n_top]
    return sum(per.values()), top, ops / reps


def host_us(fn, reps):
    """Mean host microseconds to issue one call (no synchronisation between
    calls; the card's queue absorbs them), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def per_ray_sweep_fwd(grid_sc, coeffs, enables, dt_map, *, reverse=False,
                      sigma_scale=1.0, early_stop_eps=0.0,
                      precision="highest", softplus=False):
    """Plain forward sweep that stops each ray at its own T < eps, as the
    CUDA kernels do (the twin stops all rays at the global max): the
    function whose autograd gradient the backward kernel is held against
    at eps > 0."""
    from tpuvr_torch.kernels.sweep_torch import (
        _interp_matrices,
        resample,
        softplus_slice,
    )

    s, _, n_y, n_x = grid_sc.shape
    n_v, n_u = dt_map.shape
    ay, by, ax, bx = coeffs
    rgb = grid_sc.new_zeros((3, n_v, n_u))
    trans = grid_sc.new_ones((n_v, n_u))
    for k in range(s):
        sl = grid_sc[s - 1 - k if reverse else k]
        if softplus:
            sl = softplus_slice(sl)
        mat_a, mat_b = _interp_matrices(ay[k], by[k], ax[k], bx[k], n_v, n_y,
                                        n_x, n_u, grid_sc.dtype)
        smp = resample(sl, mat_a, mat_b, precision)
        att = torch.exp(-((sigma_scale * torch.clamp_min(smp[0], 0.0))
                          * dt_map))
        go = (enables[k] > 0) & (trans >= early_stop_eps)
        att = torch.where(go, att, torch.ones_like(att))
        rgb = rgb + (trans * (1.0 - att))[None] * smp[1:4]
        trans = trans * att
    return rgb, trans


def reset_counts():
    from tpuvr_torch.dist import init
    from tpuvr_torch.kernels import (
        light_apply,
        lighting,
        ring_bwd,
        sweep,
        sweep_bwd,
        warp,
    )
    from tpuvr_torch.ops import lighting as olight

    light_apply.launches.clear()
    olight.shadow.clear()
    sweep.launches.clear()
    sweep_bwd.launches.clear()
    warp.launches.clear()
    for counts in (lighting.launches, lighting.directions,
                   lighting.adj_launches, lighting.adj_directions):
        counts.clear()
    ring_bwd.launches = 0
    init.collectives.clear()


def read_counts():
    """Launches since reset_counts, by kernel row, read from
    ``tpuvr_torch.utils.trace.launch_counts``: the sweep kernels' counts
    split into one view ("sweep_fwd", "sweep_bwd") and view batches
    ("sweep_fwd_views", "sweep_bwd_views"), the tau sweep's and its
    adjoint's kernel launches ("tau_sweep", "tau_adj": cluster launches
    plus the plane loop's plane launches) and the directions they swept
    ("tau_sweep_dirs", "tau_adj_dirs"), with the plane loop's share
    ("tau_sweep_plane_loop", "tau_adj_plane_loop"), the row warp's
    ("warp_rows_fwd", "warp_rows_bwd"), the ring backward's
    ("sweep_bwd_ring"), the lit grid's assembly: K9, K10, K11 and K12
    launches ("light_apply_fwd", "light_apply_bwd",
    "light_apply_shadow_bwd", "light_apply_mask") and the calls that took
    the ATen passes instead ("light_apply_fallback"), and the differentiable
    light bakes and their backward passes ("light_shadow",
    "light_shadow_adjoint"; calls, not launches)."""
    from tpuvr_torch.utils.trace import launch_counts

    c = launch_counts()

    def total(prefix):
        return sum(n for k, n in c.items() if k.startswith(prefix))

    out = {k: c[k] for k in ("sweep_fwd", "sweep_bwd", "tau_sweep_dirs",
                             "tau_adj_dirs", "sweep_fwd_views",
                             "sweep_bwd_views", "warp_rows_fwd",
                             "warp_rows_bwd", "sweep_bwd_ring",
                             "light_apply_fwd", "light_apply_bwd",
                             "light_apply_shadow_bwd", "light_apply_mask",
                             "light_apply_fallback", "light_shadow",
                             "light_shadow_adjoint")}
    out.update(tau_sweep=total("tau_sweep_c"), tau_adj=total("tau_adj_c"),
               tau_sweep_plane_loop=c["tau_sweep_c0"],
               tau_adj_plane_loop=c["tau_adj_c0"])
    return out


def warp_mode(mode):
    """The JAX package's pixel-warp switch: "rows" sets TPUVR_WARP=rows,
    anything else clears it (the port's 4-tap gather)."""
    if mode == "rows":
        os.environ["TPUVR_WARP"] = "rows"
    else:
        os.environ.pop("TPUVR_WARP", None)


def c4_row_groups():
    """c4's view groups under TPUVR_WARP=rows (host geometry); fails unless
    every one of the four got a row plan."""
    from tpuvr_torch import configs
    from tpuvr_torch.ops.warp import RowWarpPlan
    from tpuvr_torch.train import fit

    c4 = configs.CONFIGS["c4"]
    n = c4["grid_n"]
    warp_mode("rows")
    try:
        groups = fit.group_views(configs.cameras(c4), (n, n, n, 4))
    finally:
        warp_mode("gather")
    check(len(groups) == 4 and all(isinstance(g[3], RowWarpPlan)
                                   for g in groups.values()),
          "not every c4 group got a row plan")
    return groups


def backward_kernels(dev):
    """K3 (backward sweep) against sweep_bwd_torch and K1 with the fused
    softplus against its twin, on the card at the main paths' shapes.
    Returns the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.kernels.sweep_torch import (
        sweep_bwd_torch,
        sweep_fwd_torch,
    )
    from tpuvr_torch.ops import render, vjp
    from tpuvr_torch.ref.camera import dominant_axis

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(grid, cam, cfg):
        prep = render.prepare_grid(grid, axes=(dominant_axis(cam),),
                                   device=dev)
        plan, _, args = render.sweep_inputs(prep, cam, cfg, dev)
        return plan, args

    def with_raw_density(args):
        """The same slab with raw density parameters of both signs (the
        fused-softplus layout)."""
        raw = args[0].clone()
        raw[:, 0] = randn(*raw[:, 0].shape) * 2.0 - 1.0
        return (raw, *args[1:])

    def hold(label, args, kw, tol):
        rgb, t = sweep_fwd_torch(*args, **kw)
        d_rgb, d_t = randn(3, *t.shape), randn(*t.shape)
        k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
        p = sweep_bwd_torch(*args, rgb, t, d_rgb, d_t, **kw)
        torch.cuda.synchronize()
        scale = float(p.abs().max())
        err = float((k - p).abs().max())
        log(f"[kernel] sweep_bwd {label}: max abs err {err:.3e} = "
            f"{err / scale:.3e} of max|grad| {scale:.3e} (tol {tol:g})")
        check(scale > 0 and err <= tol * scale
              and bool(torch.isfinite(k).all()), f"sweep_bwd {label}")
        return err, (rgb, t, d_rgb, d_t)

    c4, c2 = configs.CONFIGS["c4"], configs.CONFIGS["c2"]
    grid256 = smoke_sphere(c4["grid_n"], device=dev)
    cases = {
        "c4": (grid256, configs.cameras(c4)[0], c4["render"]),
        "headline": (grid256, configs.camera(configs.CONFIGS["headline"]),
                     configs.CONFIGS["headline"]["render"]),
        "c2": (smoke_sphere(c2["grid_n"], device=dev), configs.camera(c2),
               c2["render"]),
    }
    out = {"by_config": {}}
    bwd_err = 0.0
    for name, (grid, cam, run) in cases.items():
        plan, args = inputs(grid, cam, run)
        for softplus in (False, True):
            a = with_raw_density(args) if softplus else args
            kw = dict(reverse=plan.reverse, sigma_scale=run.sigma_scale,
                      early_stop_eps=0.0, precision=run.precision,
                      softplus=softplus)
            err, _ = hold(f"{name} S={a[0].shape[0]} V,U="
                          f"{tuple(a[3].shape)} {run.precision} "
                          f"softplus={softplus}", a, kw,
                          GRAD_TOL[run.precision])
            if run.precision == "highest":
                bwd_err = max(bwd_err, err)
        kw = dict(reverse=plan.reverse, sigma_scale=run.sigma_scale,
                  early_stop_eps=0.0, precision=run.precision)
        rgb, t = ksweep.sweep_fwd(*args, **kw)
        d_rgb, d_t = randn(3, *t.shape), randn(*t.shape)
        bytes_ms, ops_ms = sweep_bwd_bound(args)
        ray_slices, in_support = sweep_work(args)[3:]
        out["by_config"][name] = dict(
            ms=cuda_ms(lambda: kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t,
                                              **kw), 5),
            bytes_ms=bytes_ms, ops_ms=ops_ms, ray_slices=ray_slices,
            in_support=in_support,
            slab=kbwd.slab_slices(args[0].shape[0], *t.shape))
        if name == "c4":
            out["plain_ms"] = cuda_ms(lambda: sweep_bwd_torch(
                *args, rgb, t, d_rgb, d_t, **kw), 2)
            # Two slabs threading the (trans, q) carry against one call.
            for softplus in (False, True):
                a = with_raw_density(args) if softplus else args
                kwc = dict(kw, early_stop_eps=0.0, softplus=softplus)
                r2, t2 = ksweep.sweep_fwd(*a, **kwc)
                one = kbwd.sweep_bwd(*a, r2, t2, d_rgb, d_t, **kwc)
                two = vjp._chunked_bwd(kbwd.sweep_bwd, 2, *a, r2, t2, d_rgb,
                                       d_t, kwc)
                scale = float(one.abs().max())
                err = float((two - one).abs().max())
                log(f"[kernel] sweep_bwd c4 two slabs vs one call "
                    f"softplus={softplus}: {err / scale:.3e} of max|grad| "
                    "(tol 1e-5)")
                check(err <= 1e-5 * scale, "sweep_bwd carry")
            # K1's fused softplus against its twin.
            raw = with_raw_density(args)
            kws = dict(kw, softplus=True)
            k = ksweep.sweep_fwd(*raw, **kws)
            p = sweep_fwd_torch(*raw, **kws)
            out["softplus_fwd_err"] = max_err(k, p)
            out["softplus_fwd_ms"] = cuda_ms(
                lambda: ksweep.sweep_fwd(*raw, **kws), 10)
            log(f"[kernel] sweep_fwd softplus c4: max abs err "
                f"{out['softplus_fwd_err']:.3e} (tol 1e-5), "
                f"{out['softplus_fwd_ms']:.4f} ms")
            check(out["softplus_fwd_err"] <= 1e-5, "sweep_fwd softplus")
            del raw, one, two
        log(f"[kernel] sweep_bwd {name} ({run.precision}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in out["by_config"][name].items()))
    out["max_abs_err"] = bwd_err

    # eps > 0 on a scene whose rays terminate: the kernels against autograd
    # of the per-ray-terminating plain forward.
    grid, cam, run = cases["c2"]
    plan, args = inputs(grid + torch.tensor([0.05, 0.0, 0.0, 0.0],
                                            device=dev), cam, run)
    for softplus in (False, True):
        a = with_raw_density(args) if softplus else args
        kw = dict(reverse=plan.reverse, sigma_scale=1.0, early_stop_eps=1e-2,
                  precision="highest", softplus=softplus)
        rgb, t = ksweep.sweep_fwd(*a, **kw)
        n_term = int((t < 1e-2).sum())
        g = a[0].clone().requires_grad_(True)
        ref_rgb, ref_t = per_ray_sweep_fwd(g, *a[1:], **kw)
        d_rgb, d_t = randn(3, *t.shape), randn(*t.shape)
        ((ref_rgb * d_rgb).sum() + (ref_t * d_t).sum()).backward()
        k = kbwd.sweep_bwd(*a, rgb, t, d_rgb, d_t, **kw)
        fwd_err = max_err((rgb, t), (ref_rgb.detach(), ref_t.detach()))
        scale = float(g.grad.abs().max())
        err = float((k - g.grad).abs().max())
        log(f"[kernel] sweep_bwd c2 eps 1e-2 softplus={softplus}, "
            f"{n_term} of {t.numel()} rays terminated: forward max abs err "
            f"{fwd_err:.3e} (tol 1e-5), gradient {err / scale:.3e} of "
            "max|grad| against per-ray autograd (tol 1e-5)")
        check(n_term > 0 and fwd_err <= 1e-5 and err <= 1e-5 * scale,
              f"sweep_bwd eps>0 softplus={softplus}")
    del cases, grid, grid256, args, a, g
    return out


def c4_minibatch(dev):
    """The c4 training step's sweep inputs: the first ``views_per_batch``
    views of the first c4 view group, from the group's own cameras; the
    grid (smoke sphere, 256^3) in the group's sweep layout, the views'
    (views, S) coefficients and enables, their dt planes stacked along V.
    Returns (reverse, views, args)."""
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import render
    from tpuvr_torch.train import fit

    c4 = configs.CONFIGS["c4"]
    n = c4["grid_n"]
    views = c4["train"].views_per_batch
    groups = fit.group_views(configs.cameras(c4), (n, n, n, 4))
    key = sorted(groups)[0]
    _, stacked, _, _ = groups[key]
    grid_sc = render.grid_to_sweep_layout(smoke_sphere(n, device=dev),
                                          key[0]).contiguous()
    c = stacked["coeffs"][:views].to(dev)
    en = (render.slice_enables(grid_sc, key[1],
                               c4["render"].use_occupancy)[None]
          * stacked["valid"][:views].to(dev)).contiguous()
    dt = stacked["dt"][:views].to(dev)
    return key[1], views, (grid_sc, tuple(c.unbind(1)), en,
                           dt.flatten(0, 1).contiguous())


def view_batch_kernels(dev):
    """The sweep kernels over a view batch (K5: forward, K6: backward) at
    the c4 minibatch (8 views of the first c4 group at 256^2, 256^3):
    against their plain versions at 'highest' and 'default' (K6 also
    'high'), with and without softplus; K5 bit for bit against the same
    kernel run view by view (K1, views=1), at eps 0 and at eps > 0 where
    rays terminate; K6 against the per-view gradients (K3) summed in view
    order, and two slabs against one call. Times K5 against 8 x K1 and K6
    against 8 x K3 on the same minibatch. Returns the numbers for the
    summary."""
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.kernels.sweep_torch import (
        sweep_bwd_views_torch,
        sweep_fwd_views_torch,
    )
    from tpuvr_torch.ops import vjp

    reverse, views, args = c4_minibatch(dev)
    v_pv = args[3].shape[0] // views
    gen = torch.Generator(device=dev).manual_seed(2)
    d_rgb = torch.randn((3, *args[3].shape), generator=gen, device=dev)
    d_t = torch.randn(args[3].shape, generator=gen, device=dev)
    raw = args[0].clone()
    raw[:, 0] = torch.randn(raw[:, 0].shape, generator=gen,
                            device=dev) * 2.0 - 1.0
    raw_args = (raw, *args[1:])

    def one_view(a, w):
        grid_sc, coeffs, en, dt = a
        return (grid_sc, tuple(c[w] for c in coeffs), en[w],
                dt[w * v_pv:(w + 1) * v_pv])

    def k1_loop(a, kw):
        outs = [ksweep.sweep_fwd(*one_view(a, w), **kw) for w in range(views)]
        return (torch.cat([r for r, _ in outs], dim=1),
                torch.cat([t for _, t in outs], dim=0))

    def k3_sum(a, rgb, t, kw):
        total = None
        for w in range(views):
            sl = slice(w * v_pv, (w + 1) * v_pv)
            g = kbwd.sweep_bwd(*one_view(a, w), rgb[:, sl], t[sl],
                               d_rgb[:, sl], d_t[sl], **kw)
            total = g if total is None else total + g
        return total

    out = {"views": views, "shape": f"c4 minibatch: {views} views at "
           f"{v_pv}x{args[3].shape[1]}, grid {tuple(args[0].shape)}"}
    fwd_err = bit_err = 0.0
    for prec in ("highest", "default"):
        for softplus in (False, True):
            a = raw_args if softplus else args
            kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
                      precision=prec, softplus=softplus)
            k = ksweep.sweep_fwd(*a, views=views, **kw)
            p = sweep_fwd_views_torch(*a, views=views, **kw)
            loop = k1_loop(a, kw)
            torch.cuda.synchronize()
            err, bit = max_err(k, p), max_err(k, loop)
            log(f"[kernel] sweep_fwd_views c4 {prec} softplus={softplus}: "
                f"max abs err {err:.3e} against plain (tol 1e-5), {bit:.3e} "
                "against K1 view by view (tol 0)")
            check(err <= 1e-5 and bit == 0.0
                  and all(bool(torch.isfinite(x).all()) for x in k),
                  f"sweep_fwd_views {prec} softplus={softplus}")
            bit_err = max(bit_err, bit)
            if prec == "highest" and not softplus:
                fwd_err = err
    out["max_abs_err"] = fwd_err

    # eps > 0 on a denser grid, where rays terminate: K5 and K6 stop each
    # ray where K1 and K3 do.
    dense = (args[0] + torch.tensor([0.05, 0.0, 0.0, 0.0], device=dev)[
        None, :, None, None], *args[1:])
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=1e-2,
              precision="highest")
    rgb, t = ksweep.sweep_fwd(*dense, views=views, **kw)
    n_term = int((t < 1e-2).sum())
    bit = max_err((rgb, t), k1_loop(dense, kw))
    g6 = kbwd.sweep_bwd(*dense, rgb, t, d_rgb, d_t, views=views, **kw)
    g3 = k3_sum(dense, rgb, t, kw)
    gbit = float((g6 - g3).abs().max())
    log(f"[kernel] sweep_fwd_views/sweep_bwd_views c4 eps 1e-2, {n_term} of "
        f"{t.numel()} rays terminated: forward {bit:.3e} and gradient "
        f"{gbit:.3e} against K1/K3 view by view (tol 0)")
    check(n_term > 0 and bit == 0.0 and gbit == 0.0, "view batch eps>0")
    bit_err = max(bit_err, bit)
    out["bit_err_vs_k1"] = bit_err
    del dense, g6, g3

    bwd_err = 0.0
    for prec, softplus in (("highest", False), ("high", False),
                           ("default", False), ("highest", True)):
        a = raw_args if softplus else args
        kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
                  precision=prec, softplus=softplus)
        rgb, t = ksweep.sweep_fwd(*a, views=views, **kw)
        k = kbwd.sweep_bwd(*a, rgb, t, d_rgb, d_t, views=views, **kw)
        p = sweep_bwd_views_torch(*a, rgb, t, d_rgb, d_t, views=views, **kw)
        torch.cuda.synchronize()
        scale = float(p.abs().max())
        err = float((k - p).abs().max())
        line = (f"[kernel] sweep_bwd_views c4 {prec} softplus={softplus}: "
                f"{err / scale:.3e} of max|grad| {scale:.3e} against plain "
                f"(tol {GRAD_TOL[prec]:g})")
        ok = scale > 0 and err <= GRAD_TOL[prec] * scale and bool(
            torch.isfinite(k).all())
        if prec == "highest":
            loop_err = float((k - k3_sum(a, rgb, t, kw)).abs().max()) / scale
            line += f", {loop_err:.3e} against K3 summed (tol 1e-6)"
            ok = ok and loop_err <= 1e-6
            two = vjp._chunked_bwd(kbwd.sweep_bwd, 2, *a, rgb, t, d_rgb, d_t,
                                   dict(kw, views=views))
            slab_err = float((two - k).abs().max()) / scale
            line += f", two slabs vs one call {slab_err:.3e} (tol 1e-5)"
            ok = ok and slab_err <= 1e-5
            if not softplus:
                bwd_err = err
                out["k3_sum_err_of_max"] = loop_err
        log(line)
        check(ok, f"sweep_bwd_views {prec} softplus={softplus}")
    out["bwd_max_abs_err"] = bwd_err

    # Times at the configured c4 step's settings ('highest', eps 0).
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest")
    rgb, t = ksweep.sweep_fwd(*args, views=views, **kw)
    out["slab"] = kbwd.slab_slices(args[0].shape[0], *t.shape)
    out["fwd_ms"] = cuda_ms(lambda: ksweep.sweep_fwd(*args, views=views,
                                                     **kw), 10)
    out["fwd_loop_ms"] = cuda_ms(lambda: k1_loop(args, kw), 5)
    out["fwd_plain_ms"] = cuda_ms(lambda: sweep_fwd_views_torch(
        *args, views=views, **kw), 2)
    out["bwd_ms"] = cuda_ms(lambda: kbwd.sweep_bwd(
        *args, rgb, t, d_rgb, d_t, views=views, **kw), 5)
    out["bwd_loop_ms"] = cuda_ms(lambda: k3_sum(args, rgb, t, kw), 3)
    out["bwd_plain_ms"] = cuda_ms(lambda: sweep_bwd_views_torch(
        *args, rgb, t, d_rgb, d_t, views=views, **kw), 1)
    out["fwd_bytes_ms"], out["fwd_ops_ms"] = sweep_fwd_bound(args)
    out["k1_view_bytes_ms"], out["k1_view_ops_ms"] = sweep_fwd_bound(
        one_view(args, 0))
    out["bwd_bytes_ms"], out["bwd_ops_ms"] = sweep_bwd_bound(args)
    out["ray_slices"], out["in_support"] = sweep_work(args)[3:]
    log("[kernel] view batch c4 (highest): " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in out.items()))
    return out


def kernel_name(key):
    """The function name of a profiler key (a demangled CUDA kernel
    signature), or the key's first 48 characters (a memcpy)."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", key)
    return m.group(1) if m else key[:48]


def digest(t):
    """SHA-256 of a tensor's float32 bytes after ``+ 0.0``, so that the
    sign of a zero does not count."""
    return hashlib.sha256((t + 0.0).float().cpu().numpy().tobytes()
                          ).hexdigest()


def bwd_phase(dev):
    """The backward sweep alone (K6 over a view batch, K3 over one view),
    for redesigning it: checks, SHA-256 digests of the gradients (for
    holding a change bit for bit against its parent in one call), CUDA
    event times, the profiler's device time split by CUDA kernel (stage by
    stage) and the slab height, at the c4 minibatch (also on one rank's
    row tiles, a quarter of each view's rows at row0 = 0, 64, 128, 192,
    and at other slab heights), at the c4 view, c2 and the headline.
    Returns the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.kernels.sweep_torch import sweep_bwd_views_torch
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis

    reverse, views, args = c4_minibatch(dev)
    s, v_pv = args[0].shape[0], args[3].shape[0] // views
    gen = torch.Generator(device=dev).manual_seed(2)
    d_rgb = torch.randn((3, *args[3].shape), generator=gen, device=dev)
    d_t = torch.randn(args[3].shape, generator=gen, device=dev)
    raw = args[0].clone()
    raw[:, 0] = torch.randn(raw[:, 0].shape, generator=gen,
                            device=dev) * 2.0 - 1.0
    dense = args[0] + torch.tensor([0.05, 0.0, 0.0, 0.0], device=dev)[
        None, :, None, None]
    out = {"shape": f"c4 minibatch: {views} views at {v_pv}x"
           f"{args[3].shape[1]}, grid {tuple(args[0].shape)}",
           "digests": {}, "k6": {}, "k3": {}, "tiles": {}, "slabs": {}}

    def one_view(a, w):
        grid_sc, coeffs, en, dt = a
        return (grid_sc, tuple(c[w] for c in coeffs), en[w],
                dt[w * v_pv:(w + 1) * v_pv])

    def k3_sum(a, rgb, t, kw):
        total = None
        for w in range(views):
            sl = slice(w * v_pv, (w + 1) * v_pv)
            g = kbwd.sweep_bwd(*one_view(a, w), rgb[:, sl], t[sl],
                               d_rgb[:, sl], d_t[sl], **kw)
            total = g if total is None else total + g
        return total

    def timed(label, call, reps=10):
        ms = cuda_ms(call, reps)
        dev_ms, top, _ = device_ms(call, 5, n_top=8)
        log(f"[bwd] {label}: {ms:.4f} ms (events); device " + (
            "not measured" if dev_ms is None else "; ".join(
                f"{k} {v:.4f} ms" for k, v in top)))
        return {"ms": ms, "device_ms": dev_ms, "by_kernel": dict(top)}

    # K6 at the c4 minibatch: each tier, softplus, eps 1e-2 on a denser
    # grid where rays terminate.
    for label, prec, softplus, eps in (
            ("highest", "highest", False, 0.0), ("high", "high", False, 0.0),
            ("default", "default", False, 0.0),
            ("highest_softplus", "highest", True, 0.0),
            ("highest_eps1e-2", "highest", False, 1e-2)):
        a = ((raw if softplus else dense if eps else args[0]), *args[1:])
        kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=eps,
                  precision=prec, softplus=softplus)
        rgb, t = ksweep.sweep_fwd(*a, views=views, **kw)
        k = kbwd.sweep_bwd(*a, rgb, t, d_rgb, d_t, views=views, **kw)
        again = kbwd.sweep_bwd(*a, rgb, t, d_rgb, d_t, views=views, **kw)
        loop = k3_sum(a, rgb, t, kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(k, again))
        line = f"[bwd] K6 c4 {label}: two calls bit-identical {same}"
        if softplus:
            # K6 multiplies the views' density sum by sigmoid(raw) once, K3
            # each view's: the two differ by that rounding.
            vs_k3 = float((k - loop).abs().max()) <= 1e-6 * float(
                k.abs().max())
            line += f", within 1e-6 of max|grad| of K3 summed {vs_k3}"
        else:
            vs_k3 = bool(torch.equal(k, loop))
            line += f", equal to K3 summed in view order {vs_k3}"
        ok = same and vs_k3 and bool(torch.isfinite(k).all())
        if not eps:
            p = sweep_bwd_views_torch(*a, rgb, t, d_rgb, d_t, views=views,
                                      **kw)
            scale = float(p.abs().max())
            err = float((k - p).abs().max()) / scale
            line += (f", {err:.3e} of max|grad| {scale:.3e} against plain "
                     f"(tol {GRAD_TOL[prec]:g})")
            ok = ok and scale > 0 and err <= GRAD_TOL[prec]
            del p
        out["digests"][f"k6_c4_{label}"] = digest(k)
        log(line)
        check(ok, f"K6 c4 {label}")
        del k, again, loop

    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest")
    rgb, t = ksweep.sweep_fwd(*args, views=views, **kw)
    full = timed("K6 c4 minibatch (highest, eps 0)", lambda: kbwd.sweep_bwd(
        *args, rgb, t, d_rgb, d_t, views=views, **kw))
    full["slab"] = kbwd.slab_slices(s, *t.shape)
    out["k6"] = full

    # One rank's row tile: a quarter of each view's rows.
    n_tiles = 4
    v_l = v_pv // n_tiles
    for r in range(n_tiles):
        def rows(x, r=r):
            return x.unflatten(-2, (views, v_pv))[
                ..., r * v_l:(r + 1) * v_l, :].flatten(-3, -2).contiguous()

        tile = (args[0], args[1], args[2], rows(args[3]))
        k_rgb, k_t = ksweep.sweep_fwd(*tile, views=views, row0=r * v_l, **kw)
        tr, tt = rows(d_rgb), rows(d_t)

        def call(tile=tile, k_rgb=k_rgb, k_t=k_t, tr=tr, tt=tt, r=r):
            return kbwd.sweep_bwd(*tile, k_rgb, k_t, tr, tt, views=views,
                                  row0=r * v_l, **kw)

        g = call()
        torch.cuda.synchronize()
        check(bool(torch.equal(g, call())) and bool(torch.isfinite(g).all()),
              f"K6 row tile {r}")
        out["digests"][f"k6_c4_rows{r * v_l}"] = digest(g)
        res = timed(f"K6 c4 row tile row0={r * v_l} ({v_l} of {v_pv} rows)",
                    call)
        res["of_full"] = res["ms"] / full["ms"]
        out["tiles"][f"row0_{r * v_l}"] = res
        del g
    out["tile_of_full_max"] = max(x["of_full"] for x in out["tiles"].values())

    # Slab heights other than the wrapper's.
    slab_fn = kbwd.slab_slices
    try:
        for height in (2, 4, 8, 16, 32, 64):
            kbwd.slab_slices = lambda s_, n_v, n_u, h=height: min(s_, h)
            out["slabs"][height] = timed(
                f"K6 c4 minibatch at slab height {height}",
                lambda: kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t,
                                       views=views, **kw), 5)
    finally:
        kbwd.slab_slices = slab_fn
    del raw, dense, rgb, t

    # K3 at backward_kernels' shapes, its render configs' settings.
    c4, c2 = configs.CONFIGS["c4"], configs.CONFIGS["c2"]
    grid256 = smoke_sphere(c4["grid_n"], device=dev)
    cases = {
        "c4_view": (grid256, configs.cameras(c4)[0], c4["render"]),
        "c2": (smoke_sphere(c2["grid_n"], device=dev), configs.camera(c2),
               c2["render"]),
        "headline": (grid256, configs.camera(configs.CONFIGS["headline"]),
                     configs.CONFIGS["headline"]["render"]),
    }
    for name, (grid, cam, run) in cases.items():
        prep = render.prepare_grid(grid, axes=(dominant_axis(cam),),
                                   device=dev)
        plan, _, a = render.sweep_inputs(prep, cam, run, dev)
        gk = torch.Generator(device=dev).manual_seed(4)
        kw3 = dict(reverse=plan.reverse, sigma_scale=run.sigma_scale,
                   early_stop_eps=0.0, precision=run.precision)
        r3, t3 = ksweep.sweep_fwd(*a, **kw3)
        dr = torch.randn((3, *t3.shape), generator=gk, device=dev)
        dtt = torch.randn(t3.shape, generator=gk, device=dev)

        def call(a=a, r3=r3, t3=t3, dr=dr, dtt=dtt, kw3=kw3):
            return kbwd.sweep_bwd(*a, r3, t3, dr, dtt, **kw3)

        g = call()
        torch.cuda.synchronize()
        check(bool(torch.equal(g, call())) and bool(torch.isfinite(g).all()),
              f"K3 {name}")
        out["digests"][f"k3_{name}_{run.precision}"] = digest(g)
        res = timed(f"K3 {name} S={a[0].shape[0]} V,U={tuple(t3.shape)} "
                    f"{run.precision}", call)
        res["slab"] = kbwd.slab_slices(a[0].shape[0], *t3.shape)
        out["k3"][name] = res
        del prep, a, g
    for key, value in sorted(out["digests"].items()):
        log(f"[bwd] digest {key} {value}")
    return out


def fwd_phase(dev):
    """The forward sweep alone (K1 over one view, K5 over a view batch),
    for redesigning it: SHA-256 digests of rgb and T (for holding a change
    bit for bit against its parent in one call), CUDA-event times taken in
    interleaved rounds, the profiler's device time, the bound, and the
    geometry counts and regime shares of ``kernels.sweep.window_stats``
    where the tree has it. K1 at c1, c2, c3's orbit geometry (unlit), the
    headline and one c4 view, at each config's settings (timed), at every
    tier with eps 0, at eps 1e-2 and with softplus; K5 at the c4 minibatch
    at every tier, with softplus, at eps 1e-2 (on a denser grid, where
    rays terminate) and on a rank's quarter of the rows (row0 = 0, 64,
    128, 192). Launches only through ``kernels.sweep.sweep_fwd``. Returns
    the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels.sweep_torch import (
        sweep_fwd_torch,
        sweep_fwd_views_torch,
    )
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis

    stats = getattr(ksweep, "window_stats", None)
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {"digests": {}, "cases": {}, "geometry": {}}
    timed = {}

    def raw_density(args):
        raw = args[0].clone()
        raw[:, 0] = torch.randn(raw[:, 0].shape, generator=gen,
                                device=dev) * 2.0 - 1.0
        return (raw, *args[1:])

    def denser(args):
        return (args[0] + torch.tensor([0.05, 0.0, 0.0, 0.0], device=dev)[
            None, :, None, None], *args[1:])

    def geometry(label, args, views, row0=0):
        _, _, _, samples, support = sweep_work(args, row0)
        geo = {"ray_slices": samples, "in_support": support}
        if stats is not None:
            grid_sc, coeffs, en, dt = args
            geo.update(stats(coeffs, en, grid_sc.shape[2], grid_sc.shape[3],
                             dt.shape[0] // views, dt.shape[1], row0))
        out["geometry"][label] = geo
        log(f"[fwd] geometry {label}: " + json.dumps(geo))

    def run(label, args, kw, plain=None, tol=0.0, time_it=False):
        call = (lambda: ksweep.sweep_fwd(*args, **kw))
        rgb, t = call()
        again = call()
        torch.cuda.synchronize()
        same = bool(torch.equal(rgb, again[0]) and torch.equal(t, again[1]))
        ok = same and all(bool(torch.isfinite(x).all()) for x in (rgb, t))
        line = f"[fwd] {label}: two calls bit-identical {same}"
        if plain is not None:
            err = max_err((rgb, t), plain(*args, **kw))
            line += f", max abs err {err:.3e} against plain (tol {tol:.1e})"
            ok = ok and err <= tol
        out["digests"][label] = [digest(rgb), digest(t)]
        log(line)
        check(ok, f"sweep_fwd {label}")
        if time_it:
            timed[label] = (call, args, kw.get("row0", 0))
        del rgb, t, again

    # K1 at the render configs' geometry and at one c4 view.
    n_big = configs.CONFIGS["headline"]["grid_n"]
    grid256 = smoke_sphere(n_big, device=dev)
    for name in ("c1", "c2", "c3", "headline"):
        cfg = configs.CONFIGS[name]
        run_cfg = cfg["render"]
        grid = (grid256 if cfg["grid_n"] == n_big
                else smoke_sphere(cfg["grid_n"], device=dev))
        cam = configs.camera(cfg)
        prep = render.prepare_grid(grid, axes=(dominant_axis(cam),),
                                   device=dev)
        plan, _, args = render.sweep_inputs(prep, cam, run_cfg, dev)
        del prep
        geometry(f"k1_{name}", args, 1)
        base = dict(reverse=plan.reverse, sigma_scale=run_cfg.sigma_scale)
        cmax = float(args[0][:, 1:].abs().max())
        eps = run_cfg.early_stop_eps
        run(f"k1_{name}_{run_cfg.precision}_eps{eps:g}", args,
            dict(base, precision=run_cfg.precision, early_stop_eps=eps),
            plain=sweep_fwd_torch, tol=1e-5 + eps * max(cmax, 1.0),
            time_it=True)
        for prec in ("highest", "high", "default"):
            if (prec, 0.0) != (run_cfg.precision, eps):
                run(f"k1_{name}_{prec}_eps0", args,
                    dict(base, precision=prec, early_stop_eps=0.0))
        run(f"k1_{name}_highest_eps1e-2", denser(args),
            dict(base, precision="highest", early_stop_eps=1e-2))
        run(f"k1_{name}_highest_softplus", raw_density(args),
            dict(base, precision="highest", early_stop_eps=0.0,
                 softplus=True))
        del args
    del grid256, grid

    # K1 at one c4 view and K5 at the c4 minibatch.
    reverse, views, args = c4_minibatch(dev)
    v_pv = args[3].shape[0] // views
    view0 = (args[0], tuple(c[0] for c in args[1]), args[2][0],
             args[3][:v_pv])
    base = dict(reverse=reverse, sigma_scale=1.0)
    geometry("k1_c4_view", view0, 1)
    run("k1_c4_view_highest_eps0", view0,
        dict(base, precision="highest", early_stop_eps=0.0),
        plain=sweep_fwd_torch, tol=1e-5, time_it=True)
    for prec in ("high", "default"):
        run(f"k1_c4_view_{prec}_eps0", view0,
            dict(base, precision=prec, early_stop_eps=0.0))
    geometry("k5_c4", args, views)
    kw5 = dict(base, views=views, early_stop_eps=0.0)
    run("k5_c4_highest_eps0", args, dict(kw5, precision="highest"),
        plain=sweep_fwd_views_torch, tol=1e-5, time_it=True)
    for prec in ("high", "default"):
        run(f"k5_c4_{prec}_eps0", args, dict(kw5, precision=prec),
            time_it=True)
    raw = raw_density(args)
    for prec in ("highest", "default"):
        run(f"k5_c4_{prec}_softplus", raw,
            dict(kw5, precision=prec, softplus=True), time_it=True)
    del raw
    dense = denser(args)
    for prec in ("highest", "default"):
        run(f"k5_c4_{prec}_eps1e-2", dense,
            dict(kw5, precision=prec, early_stop_eps=1e-2),
            time_it=prec == "highest")
    del dense
    n_tiles = 4
    v_l = v_pv // n_tiles
    for r in range(n_tiles):
        dt = args[3].unflatten(0, (views, v_pv))[
            :, r * v_l:(r + 1) * v_l].flatten(0, 1).contiguous()
        tile = (*args[:3], dt)
        geometry(f"k5_c4_rows{r * v_l}", tile, views, r * v_l)
        for prec in ("highest", "default"):
            run(f"k5_c4_rows{r * v_l}_{prec}", tile,
                dict(kw5, precision=prec, row0=r * v_l),
                time_it=prec == "highest")

    # Times: every timed case in each of 5 rounds (CUDA events), then the
    # profiler's device time; the bound from the case's own inputs.
    ms = interleaved_ms({k: v[0] for k, v in timed.items()}, 10)
    for label, (call, a, row0) in timed.items():
        dev_ms, top, _ = device_ms(call, 5)
        bytes_ms, ops_ms = sweep_fwd_bound(a, row0)
        out["cases"][label] = {
            "ms": ms[label], "device_ms": dev_ms, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        log(f"[fwd] {label}: {ms[label]:.4f} ms (events, median of 5 "
            f"rounds); device " + ("not measured" if dev_ms is None else
                                   f"{dev_ms:.4f} ms") +
            f"; bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
            f"operations {ops_ms:.4f})")
    for key, value in sorted(out["digests"].items()):
        log(f"[fwd] digest {key} rgb {value[0]} T {value[1]}")
    return out


def light_direction(w):
    """(axis, flip, d_y, d_x, dt) of the tau sweep toward unit direction w,
    as ``tpuvr_torch.ops.lighting`` sets it up (kept here so that the light
    phase also runs in a tree that has no direction table)."""
    from tpuvr_torch.ref.march import PT_PERM

    axis = int(np.argmax(np.abs(w)))
    wp = np.asarray(w, dtype=np.float64)[list(PT_PERM[axis])]
    dz = abs(float(wp[2]))
    return (axis, bool(wp[2] < 0), float(wp[1]) / dz, float(wp[0]) / dz,
            1.0 / dz)


def tau_bound(fields, outputs):
    """(bytes ms, operations ms) of tau sweeps reading each of ``fields``
    once and writing ``outputs`` volumes of the same size:
    TAU_FLOPS_PER_VOXEL per output voxel."""
    vox = fields[0].numel()
    return ((len(fields) + outputs) * vox * 4 / HBM_BYTES_PER_S * 1e3,
            TAU_FLOPS_PER_VOXEL * outputs * vox / F32_FLOP_PER_S * 1e3)


def lit_fit_setup():
    """(lighting, grid size) of the lit fit in ``training``: c4 halved to
    128^3, 16 directions, differentiable shadows."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import LightingConfig

    return (LightingConfig(mode="lightvolume", n_samples=16, detach=False),
            configs.CONFIGS["c4"]["grid_n"] // 2)


def light_kernels(dev):
    """K2 (tau sweep) and K4 (its adjoint) against their plain versions on
    the card, as the lit render bakes them: c3's 16 directions over its
    256^3 density in one batched call each way, in every tier (1e-5 of the
    largest value: f32 sums of the same products in another order), a
    one-direction call bit for bit against the batch; the lit fit's 16
    directions over a 128^3 density (and seeded cotangents) in every tier,
    taking the cluster size the lit fit takes (4 on the H100); c5's 512^2
    planes (S = 64, the c3 shifts) against the plain versions and bit for
    bit against the plane loop; a plane wider than the cluster route takes
    (1100 columns) through the plane loop. Times the 16-direction bake and
    one direction each way (CUDA events, the bound from the call's own
    inputs). The cluster size each of these check runs took is kept under
    "check_run_routes". Returns the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ref.march import GRID_PERM

    gen = torch.Generator(device=dev).manual_seed(3)

    def rows_of(field_for, table):
        return [(field_for(a), flip, d_y, d_x, dt)
                for a, flip, d_y, d_x, dt in table]

    def route(call, counts=klight.launches):
        """(result, {cluster size: launches}) of one call."""
        before = counts.copy()
        res = call()
        return res, dict(counts - before)

    def hold(label, kernel, plain, rows, prec):
        outs = kernel(rows, prec)
        ref = plain(rows, prec)
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((o - r).abs().max()) for o, r in zip(outs, ref))
        ok = err <= 1e-5 * scale and all(bool(torch.isfinite(o).all())
                                         for o in outs)
        log(f"[kernel] {label} {prec}: max abs err {err:.3e} = "
            f"{err / scale:.3e} of max {scale:.3f} (tol 1e-5)")
        check(ok, f"{label} {prec}")
        return err, outs

    c3 = configs.CONFIGS["c3"]
    lcfg = c3["lighting"]
    table = olight.direction_table(lcfg)
    sigma = smoke_sphere(c3["grid_n"], device=dev)[..., 0].contiguous()
    fields = {a: sigma.permute(GRID_PERM[a][:3]).contiguous()
              for a in sorted({row[0] for row in table})}
    rows = rows_of(fields.__getitem__, table)
    grows = [(torch.randn(r[0].shape, generator=gen, device=dev), *r[1:])
             for r in rows]
    out = {"shape": f"c3: {tuple(sigma.shape)}, "
           f"{len(rows)} directions over {len(fields)} sweep axes"}
    for prec in ("highest", "high", "default"):
        err, taus = hold("tau_sweep c3 bake", klight.tau_sweep_dirs,
                         klight.tau_sweep_dirs_torch, rows, prec)
        adj_err, ds = hold("tau_adj c3 bake", klight.tau_sweep_adj_dirs,
                           klight.tau_sweep_adj_dirs_torch, grows, prec)
        for i in (0, 1):
            field, flip, d_y, d_x, dt = rows[i]
            kw = dict(d_y=d_y, d_x=d_x, dt=dt, precision=prec)
            f = field.flip(0) if flip else field
            one = klight.tau_sweep(f.contiguous(), **kw)
            one_d = klight.tau_sweep_adj(grows[i][0].flip(0).contiguous()
                                         if flip else grows[i][0], **kw)
            same = (torch.equal(one.flip(0) if flip else one, taus[i])
                    and torch.equal(one_d.flip(0) if flip else one_d, ds[i]))
            log(f"[kernel] tau_sweep/tau_adj {prec} direction {i}: one "
                f"direction bit for bit the batch's {same}")
            check(same, f"tau one direction vs batch {prec}")
        if prec == "highest":
            out["max_abs_err"], out["adj_max_abs_err"] = err, adj_err
        del taus, ds

    # The lit fit's table and planes (128^2, clusters of 4 on the H100).
    lit_cfg, n_lit = lit_fit_setup()
    lit_table = olight.direction_table(lit_cfg)
    lit_sigma = smoke_sphere(n_lit, device=dev)[..., 0].contiguous()
    lit_rows = rows_of({a: lit_sigma.permute(GRID_PERM[a][:3]).contiguous()
                        for a in {row[0] for row in lit_table}}.__getitem__,
                       lit_table)
    lit_grows = [(torch.randn(r[0].shape, generator=gen, device=dev),
                  *r[1:]) for r in lit_rows]
    lit = {"routes": {}, "max_abs_err": {}, "adj_max_abs_err": {}}
    for prec in ("highest", "high", "default"):
        (err, _), k2 = route(lambda: hold(
            f"tau_sweep lit fit {n_lit}^3", klight.tau_sweep_dirs,
            klight.tau_sweep_dirs_torch, lit_rows, prec))
        (adj_err, _), k4 = route(lambda: hold(
            f"tau_adj lit fit {n_lit}^3", klight.tau_sweep_adj_dirs,
            klight.tau_sweep_adj_dirs_torch, lit_grows, prec),
            klight.adj_launches)
        lit["max_abs_err"][prec], lit["adj_max_abs_err"][prec] = err, adj_err
        lit["routes"][prec] = {"tau_sweep": k2, "tau_adj": k4}
        log(f"[kernel] tau lit fit table {prec}: launches by cluster size "
            f"K2 {k2} K4 {k4}")
        check(k2 == {4: 1} and k4 == {4: 1},
              f"lit fit table {prec}: one launch in clusters of 4 each way "
              f"expected, got K2 {k2} K4 {k4}")
    out["lit_fit"] = lit
    del lit_rows, lit_grows, lit_sigma

    # Times: the bake (16 directions, one call) and one direction, each way.
    one_row, one_grow = rows[:1], grows[:1]
    routes = out["check_run_routes"] = {"lit_fit_table": lit["routes"]}
    (_, routes["c3_bake"]) = route(lambda: klight.tau_sweep_dirs(rows))
    (_, routes["one_direction"]) = route(
        lambda: klight.tau_sweep_dirs(one_row))
    fns = {"bake": lambda: klight.tau_sweep_dirs(rows),
           "adj_bake": lambda: klight.tau_sweep_adj_dirs(grows),
           "one": lambda: klight.tau_sweep_dirs(one_row),
           "adj_one": lambda: klight.tau_sweep_adj_dirs(one_grow)}
    for name, ms in interleaved_ms(fns, 5).items():
        out[f"{name}_ms"] = ms
    for name, fn in fns.items():
        out[f"{name}_device_ms"] = device_ms(fn, 3)[0]
    out["plain_bake_ms"] = cuda_ms(
        lambda: klight.tau_sweep_dirs_torch(rows), 1)
    out["adj_plain_bake_ms"] = cuda_ms(
        lambda: klight.tau_sweep_adj_dirs_torch(grows), 1)
    out["plain_one_ms"] = cuda_ms(
        lambda: klight.tau_sweep_dirs_torch(one_row), 2)
    out["adj_plain_one_ms"] = cuda_ms(
        lambda: klight.tau_sweep_adj_dirs_torch(one_grow), 2)
    out["bake_bytes_ms"], out["bake_ops_ms"] = tau_bound(
        list(fields.values()), len(rows))
    out["adj_bake_bytes_ms"], out["adj_bake_ops_ms"] = tau_bound(
        [g for g, *_ in grows], len(grows))
    out["one_bytes_ms"], out["one_ops_ms"] = tau_bound([sigma], 1)
    log(f"[kernel] tau_sweep c3 bake ({len(rows)} directions, one call, "
        f"clusters {routes['c3_bake']}): {out['bake_ms']:.4f} ms, adjoint "
        f"{out['adj_bake_ms']:.4f} ms (plain {out['plain_bake_ms']:.2f} / "
        f"{out['adj_plain_bake_ms']:.2f}); one direction (clusters "
        f"{routes['one_direction']}) {out['one_ms']:.4f} / "
        f"{out['adj_one_ms']:.4f} "
        f"ms (plain {out['plain_one_ms']:.2f} / "
        f"{out['adj_plain_one_ms']:.2f}); bound {out['bake_bytes_ms']:.4f} "
        f"a bake, {out['one_bytes_ms']:.4f} a direction (bytes)")
    del rows, grows, fields, one_row, one_grow

    # c5's 512^2 planes, and a plane too wide for the cluster route.
    sig = torch.rand((64, 512, 512), generator=gen, device=dev) - 0.3
    rows = rows_of(lambda a: sig, table)
    grows = [(torch.randn(sig.shape, generator=gen, device=dev), *r[1:])
             for r in rows]
    (taus, routes["c5_512"]) = route(lambda: klight.tau_sweep_dirs(rows))
    ds = klight.tau_sweep_adj_dirs(grows)
    loop = klight.tau_sweep_dirs(rows, _cluster=0)
    loop_d = klight.tau_sweep_adj_dirs(grows, _cluster=0)
    same = (all(torch.equal(a, b) for a, b in zip(taus, loop))
            and all(torch.equal(a, b) for a, b in zip(ds, loop_d)))
    del taus, ds, loop, loop_d
    err, _ = hold("tau_sweep 64x512^2", klight.tau_sweep_dirs,
                  klight.tau_sweep_dirs_torch, rows, "highest")
    adj_err, _ = hold("tau_adj 64x512^2", klight.tau_sweep_adj_dirs,
                      klight.tau_sweep_adj_dirs_torch, grows, "highest")
    log(f"[kernel] tau 64x512^2, clusters {routes['c5_512']}: bit for bit "
        f"the plane loop {same}")
    check(same and set(routes["c5_512"]) == {16}, "tau 512^2 cluster route")
    out["c5"] = dict(max_abs_err=err, adj_max_abs_err=adj_err,
                     bit_identical_to_plane_loop=same)
    del rows, grows, sig
    wide = torch.rand((6, 8, 1100), generator=gen, device=dev)
    wrow = [(wide, True, 0.3, -0.7, 1.2)]
    (w_tau, routes["wide_1100"]) = route(
        lambda: klight.tau_sweep_dirs(wrow))
    w_err = float((w_tau[0] - klight.tau_sweep_dirs_torch(wrow)[0]
                   ).abs().max())
    log(f"[kernel] tau_sweep 6x8x1100 (wider than the cluster route): "
        f"launches {routes['wide_1100']}, max abs err {w_err:.3e}")
    check(routes["wide_1100"] == {0: 5} and w_err <= 1e-5 * float(
        w_tau[0].abs().max()), "tau plane loop for a wide plane")
    out["persample"] = persample_checks(dev)
    return out


def persample_checks(dev):
    """The 'persample' lighting mode (ROADMAP A6: the exact light volume,
    plain PyTorch on the card, no kernel): (a) ``light_volume_exact`` of
    the 64^3 smoke sphere's density, c3's 16 directions, step 1, under
    no_grad, 64 planes a call, against the same marches on the CPU at 4 of
    its 64 planes within 1e-5 of max L (the whole volume takes some 35 s
    on 8 CPU cores), and the K2 bake at c3's settings against it within
    0.08 at the voxels 2 or more from a face, each timed with its peak
    memory; (b) ``render_view`` at 32^3 @ 64^2 (c3's camera and render
    config) lit by 'persample' with differentiable shadows, through
    ``apply_lighting``'s one plane a call: the image and the grid gradient
    of mean((rgb - 0.25)^2) against device="cpu" (image within 1e-5 + eps,
    gradient within GRAD_TOL of max|grad|), timed; (c) the gradient of a
    seeded weighted sum of ``light_volume_exact`` at 16^3 against the
    CPU's within GRAD_TOL of max|grad|. Returns the numbers."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ops import render

    t_start = time.perf_counter()
    c3 = configs.CONFIGS["c3"]
    pcfg = LightingConfig(mode="persample",
                          n_samples=c3["lighting"].n_samples)
    tol_g = GRAD_TOL["highest"]
    out = {}

    def peak_gib(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        return res, (torch.cuda.max_memory_allocated() - base) / 2**30

    n = PERSAMPLE_N
    sigma = smoke_sphere(n, device=dev)[..., 0].contiguous()
    with torch.no_grad():
        def oracle():
            return olight.light_volume_exact(sigma, pcfg, chunk_planes=n)

        def bake():
            return olight.light_volume(sigma, c3["lighting"], "highest")

        exact, out["oracle_peak_gib"] = peak_gib(oracle)
        baked, out["bake_peak_gib"] = peak_gib(bake)
        out["oracle_ms"] = cuda_ms(oracle, 1, warmup=0)
        out["bake_ms"] = cuda_ms(bake, 5)
        zs = PERSAMPLE_CPU_PLANES
        ys, xs = torch.meshgrid(torch.arange(n, dtype=torch.float32),
                                torch.arange(n, dtype=torch.float32),
                                indexing="ij")
        zt = torch.tensor(zs, dtype=torch.float32)[:, None, None]
        pts = torch.stack([xs.expand(len(zs), -1, -1),
                           ys.expand(len(zs), -1, -1),
                           zt.expand(len(zs), n, n)], dim=-1)
        t0 = time.perf_counter()
        ref = olight.light_at_points_ref(sigma.cpu(), pts, pcfg,
                                         dt=pcfg.secondary_dt)
        out["cpu_s_planes"] = time.perf_counter() - t0
    scale = float(ref.abs().max())
    out["oracle_vs_cpu"] = float((exact[list(zs)].cpu() - ref).abs().max())
    inner = slice(2, n - 2)
    out["bake_vs_oracle_interior"] = float(
        (baked - exact)[inner, inner, inner].abs().max())
    out["bake_vs_oracle_all"] = float((baked - exact).abs().max())
    log(f"[light] persample {n}^3, {pcfg.n_samples} directions, step "
        f"{pcfg.secondary_dt:g}: card vs CPU at planes {zs} "
        f"{out['oracle_vs_cpu']:.3e} (tol {1e-5 * scale:.3e}); K2 bake vs "
        f"it {out['bake_vs_oracle_interior']:.4f} at voxels 2+ from a face "
        f"(tol 0.08), {out['bake_vs_oracle_all']:.4f} over all; oracle "
        f"{out['oracle_ms']:.2f} ms, peak {out['oracle_peak_gib']:.3f} GiB "
        f"(CPU: {out['cpu_s_planes']:.2f} s for {len(zs)} planes); bake "
        f"{out['bake_ms']:.3f} ms, peak {out['bake_peak_gib']:.3f} GiB")
    check(bool(torch.isfinite(exact).all()), "persample: non-finite")
    check(out["oracle_vs_cpu"] <= 1e-5 * scale, "persample card vs CPU")
    check(out["bake_vs_oracle_interior"] < 0.08, "K2 bake vs persample")
    del sigma, exact, baked

    n_r, res = PERSAMPLE_RENDER
    cam = configs.camera(c3, n_r, res)
    rcfg = c3["render"]
    lit = LightingConfig(mode="persample", detach=False)
    g0 = smoke_sphere(n_r, device="cpu")

    def lit_grad(device):
        g = g0.to(device).requires_grad_(True)
        rgb, t = render.render_view(g, cam, rcfg, lighting=lit,
                                    device=device)
        (grad,) = torch.autograd.grad(torch.mean((rgb - 0.25) ** 2), g)
        return rgb.detach().cpu(), t.detach().cpu(), grad.cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = lit_grad(None)
    torch.cuda.synchronize()
    out["render_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = lit_grad("cpu")
    out["render_cpu_s"] = time.perf_counter() - t0
    out["render_image_vs_cpu"] = max_err(on_card[:2], on_cpu[:2])
    gmax = float(on_cpu[2].abs().max())
    out["render_grad_vs_cpu_of_max"] = float(
        (on_card[2] - on_cpu[2]).abs().max()) / gmax
    log(f"[light] persample render_view {n_r}^3 @ {res}^2, shadows "
        f"differentiated: image vs CPU {out['render_image_vs_cpu']:.3e} "
        f"(tol {1e-5 + rcfg.early_stop_eps:.1e}), grid gradient "
        f"{out['render_grad_vs_cpu_of_max']:.3e} of max {gmax:.3e} (tol "
        f"{tol_g:g}); forward+backward {out['render_card_s'] * 1e3:.1f} ms "
        f"on the card, {out['render_cpu_s'] * 1e3:.1f} ms on the CPU")
    check(gmax > 0.0 and out["render_image_vs_cpu"]
          <= 1e-5 + rcfg.early_stop_eps, "persample render card vs CPU")
    check(out["render_grad_vs_cpu_of_max"] <= tol_g,
          "persample render gradient card vs CPU")
    del on_card, on_cpu

    s16 = smoke_sphere(PERSAMPLE_GRAD_N, device="cpu")[..., 0].contiguous()
    w = torch.randn(s16.shape, generator=torch.Generator().manual_seed(9))

    def vol_grad(device):
        s = s16.to(device).requires_grad_(True)
        vol = olight.light_volume_exact(s, pcfg)
        (grad,) = torch.autograd.grad((w.to(device) * vol).sum(), s)
        return grad.cpu()

    ref = vol_grad("cpu")
    out["grad16_vs_cpu_of_max"] = float(
        (vol_grad(dev) - ref).abs().max()) / float(ref.abs().max())
    log(f"[light] persample {PERSAMPLE_GRAD_N}^3 gradient card vs CPU "
        f"{out['grad16_vs_cpu_of_max']:.3e} of max (tol {tol_g:g})")
    check(out["grad16_vs_cpu_of_max"] <= tol_g,
          "persample gradient card vs CPU")
    out["seconds"] = time.perf_counter() - t_start
    log(f"[light] persample checks in {out['seconds']:.1f} s")
    return out


def light_phase(dev):
    """The light bake's kernels alone (K2, K4), for redesigning them: at
    c3's 16 directions over its 256^3 density, SHA-256 digests of every
    direction's tau at 'highest' and of four at 'high' and 'default', of
    K4's gradient for the same directions (from seeded cotangents), of the
    light volume L and of dL/dsigma, and of the lit fit's first-step
    gradient (c4 cut to 128^3, 8 views at 128^2, 16 directions,
    detach=False); CUDA-event times in interleaved rounds of K2 and K4 for
    the bake and for one direction, of the light volume and of c3's
    prepare_grid (with the bake's host wall time, device time and peak
    memory), and the lit fit's step times; the bounds; the cluster size and
    route of each batched call, and K2's times at each cluster size where
    the wrappers can be asked for one. Every array is digested in the (Z, Y, X)
    layout, so that the phase gives the same digests in a tree that has
    only the one-direction wrappers (its parent), for holding a change bit
    for bit against it in one call. Returns the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis
    from tpuvr_torch.ref.march import GRID_PERM
    from tpuvr_torch.train import fit

    batched = hasattr(klight, "tau_sweep_dirs")
    c3 = configs.CONFIGS["c3"]
    lcfg = c3["lighting"]
    dirs = olight.hemisphere_dirs(lcfg.n_samples, lcfg.up)
    table = [light_direction(w) for w in dirs]
    sigma = smoke_sphere(c3["grid_n"], device=dev)[..., 0].contiguous()
    perm = {a: GRID_PERM[a][:3] for a in range(3)}
    inv = {a: tuple(int(i) for i in np.argsort(perm[a])) for a in range(3)}
    gen = torch.Generator(device=dev).manual_seed(4)
    gs = [torch.randn(sigma.shape, generator=gen, device=dev) for _ in table]
    out = {"batched": batched, "digests": {}, "cases": {}, "routes": {}}

    def layout(vol, i):
        """Direction i's input in its sweep layout (flipped too where the
        one-direction wrapper needs it)."""
        a, flip = table[i][:2]
        v = vol.permute(perm[a])
        return (v.flip(0) if flip and not batched else v).contiguous()

    def back(res, i):
        a, flip = table[i][:2]
        return (res.flip(0) if flip and not batched else res).permute(inv[a])

    def sweeps(adjoint, vols, idx, prec):
        """The directions idx of K2 (vols: the density) or K4 (vols: one
        cotangent a direction) from prepared inputs: one call (batched) or
        one call a direction; outputs in their sweep layout."""
        if batched:
            rows = [(vols[i], *table[i][1:]) for i in idx]
            fn = klight.tau_sweep_adj_dirs if adjoint else klight.tau_sweep_dirs
            return lambda: fn(rows, prec)
        fn = klight.tau_sweep_adj if adjoint else klight.tau_sweep
        return lambda: [fn(vols[i], d_y=table[i][2], d_x=table[i][3],
                           dt=table[i][4], precision=prec) for i in idx]

    every = list(range(len(table)))
    few = (0, 5, 10, 15)
    sig_in = [layout(sigma, i) for i in every]
    g_in = [layout(g, i) for i, g in enumerate(gs)]
    for prec in ("highest", "high", "default"):
        idx = every if prec == "highest" else few
        before = klight.launches.copy() if batched else None
        taus = sweeps(False, sig_in, idx, prec)()
        ds = sweeps(True, g_in, idx, prec)()
        if batched:
            out["routes"][prec] = {str(k): v for k, v in (
                klight.launches - before).items()}
        for i, t, d in zip(idx, taus, ds):
            out["digests"][f"tau_{prec}_d{i:02d}"] = digest(back(t, i))
            out["digests"][f"ds_{prec}_d{i:02d}"] = digest(back(d, i))
        del taus, ds
    for prec in ("highest", "default"):
        out["digests"][f"L_{prec}"] = digest(olight.light_volume(
            sigma, lcfg, prec))
    s = sigma.clone().requires_grad_(True)
    (olight.light_volume(s, lcfg) * gs[0]).sum().backward()
    out["digests"]["dL_dsigma_highest"] = digest(s.grad)
    del s

    # Times, interleaved: K2 and K4 for the bake and for one direction, the
    # light volume, c3's prepare_grid (its bake and the lit grid).
    grid = smoke_sphere(c3["grid_n"], device=dev)
    axis = dominant_axis(configs.camera(c3))
    prec3 = c3["render"].precision
    fns = {"k2_bake": sweeps(False, sig_in, every, "highest"),
           "k4_bake": sweeps(True, g_in, every, "highest"),
           "k2_direction": sweeps(False, sig_in, [0], "highest"),
           "k4_direction": sweeps(True, g_in, [0], "highest"),
           "light_volume": lambda: olight.light_volume(sigma, lcfg),
           "c3_bake": lambda: render.prepare_grid(
               grid, axes=(axis,), lighting=lcfg, precision=prec3)}
    ms = interleaved_ms(fns, 3)
    # The bake's inputs: the density in each sweep axis's layout.
    fields = [sigma] * len({r[0] for r in table})
    bounds = {"k2_bake": tau_bound(fields, len(table)),
              "k4_bake": tau_bound(g_in, len(table)),
              "k2_direction": tau_bound([sigma], 1),
              "k4_direction": tau_bound([sigma], 1)}
    for name, fn in fns.items():
        dev_ms, top, _ = device_ms(fn, 2)
        case = {"ms": ms[name], "device_ms": dev_ms,
                "device_top": [[k, v] for k, v in top]}
        if name in bounds:
            b, o = bounds[name]
            case.update(bytes_ms=b, ops_ms=o, bound_ms=max(b, o),
                        bound_by="bytes" if b >= o else "operations")
        out["cases"][name] = case
        log(f"[light] {name}: {ms[name]:.4f} ms (events, median of 5 "
            f"rounds); device " + ("not measured" if dev_ms is None else
                                   f"{dev_ms:.4f} ms") + (
            f"; bound {case['bound_ms']:.4f} ms ({case['bound_by']})"
            if name in bounds else ""))
    if batched and "_cluster" in inspect.signature(
            klight.tau_sweep_dirs).parameters:
        # K2 at each cluster size the route has, for the bake and for one
        # direction (the C entry chooses among them by residency).
        rows = [(sig_in[i], *table[i][1:]) for i in every]
        sizes = {f"k2_{what}_n{n}": (
            lambda r=r, n=n: klight.tau_sweep_dirs(r, _cluster=n))
            for what, r in (("bake", rows), ("direction", rows[:1]))
            for n in klight.CLUSTERS}
        out["cluster_sizes_ms"] = interleaved_ms(sizes, 3)
        log(f"[light] K2 by cluster size (events ms, median of 5 rounds): "
            f"{out['cluster_sizes_ms']}")
        del rows, sizes
    del fns, sig_in, g_in
    for _ in range(2):  # the second is the one kept: allocator warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prep = render.prepare_grid(grid, axes=(axis,), lighting=lcfg,
                                   precision=prec3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        del prep
    out["c3_bake_wall_ms"], out["c3_bake_peak_gib"] = wall, peak
    log(f"[light] c3 prepare_grid (16-direction bake, lit grid): host wall "
        f"{wall:.2f} ms, peak {peak:.3f} GiB above the grid")
    del grid, gs

    # The lit fit: its first-step gradient (twice: deterministic?) and the
    # times of three steps.
    c4 = configs.CONFIGS["c4"]
    nl = c4["grid_n"] // 2
    lit = LightingConfig(mode="lightvolume", n_samples=16, detach=False)
    lcams = configs.cameras(c4, n=nl, res=nl, n_views=8)
    ltargets = fit.render_all_views(smoke_sphere(nl), lcams, c4["render"],
                                    lighting=lit)

    class Record(fit.Adam):
        """Adam that keeps the first gradient it is given."""

        def update(self, grads, state):
            if not hasattr(self, "first"):
                object.__setattr__(self, "first", grads.detach().clone())
            return super().update(grads, state)

    grads, steps_ms = [], None
    run_root = tempfile.mkdtemp(prefix=".chip_smoke_",
                                dir=Path(__file__).resolve().parent)
    try:
        for steps in (3, 1):
            opt = Record(c4["train"].lr)
            cfg = dataclasses.replace(c4["train"], steps=steps, ckpt_every=0)
            _, _, hist = fit.fit_grid(ltargets, lcams, (nl, nl, nl, 4), cfg,
                                      c4["render"], lighting=lit, opt=opt,
                                      run_dir=f"{run_root}/lit{steps}")
            torch.cuda.synchronize()
            grads.append(opt.first)
            steps_ms = steps_ms or hist["step_ms"]
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    same = torch.equal(grads[0], grads[1])
    out["digests"]["lit_fit_first_step_grad"] = digest(grads[0])
    out["lit_fit"] = dict(step_ms=steps_ms, first_grad_deterministic=same)
    log(f"[light] lit fit {nl}^3, 16 directions, detach=False: step ms "
        f"{[round(t, 3) for t in steps_ms]}; first-step gradient the same "
        f"over two runs {same}")
    if batched:
        log(f"[light] cluster launches by size, per tier: {out['routes']}")
    for key, value in sorted(out["digests"].items()):
        log(f"[light] digest {key} {value}")
    return out


def warp_kernels(dev):
    """The row-block warp pair (K7: forward, K8: backward) at c4's row plans,
    the first view of the first group of each sweep axis (the two plan
    shapes), on a random (4, 256, 256) lattice in [0, 1): K7 against its
    plain version (1e-6) and against grid_sample (bilinear, align_corners,
    border, the same positions; 1e-4: grid_sample normalises the positions
    to [-1, 1] and back, which moves them by up to ~1.5e-5 lattice units at
    255); K8 against its plain version (1e-5 of max|grad|), against
    grid_sample's input gradient (1e-4 of max|grad|), and bit for bit over
    two calls. Times the kernels, their plain versions and grid_sample each
    way (the library yardstick): CUDA events, the profiler's device time
    (with its split by CUDA kernel) and the host's time to issue one call.
    Returns the numbers for the summary."""
    from tpuvr_torch.kernels import warp as kwarp
    from tpuvr_torch.kernels.warp_torch import (
        warp_rows_bwd_torch,
        warp_rows_fwd_torch,
    )

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain warp would keep ~3 digits")
    groups = c4_row_groups()
    for key in sorted(groups):
        plan = groups[key][3]
        log(f"[kernel] c4 row plan {key}: {plan.ty}x{plan.tx} tiles, f_v "
            f"{plan.f_v}")
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"cases": {}}
    seen = set()
    for key in sorted(groups):
        if key[0] in seen:
            continue
        seen.add(key[0])
        _, stacked, _, plan = groups[key]
        y, x, vb = (stacked[k][0].to(dev) for k in ("rwy", "rwx", "rwvb"))
        n_v, n_u = stacked["dt"].shape[1:]
        n_tiles, p = y.shape
        f_v = plan.f_v
        inter = torch.rand((4, n_v, n_u), generator=gen, device=dev)
        d_out = torch.randn((4, n_tiles, p), generator=gen, device=dev)
        pos = torch.stack([x / (n_u - 1) * 2 - 1, y / (n_v - 1) * 2 - 1],
                          dim=-1)[None]

        def gs_fwd():
            return torch.nn.functional.grid_sample(
                inter[None], pos, mode="bilinear", padding_mode="border",
                align_corners=True)[0]

        def gs_bwd():
            return torch.ops.aten.grid_sampler_2d_backward(
                d_out[None], inter[None], pos, 0, 1, True,
                [True, False])[0][0]

        k7 = kwarp.warp_rows_fwd(inter, y, x, vb, f_v=f_v)
        p7 = warp_rows_fwd_torch(inter, y, x, vb, f_v=f_v)
        k8 = kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u, f_v=f_v)
        k8b = kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u, f_v=f_v)
        p8 = warp_rows_bwd_torch(d_out, y, x, vb, n_v, n_u, f_v=f_v)
        torch.cuda.synchronize()
        scale = float(p8.abs().max())
        c = dict(
            plan=f"{plan.ty}x{plan.tx} tiles, f_v {f_v}",
            lattice=f"4 x {n_v} x {n_u}", n_tiles=n_tiles,
            pixels_per_tile=p,
            fwd_err=float((k7 - p7).abs().max()),
            fwd_err_vs_grid_sample=float((k7 - gs_fwd()).abs().max()),
            bwd_abs_err=float((k8 - p8).abs().max()),
            bwd_err_of_max=float((k8 - p8).abs().max()) / scale,
            bwd_err_of_max_vs_grid_sample=float(
                (k8 - gs_bwd()).abs().max()) / scale,
            bwd_bit_identical=bool(torch.equal(k8, k8b)))
        log(f"[kernel] warp_rows c4 axis {key[0]} ({c['plan']}, {n_tiles} "
            f"tiles of {p} pixels): K7 max abs err {c['fwd_err']:.3e} "
            f"against plain (tol 1e-6), {c['fwd_err_vs_grid_sample']:.3e} "
            f"against grid_sample (tol 1e-4); K8 {c['bwd_err_of_max']:.3e} "
            f"of max|grad| {scale:.3e} against plain (tol 1e-5), "
            f"{c['bwd_err_of_max_vs_grid_sample']:.3e} against grid_sample "
            f"(tol 1e-4), two calls bit-identical {c['bwd_bit_identical']}")
        check(c["fwd_err"] <= 1e-6 and c["fwd_err_vs_grid_sample"] <= 1e-4
              and bool(torch.isfinite(k7).all()), f"warp_rows_fwd {key}")
        check(scale > 0 and c["bwd_err_of_max"] <= 1e-5
              and c["bwd_err_of_max_vs_grid_sample"] <= 1e-4
              and c["bwd_bit_identical"], f"warp_rows_bwd {key}")
        # Unique bytes either way: the positions and origins, the (4, T, P)
        # tiles and the (4, V, U) image (or their cotangent and gradient).
        pos_b = 2 * n_tiles * p * 4 + n_tiles * 4
        tile_b, image_b = 4 * n_tiles * p * 4, 4 * n_v * n_u * 4

        def k7_call():
            return kwarp.warp_rows_fwd(inter, y, x, vb, f_v=f_v)

        def k8_call():
            return kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u, f_v=f_v)

        # Each kernel and its library call are timed in turns, 5 rounds of
        # 50 calls, and the median round kept: at a few microseconds a call
        # the events read the host's issue rate, which drifts within a run.
        c.update(
            **interleaved_ms({"fwd_ms": k7_call, "fwd_library_ms": gs_fwd,
                              "bwd_ms": k8_call, "bwd_library_ms": gs_bwd},
                             50),
            fwd_plain_ms=cuda_ms(lambda: warp_rows_fwd_torch(
                inter, y, x, vb, f_v=f_v), 3),
            bwd_plain_ms=cuda_ms(lambda: warp_rows_bwd_torch(
                d_out, y, x, vb, n_v, n_u, f_v=f_v), 3),
            bytes_ms=(pos_b + tile_b + image_b) / HBM_BYTES_PER_S * 1e3,
            ops_ms=(WARP_FLOPS_PER_SAMPLE * 4 * n_tiles * p
                    / F32_FLOP_PER_S * 1e3))
        # Device time (profiler) beside the event times above, which on a
        # call of a few microseconds may measure the host's issue instead;
        # and the host's own time to issue one call.
        for name, fn in (("fwd", k7_call), ("bwd", k8_call),
                         ("fwd_library", gs_fwd), ("bwd_library", gs_bwd)):
            c[f"{name}_device_ms"], top, _ = device_ms(fn, 20)
            c[f"{name}_host_us"] = host_us(fn, 200)
            log(f"[kernel] warp_rows c4 axis {key[0]} {name} device time by "
                "kernel: " + "; ".join(f"{k} {v:.4f} ms" for k, v in top))
        log(f"[kernel] warp_rows c4 axis {key[0]}: " + ", ".join(
            f"{k} {v:.4f}" if v is not None else f"{k} not measured"
            for k, v in c.items() if k.endswith(("_ms", "_us"))))
        out["cases"][f"axis{key[0]}"] = c
        del inter, d_out, pos, k7, p7, k8, k8b, p8
    cases = out["cases"].values()
    out["fwd_max_abs_err"] = max(c["fwd_err"] for c in cases)
    out["bwd_max_abs_err"] = max(c["bwd_abs_err"] for c in cases)
    out["bwd_err_of_max"] = max(c["bwd_err_of_max"] for c in cases)
    return out


def training(dev, run_root):
    """The training main paths: c4 at full width through fit_grid, as
    configured and fused, each with the view-batched sweep and view by
    view, and with the view batch under the row-block warp; one batched c4
    step through the kernels against the same step through the plain
    versions and against the view-by-view step, and a rows step against
    the gather step; evaluate_psnr over the 64 views under rows against the
    gather render; a lit fit with differentiable shadows at 128^3. Returns
    the numbers for the summary."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.dist.workers import CaptureGrad
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.train import fit
    from tpuvr_torch.utils.metrics import psnr

    c4 = configs.CONFIGS["c4"]
    run = c4["render"]
    n = c4["grid_n"]
    shape = (n, n, n, 4)
    cams = configs.cameras(c4)
    k_views = c4["train"].views_per_batch
    t0 = time.time()
    targets = fit.render_all_views(smoke_sphere(n), cams, run)
    torch.cuda.synchronize()
    log(f"[main] c4 targets: {len(cams)} views at {c4['res']}^2 rendered in "
        f"{time.time() - t0:.2f} s")
    check(targets.shape == (len(cams), c4["res"], c4["res"], 3)
          and bool(torch.isfinite(targets).all())
          and float(targets.max()) > 0.0, "c4 targets")

    def view_batch(on):
        """fit_grid's view batch on (the default) or off, through the JAX
        package's own switch."""
        if on:
            os.environ.pop("TPUVR_VIEW_BATCH", None)
        else:
            os.environ["TPUVR_VIEW_BATCH"] = "0"

    grid_rows = None  # the configured rows run's grid, on the host

    def fit_run(label, steps, k, fused, batched, warp):
        nonlocal grid_rows
        cfg = dataclasses.replace(c4["train"], steps=steps,
                                  steps_per_call=k)
        view_batch(batched)
        warp_mode(warp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        grid, params, hist = fit.fit_grid(
            targets, cams, shape, cfg, run, run_dir=f"{run_root}/{label}",
            fused=fused)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        view_batch(True)
        warp_mode("gather")
        loss = hist["loss"]
        ms = float(np.mean(hist["step_ms"][1:]))
        log(f"[main] c4 {label} ({steps} steps, steps_per_call {k}, fused "
            f"{fused}, view batch {batched}, warp {warp}): {ms:.3f} ms/step "
            "after the "
            f"first ({hist['step_ms'][0]:.1f} ms), loss {loss[0]:.5f} -> "
            f"{loss[-1]:.5f}, launches {counts}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"fit_grid wall {wall:.2f} s")
        check(len(loss) == steps and all(np.isfinite(loss)),
              f"c4 {label} losses")
        check(loss[-1] < loss[0], f"c4 {label}: the loss did not fall")
        # Every c4 group holds 16 views, so every step marches 8, and the
        # row warp warps each of them once each way.
        per_step = ({"sweep_fwd_views": 1, "sweep_bwd_views": 1,
                     "sweep_fwd": 0, "sweep_bwd": 0} if batched else
                    {"sweep_fwd_views": 0, "sweep_bwd_views": 0,
                     "sweep_fwd": k_views, "sweep_bwd": k_views})
        rows = k_views if warp == "rows" else 0
        per_step.update(warp_rows_fwd=rows, warp_rows_bwd=rows)
        check(all(counts[name] == m * steps for name, m in per_step.items()),
              f"c4 {label} did not go through the expected kernels")
        check(bool(torch.isfinite(grid).all()), f"c4 {label} grid")
        if label == "rows":
            grid_rows = grid.cpu()
        return dict(ms_per_step=ms, first_step_ms=hist["step_ms"][0],
                    loss_first=loss[0], loss_last=loss[-1], launches=counts,
                    steps=steps, steps_per_call=k, fused=fused,
                    view_batch=batched, warp=warp,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    runs = (("c4", "configured", 10, 1, False, True, "gather"),
            ("c4_fused", "fused", 8, 4, True, True, "gather"),
            ("c4_loop", "configured_loop", 10, 1, False, False, "gather"),
            ("c4_fused_loop", "fused_loop", 8, 4, True, False, "gather"),
            ("c4_rows", "rows", 10, 1, False, True, "rows"),
            ("c4_fused_rows", "fused_rows", 8, 4, True, True, "rows"))
    out = {name: fit_run(*run_args) for name, *run_args in runs}

    # Device-busy share: device time per step of an 8-step fit
    # (torch.profiler's device events, set-up included) over the ms/step
    # of the unprofiled run above (the profiler slows the host).
    n_prof = 8
    for name, _, _, k, fused, batched, warp in runs:
        def short(k=k, fused=fused):
            cfg = dataclasses.replace(c4["train"], steps=n_prof,
                                      steps_per_call=k, ckpt_every=0)
            fit.fit_grid(targets, cams, shape, cfg, run,
                         run_dir=f"{run_root}/profiled", fused=fused)

        view_batch(batched)
        warp_mode(warp)
        dev_ms, top, ops = device_ms(short, 1, n_top=8)
        view_batch(True)
        warp_mode("gather")
        per_step = None if dev_ms is None else dev_ms / n_prof
        out[name].update(
            host_ops_per_step=ops / n_prof,
            device_ms_per_step=per_step,
            device_busy=(None if dev_ms is None
                         else per_step / out[name]["ms_per_step"]))
        log(f"[main] {name} device time: " + (
            "not measured (the profiler saw no device activity)"
            if dev_ms is None else
            f"{per_step:.3f} ms/step, busy "
            f"{out[name]['device_busy']:.3f} of the step; by kernel "
            + "; ".join(f"{k} {v / n_prof:.3f} ms/step" for k, v in top))
            + f"; {ops / n_prof:.0f} top-level ATen ops per step (set-up "
            "included)")

    # One c4 step from one state, batched through the kernels, against
    # the same step through the plain versions and against the step
    # marched view by view through the kernels: loss and gradient.
    groups = fit.group_views(cams, shape)
    key = sorted(groups)[0]
    idxs, stacked, _, _ = groups[key]
    stacked = {name: t.to(dev) for name, t in stacked.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    params = fit.init_params(shape, True) + 0.3 * torch.randn(
        shape, generator=gen, device=dev)
    group_targets = targets[torch.as_tensor(idxs, device=dev)]
    res, host = {}, {}

    def host_clock(label, call):
        """The time to issue one step from an idle card, and to its end
        (host clock, median of 5)."""
        issue, whole = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            issue.append((t1 - t0) * 1e3)
            whole.append((time.perf_counter() - t0) * 1e3)
        host[label] = dict(issue_ms=float(np.median(issue)),
                           step_ms=float(np.median(whole)))
        log(f"[main] c4 step ({label}), host clock: "
            f"{host[label]['issue_ms']:.3f} ms to issue from an idle card, "
            f"{host[label]['step_ms']:.3f} ms to its end")

    for label, impl, batched in (("kernels", "cuda", True),
                                 ("plain", "torch", True),
                                 ("view_loop", "cuda", False)):
        step = fit.make_train_step(key, k_views, CaptureGrad(), run, True,
                                   impl, view_batch=batched)

        def call(step=step):
            return step(params, None, stacked, group_targets,
                        np.arange(k_views), np.zeros(k_views, np.int32))

        _, grad, loss = call()
        res[label] = (float(loss), grad)
        if impl == "cuda":
            host_clock(label, call)
    out["step_check"] = {}
    for other in ("plain", "view_loop"):
        rel = abs(res["kernels"][0] - res[other][0]) / res[other][0]
        scale = float(res[other][1].abs().max())
        gerr = float((res["kernels"][1] - res[other][1]).abs().max())
        log(f"[main] c4 batched step through the kernels vs {other}: loss "
            f"{res['kernels'][0]:.7f} vs {res[other][0]:.7f} ({rel:.2e} "
            f"relative, tol 1e-6); gradient {gerr / scale:.3e} of max|grad| "
            f"{scale:.3e} (tol 1e-5)")
        check(rel <= 1e-6 and gerr <= 1e-5 * scale,
              f"c4 batched step vs {other}")
        out["step_check"][other] = dict(loss_rel_err=rel,
                                        grad_err_of_max=gerr / scale)
    del groups, stacked, res, grad

    # The same state through a batched step with the row-block warp against
    # the step with the 4-tap gather, for the first group of each sweep axis
    # (both row-plan shapes): loss and gradient, and the rows step's launches.
    out["rows_step_check"] = {}
    seen = set()
    for key, (idxs, stacked, _, plan) in sorted(c4_row_groups().items()):
        if key[0] in seen:
            continue
        seen.add(key[0])
        stacked = {name: t.to(dev) for name, t in stacked.items()}
        group_targets = targets[torch.as_tensor(idxs, device=dev)]
        res = {}
        for label, tiling in (("rows", plan), ("gather", None)):
            step = fit.make_train_step(key, k_views, CaptureGrad(), run,
                                       True, "cuda", view_batch=True,
                                       warp_tiling=tiling)

            def call(step=step):
                return step(params, None, stacked, group_targets,
                            np.arange(k_views), np.zeros(k_views, np.int32))

            reset_counts()
            _, grad, loss = call()
            torch.cuda.synchronize()
            res[label] = (float(loss), grad, read_counts())
            if label == "rows" and not host.get("rows"):
                host_clock("rows", call)
        rel = abs(res["rows"][0] - res["gather"][0]) / res["gather"][0]
        scale = float(res["gather"][1].abs().max())
        gerr = float((res["rows"][1] - res["gather"][1]).abs().max())
        launched = {name: res["rows"][2][name] for name in (
            "warp_rows_fwd", "warp_rows_bwd", "sweep_fwd_views",
            "sweep_bwd_views")}
        log(f"[main] c4 step {key} ({plan.ty}x{plan.tx} tiles, f_v "
            f"{plan.f_v}) rows vs gather: loss {res['rows'][0]:.7f} vs "
            f"{res['gather'][0]:.7f} ({rel:.2e} relative, tol 1e-6); "
            f"gradient {gerr / scale:.3e} of max|grad| {scale:.3e} (tol "
            f"1e-5); rows step launches {launched}")
        check(rel <= 1e-6 and gerr <= 1e-5 * scale, f"c4 rows step {key}")
        check(launched == {"warp_rows_fwd": k_views, "warp_rows_bwd": k_views,
                           "sweep_fwd_views": 1, "sweep_bwd_views": 1}
              and res["gather"][2]["warp_rows_fwd"] == 0,
              f"c4 rows step {key} launches")
        out["rows_step_check"][f"axis{key[0]}"] = dict(
            loss_rel_err=rel, grad_err_of_max=gerr / scale,
            launches=launched)
    out["host"] = host
    del stacked, params, res, grad

    # evaluate_psnr over c4's 64 views through render_views_grouped, under
    # rows and with the gather, on the grid of the configured rows run.
    preds, walls, counts = {}, {}, {}
    for mode in ("rows", "gather"):
        warp_mode(mode)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        preds[mode] = fit.render_views_grouped(grid_rows, cams, run)
        torch.cuda.synchronize()
        walls[mode] = time.time() - t0
        counts[mode] = read_counts()
    warp_mode("rows")
    reset_counts()
    psnr_rows = fit.evaluate_psnr(grid_rows, cams, targets, run)
    torch.cuda.synchronize()
    psnr_counts = read_counts()
    warp_mode("gather")
    psnr_gather = float(psnr(preds["gather"], targets))
    err = float((preds["rows"] - preds["gather"]).abs().max())
    log(f"[main] c4 evaluate_psnr under rows over {len(cams)} views: "
        f"{psnr_rows:.4f} dB (gather render {psnr_gather:.4f} dB); images "
        f"rows vs gather max abs err {err:.3e} (tol 1e-5); "
        f"render_views_grouped wall {walls['rows']:.2f} s rows, "
        f"{walls['gather']:.2f} s gather; launches {psnr_counts}")
    check(preds["rows"].shape == targets.shape
          and bool(torch.isfinite(preds["rows"]).all()), "c4 rows render")
    check(err <= 1e-5 and np.isfinite(psnr_rows)
          and abs(psnr_rows - psnr_gather) <= 1e-3, "c4 rows render vs gather")
    check(psnr_counts["warp_rows_fwd"] == len(cams)
          and psnr_counts["warp_rows_bwd"] == 0
          and counts["rows"]["warp_rows_fwd"] == len(cams)
          and counts["gather"]["warp_rows_fwd"] == 0,
          "evaluate_psnr under rows did not warp every view through K7")
    out["psnr_rows"] = dict(psnr_db=psnr_rows, psnr_gather_db=psnr_gather,
                            max_abs_err_vs_gather=err, launches=psnr_counts,
                            wall_s=walls)
    del preds, grid_rows

    # Lit training with differentiable shadows, reduced to 128^3.
    lcfg, nl = lit_fit_setup()
    lcams = configs.cameras(c4, n=nl, res=nl, n_views=8)
    ltargets = fit.render_all_views(smoke_sphere(nl), lcams, run,
                                    lighting=lcfg)
    cfg = dataclasses.replace(c4["train"], steps=2, ckpt_every=0)
    reset_counts()
    grid, _, hist = fit.fit_grid(ltargets, lcams, (nl, nl, nl, 4), cfg, run,
                                 run_dir=f"{run_root}/lit", lighting=lcfg)
    torch.cuda.synchronize()
    counts = read_counts()
    by_size = {name: dict(c) for name, c in (
        ("tau_sweep", klight.launches), ("tau_adj", klight.adj_launches),
        ("tau_sweep_dirs", klight.directions),
        ("tau_adj_dirs", klight.adj_directions))}
    log(f"[main] lit fit {nl}^3, 16 directions, detach=False: "
        f"{hist['step_ms'][-1]:.2f} ms for the second step, loss "
        f"{hist['loss'][0]:.5f} -> {hist['loss'][-1]:.5f}, launches {counts}, "
        f"tau launches and directions by cluster size {by_size}")
    check(counts["tau_adj"] == cfg.steps
          and counts["tau_adj_dirs"] == cfg.steps * lcfg.n_samples
          and counts["tau_sweep"] >= cfg.steps
          and counts["tau_sweep_plane_loop"] == 0
          and counts["tau_adj_plane_loop"] == 0
          and counts["sweep_bwd"] + counts["sweep_bwd_views"] > 0,
          "lit fit: one tau_adj cluster launch a step (all directions) and "
          "the sweep kernels expected")
    check(bool(torch.isfinite(grid).all()), "lit fit grid")
    out["lit"] = dict(second_step_ms=hist["step_ms"][-1], launches=counts,
                      by_cluster_size=by_size, loss=hist["loss"])
    return out


def _timed_once(fn):
    """(result, ms) of one call, CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def dist_rank(steps, run_root, reps):
    """One rank of the dist phase, started by ``dist_phase`` through
    ``tpuvr_torch.dist.launch.spawn`` (which brought torch.distributed up
    and made this rank's card current). Every rank runs the same calls in
    the same order. Returns numbers only:

    - "fits": c4 through fit_grid on the data mesh, ``steps`` configured
      steps under each reduction of DIST_MODES, with this rank's launch and
      collective counts, reset just before each run and read just after;
    - "step": one mesh step of c4's first group from one state in each
      mode, its gradient against the bucketed one, and on rank 0 against
      the single-process step (the one ``training`` checks);
    - "b11": the ring backward over this rank's row tile of the c4
      minibatch against K6 in one call then one all-reduce and against its
      plain version; K6 alone, one all-reduce of the gradient alone, the
      ring, K6 then one all-reduce, and the plain ring, timed;
    - "grad": ``render_view_dp``'s gradient at the headline frame
      (``dpgrad_rank``);
    - "scaling": ``scaling_table``'s rows at the headline frame (one card,
      and on rank 0 the mesh's row), through ``workers.scaling_case``.
    """
    import torch.distributed as tdist

    from tpuvr_torch import configs
    from tpuvr_torch.dist import init as dinit
    from tpuvr_torch.dist.workers import CaptureGrad, row_tile, scaling_case
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import ring_bwd
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.train import fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = dinit.data_mesh()
    t0 = time.time()

    def reached(stage):
        # Progress on stderr, so that a rank that stops shows where.
        print(f"[dist] rank {mesh.rank} on {dev}: {stage} at "
              f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)

    c4 = configs.CONFIGS["c4"]
    run = c4["render"]
    n = c4["grid_n"]
    shape = (n, n, n, 4)
    cams = configs.cameras(c4)
    k_views = c4["train"].views_per_batch
    targets = fit.render_all_views(smoke_sphere(n, device=dev), cams, run)
    out = {"rank": mesh.rank, "device": str(dev), "fits": {}, "step": {}}
    reached("targets rendered")

    for mode, kw in DIST_MODES.items():
        cfg = dataclasses.replace(c4["train"], steps=steps, ckpt_every=0)
        tdist.barrier()
        reset_counts()
        grid, _, hist = fit.fit_grid(targets, cams, shape, cfg, run,
                                     mesh=mesh, run_dir=f"{run_root}/{mode}",
                                     fused=False, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        counts.update({f"collective_{k}": v
                       for k, v in dinit.collectives.items()})
        out["fits"][mode] = dict(
            loss=hist["loss"], step_ms=hist["step_ms"], launches=counts,
            finite=bool(torch.isfinite(grid).all()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del grid
        reached(f"fit_grid {mode}")

    groups = fit.group_views(cams, shape)
    key = sorted(groups)[0]
    idxs, stacked, _, _ = groups[key]
    stacked = {name: t.to(dev) for name, t in stacked.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    params = fit.init_params(shape, True, device=dev) + 0.3 * torch.randn(
        shape, generator=gen, device=dev)
    group_targets = targets[torch.as_tensor(idxs, device=dev)]
    res = {}
    for mode, kw in (("single", None), *DIST_MODES.items()):
        if kw is None and mesh.rank != 0:
            continue
        step = fit.make_train_step(
            key, k_views, CaptureGrad(), run, True, "cuda", view_batch=True,
            **({} if kw is None else dict(mesh=mesh, **kw)))
        _, grad, loss = step(params, None, stacked, group_targets,
                             np.arange(k_views), np.zeros(k_views, np.int32))
        res[mode] = (float(loss), grad)
    b_loss, b_grad = res["bucketed"]
    b_scale = float(b_grad.abs().max())
    for mode in DIST_MODES:
        loss, grad = res[mode]
        out["step"][mode] = dict(
            loss=loss, grad_sum=float(grad.double().sum()),
            err_of_max_vs_bucketed=float((grad - b_grad).abs().max())
            / b_scale)
        if "single" in res:
            s_loss, s_grad = res["single"]
            out["step"][mode].update(
                loss_rel_err_vs_single=abs(loss - s_loss) / s_loss,
                err_of_max_vs_single=float((grad - s_grad).abs().max())
                / float(s_grad.abs().max()))
    del res, grad, b_grad, params, stacked, group_targets, targets, groups
    reached("mesh steps")

    reverse, views, args = c4_minibatch(dev)
    tile, row0 = row_tile(args, views, mesh)
    del args
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest", views=views, row0=row0)
    ring_kw = dict(kw, mesh=mesh, ring_size=mesh.world,
                   ring_chunks=RING_CHUNKS)
    rgb, trans = ksweep.sweep_fwd(*tile, **kw)
    gen = torch.Generator(device=dev).manual_seed(2 + mesh.rank)
    bwd_args = (*tile, rgb, trans,
                torch.randn(rgb.shape, generator=gen, device=dev),
                torch.randn(trans.shape, generator=gen, device=dev))
    ref = kbwd.sweep_bwd(*bwd_args, **kw)
    dinit.all_reduce(ref, mesh)
    got = ring_bwd.sweep_bwd_ring(*bwd_args, **ring_kw)
    tdist.barrier()
    plain, plain_ms = _timed_once(
        lambda: ring_bwd.sweep_bwd_ring_torch(*bwd_args, **ring_kw))
    scale = float(ref.abs().max())
    b11 = dict(scale=scale, max_abs_err=float((got - ref).abs().max()),
               plain_err=float((got - plain).abs().max()), plain_ms=plain_ms,
               grad_sum=float(got.double().sum()))
    del got, plain
    zeros = torch.zeros_like(ref)

    def k6():
        return kbwd.sweep_bwd(*bwd_args, **kw)

    for name, fn in (
            ("k6_ms", k6),
            ("all_reduce_ms", lambda: dinit.all_reduce(zeros, mesh)),
            ("ring_ms", lambda: ring_bwd.sweep_bwd_ring(*bwd_args,
                                                        **ring_kw)),
            ("library_ms", lambda: dinit.all_reduce(k6(), mesh))):
        tdist.barrier()
        b11[name] = cuda_ms(fn, reps)
    b11["k6_bytes_ms"], b11["k6_ops_ms"] = sweep_bwd_bound(tile, row0)
    b11["grad_bytes"] = ref.numel() * 4
    b11["shape"] = (f"c4 minibatch row tile: {views} views x "
                    f"{tile[3].shape[0] // views}x{tile[3].shape[1]} rays, "
                    f"grid {tuple(tile[0].shape)}, {RING_CHUNKS} slabs")
    out["b11"] = b11
    reached("ring backward")
    del bwd_args, ref, zeros, tile, rgb, trans

    out["grad"] = dpgrad_rank(mesh, reps)
    reached("render_view_dp gradient")

    # The scaling table at the headline frame: render_view on each rank's
    # card, then render_view_dp over the mesh; rank 0 writes both rows.
    head = configs.CONFIGS["headline"]
    grid = smoke_sphere(head["grid_n"], device=dev).cpu().numpy()
    tdist.barrier()
    out["scaling"] = scaling_case(
        mesh, device=dev, grid=grid, cam=configs.camera(head),
        cfg=head["render"], min_wall=SCALING_MIN_WALL)
    reached("scaling table")
    return out


def dpgrad_rank(mesh, reps):
    """One rank's gradient check of ``render_view_dp`` at the headline
    frame (256^3 @ 512^2, ERT 1e-4), every rank calling it in the same
    order, at the frame's 'default' tier and at 'highest': one counted
    forward+backward over the mesh (``counted_grad``, the roundoff over the
    mesh), its largest difference from this rank's own one-card
    ``render_view`` gradient, the gradient's sum (equal on every rank),
    and ms per forward+backward on the mesh and on one card (CUDA
    events)."""
    import torch.distributed as tdist

    from tpuvr_torch import configs
    from tpuvr_torch.dist import workers
    from tpuvr_torch.dist.replicated import render_view_dp
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import render

    head = configs.CONFIGS["headline"]
    cam = configs.camera(head)
    grid = smoke_sphere(head["grid_n"],
                        device=torch.device("cuda",
                                            torch.cuda.current_device()))
    out = {}
    for prec in ("default", "highest"):
        cfg = dataclasses.replace(head["render"], precision=prec)

        def one_card(x, cfg=cfg):
            return render.render_view(x, cam, cfg)

        def on_mesh(x, cfg=cfg):
            return render_view_dp(x, cam, mesh, cfg)

        _, _, s_loss, ref, _ = workers.render_grad(one_card, grid, mesh)
        loss, grad, launches, roundoff = counted_grad(on_mesh, grid, mesh)
        res = dict(loss=loss, one_card_loss=float(s_loss),
                   scale=float(ref.abs().max()),
                   err=float((grad - ref).abs().max()), roundoff=roundoff,
                   grad_sum=float(grad.double().sum()), launches=launches)
        del grad, ref
        for name, fn in (("ms", on_mesh), ("one_card_ms", one_card)):
            tdist.barrier()
            res[name] = cuda_ms(fwd_bwd(fn, grid), reps)
        out[prec] = res
    return out


def dist_phase(steps=3):
    """The data-parallel path on DIST_RANKS ranks (see ``dist_rank``):
    starts them, checks every rank's results, and returns the summary and
    the ring backward's kernel entry."""
    from tpuvr_torch.dist import launch

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= DIST_RANKS else "gloo"
    world = DIST_RANKS
    layout = (f"{world} ranks, one a card, over NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}"
              if backend == "nccl"
              else f"{world} ranks sharing card 0 over gloo (time-sliced: "
              f"NCCL refuses two ranks on one card; these times say nothing "
              f"of {world} cards)")
    log(f"[dist] c4 on a data mesh: {layout}")
    reps = 10 if backend == "nccl" else 2
    torch.cuda.empty_cache()
    run_root = tempfile.mkdtemp(prefix=".chip_smoke_dist_",
                                dir=Path(__file__).resolve().parent)
    t0 = time.time()
    try:
        ranks = launch.spawn(dist_rank, world, backend, "cuda",
                             (steps, run_root, reps), timeout_s=600)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    seconds = time.time() - t0
    check([r["rank"] for r in ranks] == list(range(world)), "dist ranks")
    summary = {"transport": backend, "ranks": world,
               "cards": min(n_cards, world), "layout": layout,
               "steps": steps, "fits": {}}
    for mode, kw in DIST_MODES.items():
        fits = [r["fits"][mode] for r in ranks]
        loss = fits[0]["loss"]
        check(all(f["loss"] == loss for f in fits),
              f"dist {mode}: the ranks' losses differ")
        check(len(loss) == steps and all(np.isfinite(loss))
              and all(f["finite"] for f in fits), f"dist {mode} losses")
        check(loss[-1] < loss[0], f"dist {mode}: the loss did not fall")
        slabs = kw.get("bwd_chunks", 1)
        # Per step: K5 once, K6 once a slab, the ring once in ring mode;
        # all-reduces: the tiles' gather and one a bucket or slab. Two
        # broadcasts: rank 0's start step and its starting parameters.
        want = {"sweep_fwd_views": steps, "sweep_bwd_views": slabs * steps,
                "sweep_bwd_ring": steps if kw.get("grad_ring") else 0,
                "sweep_fwd": 0, "sweep_bwd": 0,
                "collective_all_reduce": (1 + max(slabs, kw.get(
                    "grad_buckets", 1))) * steps,
                "collective_broadcast": 2}
        for f in fits:
            got = {k: f["launches"].get(k, 0) for k in want}
            check(got == want, f"dist {mode} rank launches {got}, expected "
                  f"{want}")
        ms = [float(np.mean(f["step_ms"][1:])) for f in fits]
        summary["fits"][mode] = dict(
            loss_first=loss[0], loss_last=loss[-1], ms_per_step=ms[0],
            ms_per_step_by_rank=ms, first_step_ms=fits[0]["step_ms"][0],
            launches=fits[0]["launches"],
            peak_gib=max(f["peak_gib"] for f in fits))
        log(f"[dist] c4 {mode} {kw} ({steps} steps, {layout.split(' (')[0]})"
            f": {ms[0]:.3f} ms/step after the first on rank 0 (ranks "
            f"{', '.join(f'{m:.3f}' for m in ms)}), loss {loss[0]:.5f} -> "
            f"{loss[-1]:.5f}, rank 0 launches {fits[0]['launches']}")

    s0 = ranks[0]["step"]
    for mode in DIST_MODES:
        check(len({r["step"][mode]["grad_sum"] for r in ranks}) == 1,
              f"dist step {mode}: the ranks' gradients differ")
        st = s0[mode]
        log(f"[dist] c4 step {mode} vs single-process: loss {st['loss']:.7f} "
            f"({st['loss_rel_err_vs_single']:.2e} relative, tol 1e-6), "
            f"gradient {st['err_of_max_vs_single']:.3e} of max|grad| (tol "
            f"1e-5); vs bucketed {st['err_of_max_vs_bucketed']:.3e} (tol "
            "1e-6)")
        check(st["loss_rel_err_vs_single"] <= 1e-6
              and st["err_of_max_vs_single"] <= 1e-5,
              f"dist step {mode} vs the single-process step")
        for r in ranks:
            check(r["step"][mode]["err_of_max_vs_bucketed"] <= 1e-6,
                  f"dist step {mode} vs bucketed on rank {r['rank']}")
    summary["step"] = s0

    b = [r["b11"] for r in ranks]
    for r in b:
        check(r["max_abs_err"] <= 1e-5 * r["scale"]
              and r["plain_err"] <= GRAD_TOL["highest"] * r["scale"],
              "ring backward vs K6 and one all-reduce, or vs plain")
    check(len({r["grad_sum"] for r in b}) == 1,
          "ring backward: the ranks' gradients differ")
    t = {k: max(r[k] for r in b) for k in (
        "k6_ms", "all_reduce_ms", "ring_ms", "library_ms", "plain_ms")}
    hidden = ((t["k6_ms"] + t["all_reduce_ms"] - t["ring_ms"])
              / min(t["k6_ms"], t["all_reduce_ms"]))
    b0 = b[0]
    if backend == "nccl":
        # Each rank's K6, and the all-reduce's bytes over NVLink: every rank
        # sends and receives 2 (n - 1) / n of the gradient.
        bytes_ms = max(b0["k6_bytes_ms"], 2 * (world - 1) / world
                       * b0["grad_bytes"] / NVLINK_BYTES_PER_S * 1e3)
        ops_ms = b0["k6_ops_ms"]
        bound_note = (f"max of one rank's K6 bound and 2(n-1)/n of the "
                      f"gradient over NVLink at {NVLINK_BYTES_PER_S:.3g} B/s")
    else:
        # One card does every rank's K6 and the reduction in its memory:
        # each rank's gradient read and the sum written once a rank.
        bytes_ms = (world * b0["k6_bytes_ms"]
                    + 2 * world * b0["grad_bytes"] / HBM_BYTES_PER_S * 1e3)
        ops_ms = world * b0["k6_ops_ms"]
        bound_note = ("one card doing all 4 ranks' K6 and their reduction "
                      "in device memory")
    ring_fit = [r["fits"]["ring"]["launches"]["sweep_bwd_ring"]
                for r in ranks]
    entry = {
        "name": "sweep_bwd_ring", "route": "cuda",
        "source": "tpuvr_torch/kernels/ring_bwd.py",
        "kernel_source": "tpuvr_torch/csrc/sweep_bwd.cu",
        "replaces": "tpuvr/kernels/ring_bwd.py:183",
        "launches": ring_fit[0], "launches_by_rank": ring_fit,
        "max_abs_err": max(r["max_abs_err"] for r in b),
        "err_of_max": max(r["max_abs_err"] / r["scale"] for r in b),
        "plain_err_of_max": max(r["plain_err"] / r["scale"] for r in b),
        "ms": t["ring_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_note": bound_note,
        "library_ms": t["library_ms"],
        "library_call": f"K6 in one call, then one {backend} all_reduce of "
                        "the gradient, in sequence",
        "k6_ms": t["k6_ms"], "all_reduce_ms": t["all_reduce_ms"],
        "hidden_share": hidden, "transport": backend, "ranks": world,
        "cards": min(n_cards, world), "ring_chunks": RING_CHUNKS,
        "times": "slowest rank, CUDA events",
        "shape": b0["shape"],
    }
    log(f"[dist] ring backward ({b0['shape']}, {backend}): "
        f"{entry['err_of_max']:.3e} of max|grad| against K6 + one "
        f"all-reduce (tol 1e-5), plain {entry['plain_err_of_max']:.3e} "
        f"(tol 1e-5); ring {t['ring_ms']:.4f} ms, K6 alone "
        f"{t['k6_ms']:.4f} ms, all-reduce alone {t['all_reduce_ms']:.4f} ms, "
        f"K6 then all-reduce {t['library_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.1f} ms; hidden share {hidden:.3f}; bound "
        f"{entry['bound_ms']:.4f} ms ({bound_note})")
    summary["b11"] = {k: v for k, v in entry.items() if k != "name"}

    card = card_name_and_limit()
    summary["grad"] = {}
    for prec, tol in (("default", GRAD_TOL["default"]),
                      ("highest", 1e-5)):
        gs = [r["grad"][prec] for r in ranks]
        check(len({g["grad_sum"] for g in gs}) == 1,
              f"dist render_view_dp grad {prec}: the ranks' gradients "
              "differ")
        # K1 and K3 once (a rank's 128 rows are one row chunk); the tiles'
        # gather and the grid gradient's sum: two all-reduces.
        want = {"sweep_fwd": 1, "sweep_bwd": 1, "collective_all_reduce": 2,
                **{k: 0 for k in (
                    "sweep_fwd_views", "sweep_bwd_views", "tau_sweep",
                    "tau_adj", "warp_rows_fwd", "warp_rows_bwd",
                    "sweep_bwd_ring", "collective_broadcast",
                    "collective_all_to_all", "collective_all_gather",
                    "collective_reduce_scatter", "collective_exchange")}}
        for g in gs:
            got = {k: g["launches"].get(k, 0) for k in want}
            check(got == want, f"dist render_view_dp grad {prec}: launches "
                  f"{got}, expected {want}")
            check(g["err"] <= tol * g["scale"] + g["roundoff"],
                  f"dist render_view_dp grad {prec}: {g['err']:.3e} from "
                  f"the one-card gradient (tol {tol:g} of {g['scale']:.4g} "
                  f"+ {g['roundoff']:.3e})")
            check(abs(g["loss"] - g["one_card_loss"])
                  <= 1e-6 * g["one_card_loss"],
                  f"dist render_view_dp grad {prec}: loss {g['loss']} "
                  f"against one card's {g['one_card_loss']}")
        g0 = gs[0]
        by_rank = ", ".join(f"{g['ms']:.3f}" for g in gs)
        summary["grad"][prec] = dict(
            err_of_max=max(g["err"] / g["scale"] for g in gs),
            roundoff_of_max=max(g["roundoff"] / g["scale"] for g in gs),
            ms_per_fwd_bwd=g0["ms"], ms_by_rank=[g["ms"] for g in gs],
            one_card_ms=g0["one_card_ms"], launches=g0["launches"],
            loss=g0["loss"])
        log(f"[dist] render_view_dp gradient at the headline frame "
            f"({prec}, eps 1e-4): "
            f"{summary['grad'][prec]['err_of_max']:.3e} of max|grad| from "
            f"the one-card render_view gradient (tol {tol:g} + roundoff "
            f"{summary['grad'][prec]['roundoff_of_max']:.3e}); "
            f"{g0['ms']:.3f} ms a forward+backward over {world} ranks on "
            f"rank 0 (ranks {by_rank}), one card {g0['one_card_ms']:.3f} "
            f"({layout.split(' (')[0]}; "
            f"{card}); rank 0 launches and collectives {g0['launches']}")

    rows = [r["scaling"] for r in ranks]
    one, mesh_row = rows[0][0], rows[0][-1]
    check([r["devices"] for r in rows[0]] == [1, world]
          and all(len(r) == 1 for r in rows[1:]),
          f"dist scaling rows {rows}")
    check(all(r[0] == one for r in rows),
          "dist scaling: the ranks' one-card rows differ")
    for row in rows[0]:
        check(row["ms_per_frame"] > 0.0 and 0.0 < row["efficiency"] <= 1.05,
              f"dist scaling row {row}")
    summary["scaling"] = dict(rows=rows[0], layout=layout.split(" (")[0],
                              min_wall_s=SCALING_MIN_WALL)
    log(f"[dist] scaling table at the headline frame ({layout.split(' (')[0]}"
        f"): one card {one['ms_per_frame']:.5f} ms/frame "
        f"({one['rays_per_s']:.5g} rays/s), {world} ranks "
        f"{mesh_row['ms_per_frame']:.5f} ms/frame "
        f"({mesh_row['rays_per_s']:.5g} rays/s), efficiency "
        f"{mesh_row['efficiency']:.5f}")
    summary["seconds"] = seconds
    log(f"[dist] phase done in {seconds:.1f} s")
    return summary, entry, [r["fits"] for r in ranks]


def zshard_scene():
    """The z phase's inputs, the same in the parent and on every rank: the
    512^3 smoke sphere's shape, the top-down 1024^2 render camera, the two
    top-down 256^2 fit cameras (``tools/zsharded_512.py``'s shape), and
    the render config (eps 0, 'highest')."""
    from tpuvr_torch.config import RenderConfig
    from tpuvr_torch.io.synth import orbit_cameras

    n = ZSHARD_GRID
    return dict(
        n=n, shape=(n, n, n, 4),
        cam=orbit_cameras(8, n, res=1024, elevation_deg=75.0)[0],
        cams=orbit_cameras(8, n, res=256, elevation_deg=75.0)[:2],
        run=RenderConfig(early_stop_eps=0.0, precision="highest"))


def zshard_fit_cfg(branch):
    """The z fit's TrainConfig for ``branch`` ("retile": every row;
    "band": ZSHARD_BAND_RAYS rays a view)."""
    from tpuvr_torch.config import TrainConfig

    return TrainConfig(lr=1e-2, steps=ZSHARD_STEPS, views_per_batch=2,
                       ckpt_every=0, seed=0,
                       rays_per_view=(ZSHARD_BAND_RAYS if branch == "band"
                                      else None))


def zshard_step_inputs(sc, branch, dev):
    """(key, stacked geometry on ``dev``, rows, r0s) of the fit's one view
    group for the first-step gradient, both views, the band at rows
    [64, 64 + rows) of each."""
    from tpuvr_torch.train import fit

    (key, (_, stacked, _, _)), = fit.group_views(sc["cams"],
                                                 sc["shape"]).items()
    n_v, n_u = stacked["dt"].shape[1:]
    rows = (fit.band_rows(ZSHARD_BAND_RAYS, n_v, n_u, ZSHARD_FIT[0])
            if branch == "band" else None)
    r0s = np.full(2, 64 if rows else 0, np.int32)
    return key, {k: t.to(dev) for k, t in stacked.items()}, rows, r0s


def zslab_kernels(grid, sc):
    """K1 and K3 at the shapes the z renders give them, on the card, each
    against its plain version on the same inputs: every rank's slab of the
    ZSHARD_RENDER mesh (128 slices, every 1024 rows) and of the ZSHARD_FIT
    mesh (256 slices, rows from 0 or 512), taken by
    ``sharded_grid.slab_inputs`` on a mesh made by hand (no collective),
    eps 0, 'highest', seeded cotangents; K1 and K3 timed (CUDA events) with
    their bounds. Returns {"<layout> rank <r>": numbers}."""
    from tpuvr_torch.dist.init import DataMesh, GridMesh
    from tpuvr_torch.dist.sharded_grid import slab_inputs
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.kernels.sweep_torch import (
        sweep_bwd_torch,
        sweep_fwd_torch,
    )

    run = sc["run"]
    gen = torch.Generator(device=grid.device).manual_seed(3)
    out = {}
    for n_data, n_z in (ZSHARD_RENDER, ZSHARD_FIT):
        for rank in range(n_data * n_z):
            i, d = divmod(rank, n_z)
            hand = GridMesh(n_data, n_z, rank, data=DataMesh(None, i, n_data),
                            z=DataMesh(None, d, n_z),
                            flat=DataMesh(None, rank, n_data * n_z))
            _, _, args, row0 = slab_inputs(grid, sc["cam"], hand, run,
                                           grid.device)
            kw = dict(reverse=False, sigma_scale=run.sigma_scale,
                      early_stop_eps=0.0, precision=run.precision, row0=row0)
            rgb, t = ksweep.sweep_fwd(*args, **kw)
            p_rgb, p_t = sweep_fwd_torch(*args, **kw)
            d_rgb = torch.randn(rgb.shape, generator=gen, device=grid.device)
            d_t = torch.randn(t.shape, generator=gen, device=grid.device)
            k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
            p = sweep_bwd_torch(*args, rgb, t, d_rgb, d_t, **kw)
            torch.cuda.synchronize()
            fwd_err = max_err((rgb, t), (p_rgb, p_t))
            scale = float(p.abs().max())
            bwd_err = float((k - p).abs().max())
            label = f"{n_data}x{n_z} rank {rank}"
            check(fwd_err <= 1e-5 and all(bool(torch.isfinite(x).all())
                                          for x in (rgb, t)),
                  f"sweep_fwd z slab {label}: {fwd_err:.3e} (tol 1e-5)")
            check(scale > 0 and bwd_err <= GRAD_TOL[run.precision] * scale
                  and bool(torch.isfinite(k).all()),
                  f"sweep_bwd z slab {label}: {bwd_err:.3e} of "
                  f"{scale:.3e}")
            res = dict(shape=f"S={args[0].shape[0]} V,U="
                             f"{tuple(args[3].shape)} row0={row0}",
                       fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
                       bwd_err_of_max=bwd_err / scale)
            if rank in (0, n_data * n_z - 1):  # timed at two ranks a mesh
                res.update(
                    fwd_ms=cuda_ms(lambda: ksweep.sweep_fwd(*args, **kw), 3),
                    bwd_ms=cuda_ms(lambda: kbwd.sweep_bwd(
                        *args, rgb, t, d_rgb, d_t, **kw), 3),
                    fwd_bound=sweep_fwd_bound(args, row0),
                    bwd_bound=sweep_bwd_bound(args, row0))
            out[label] = res
            log(f"[zshard] K1/K3 at the z slab {label} ({res['shape']}, "
                f"{run.precision}, eps 0): K1 {fwd_err:.3e} from plain (tol "
                f"1e-5), K3 {bwd_err / scale:.3e} of max|grad| (tol "
                f"{GRAD_TOL[run.precision]:g})" + (
                    f"; K1 {res['fwd_ms']:.4f} ms (bound "
                    f"{max(res['fwd_bound']):.4f}), K3 {res['bwd_ms']:.4f} ms "
                    f"(bound {max(res['bwd_bound']):.4f})"
                    if "fwd_ms" in res else ""))
            del args, rgb, t, p_rgb, p_t, d_rgb, d_t, k, p
    return out


def counted_grad(render, grid, sum_mesh):
    """One forward+backward of ``workers.image_loss`` through ``render``
    with respect to the whole ``grid`` (``workers.render_grad``), every
    rank calling it in the same order: (loss, gradient, this rank's
    launches and collectives in it (reset just before), the roundoff bound
    of the gradient's sum over ``sum_mesh``: 3 * 2^-24 * max sum_r |g_r|,
    from one all-reduce after the counted run, 0 on a mesh of one rank)."""
    import torch.distributed as tdist

    from tpuvr_torch.dist import init as dinit
    from tpuvr_torch.dist import workers

    tdist.barrier()
    reset_counts()
    _, _, loss, grad, partial = workers.render_grad(render, grid, sum_mesh)
    torch.cuda.synchronize()
    launches = read_counts()
    launches.update({f"collective_{k}": v
                     for k, v in dinit.collectives.items()})
    roundoff = 0.0
    if sum_mesh.world > 1:
        part = partial.abs()
        dinit.all_reduce(part, sum_mesh)
        roundoff = 3 * 2.0**-24 * float(part.max())
    return float(loss), grad, launches, roundoff


def fwd_bwd(render, grid):
    """A function running one forward+backward of ``workers.image_loss``
    through ``render`` with respect to ``grid``."""
    from tpuvr_torch.dist import workers

    g = grid.detach().requires_grad_(True)
    return lambda: torch.autograd.grad(workers.image_loss(*render(g)), g)


def zgrad_rank(grid, zmesh, render, refs, reps):
    """One rank's gradient check of a z render (``workers.zrender``) at the
    z phase's frame, every rank calling it in the same order: one counted
    forward+backward (``counted_grad``, the roundoff over ``'data'``) and
    the rank's peak memory in it; its slab's largest difference from the
    parent's single-card gradient (the quarters of ``refs["zgrad"]``, read
    from disk) and the largest |grad| outside the slab; ms per
    forward+backward (CUDA events) and device time by kernel."""
    import torch.distributed as tdist

    from tpuvr_torch.ops.geometry import plan_sweep

    sc = zshard_scene()
    plan, _ = plan_sweep(sc["cam"], sc["shape"], 2)
    sz = plan.n_planes // zmesh.shape["z"]
    d = zmesh.z.rank
    lo = plan.n_planes - (d + 1) * sz if plan.reverse else d * sz
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss, grad, launches, roundoff = counted_grad(render, grid, zmesh.data)
    peak = torch.cuda.max_memory_allocated() / 2**30
    q = sc["n"] // len(refs["zgrad"])
    ref = torch.cat([torch.load(path, mmap=True, weights_only=True)
                     for path in refs["zgrad"][lo // q:(lo + sz) // q]])
    err = float((grad[lo:lo + sz] - ref.to(grad.device)).abs().max())
    outside = max([float(grad[a:b].abs().max())
                   for a, b in ((0, lo), (lo + sz, sc["n"])) if b > a],
                  default=0.0)
    del grad, ref
    step = fwd_bwd(render, grid)
    tdist.barrier()
    ms = cuda_ms(step, reps)
    tdist.barrier()
    dev_ms, top, _ = device_ms(step, 1)
    return dict(loss=loss, err=err, outside=outside, roundoff=roundoff,
                slab=[lo, sz], launches=launches, ms=ms, device_ms=dev_ms,
                top=top, peak_gib=peak)


def zshard_rank(refs, run_root, reps):
    """One rank of the zshard phase, started by ``zshard_phase``. Every rank
    runs the same calls in the same order. Returns numbers only:

    - "render": on the ZSHARD_RENDER mesh, the 512^3 @ 1024^2 frame in each
      fold (the ring and the gathered fold of ``render_view_zsharded``,
      ``render_view_retiled``): its error against the parent's single-card
      render, SHA-256 of rgb, this rank's launches and collectives of one
      frame, and ms/frame (CUDA events);
    - "grad": after each fold's frame, one forward+backward of
      ``workers.image_loss`` with respect to the whole grid (``zgrad_rank``),
      and the retile's on the ZSHARD_FIT mesh ("retile_2x2"), each against
      the parent's single-card gradient of the same loss;
    - "fit": on the ZSHARD_FIT mesh, per branch, the first step's slab
      gradient from the initial state against the parent's single-card
      one, then ``fit_grid`` for ZSHARD_STEPS steps with this rank's
      launches and collectives (reset just before, read just after), its
      losses, ms/step and peak memory; after the band fit, the retile loss
      of its slab at the first step's views.
    """
    import torch.distributed as tdist

    from tpuvr_torch.dist import init as dinit
    from tpuvr_torch.dist.workers import CaptureGrad, zrender
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.train import fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rmesh = dinit.grid_mesh(*ZSHARD_RENDER)
    fmesh = dinit.grid_mesh(*ZSHARD_FIT)
    sc = zshard_scene()
    t0 = time.time()

    def reached(stage):
        print(f"[zshard] rank {rmesh.rank} on {dev}: {stage} at "
              f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)

    def counts():
        got = read_counts()
        got.update({f"collective_{k}": v
                    for k, v in dinit.collectives.items()})
        return got

    out = {"rank": rmesh.rank, "device": str(dev), "render": {}, "grad": {},
           "fit": {}}
    grid = smoke_sphere(sc["n"], device=dev)
    ref_rgb = torch.as_tensor(refs["rgb"], device=dev)
    ref_t = torch.as_tensor(refs["t"], device=dev)
    scale = float(ref_rgb.abs().max())
    for name in ("all_gather", "ring", "retile"):
        render = zrender(rmesh, sc["cam"], sc["run"], name, dev)

        def frame():
            return render(grid)

        tdist.barrier()
        reset_counts()
        rgb, t = frame()
        torch.cuda.synchronize()
        one = counts()
        tdist.barrier()
        ms = cuda_ms(frame, reps)
        tdist.barrier()
        dev_ms, top, _ = device_ms(frame, 1)
        out["render"][name] = dict(
            err_of_max=max(float((rgb - ref_rgb).abs().max()),
                           float((t - ref_t).abs().max())) / scale,
            finite=bool(torch.isfinite(rgb).all() and torch.isfinite(t).all()),
            digest=digest(rgb), ms=ms, launches=one, device_ms=dev_ms,
            top=top)
        del rgb, t
        reached(f"render {name}")
        out["grad"][name] = zgrad_rank(grid, rmesh, render, refs, reps)
        reached(f"grad {name}")
    out["grad"]["retile_2x2"] = zgrad_rank(
        grid, fmesh, zrender(fmesh, sc["cam"], sc["run"], "retile", dev),
        refs, reps)
    reached("grad retile_2x2")
    del grid, ref_rgb, ref_t
    torch.cuda.empty_cache()

    targets = torch.as_tensor(refs["targets"], device=dev)
    d = fmesh.z.rank
    sz = sc["n"] // fmesh.shape["z"]
    for branch in ("retile", "band"):
        key, stacked, rows, r0s = zshard_step_inputs(sc, branch, dev)
        step = fit.make_train_step_zsharded(key, 2, CaptureGrad(), sc["run"],
                                            True, "cuda", fmesh, rows=rows)
        slab = fit.init_params((sz, *sc["shape"][1:]), True, device=dev)
        tdist.barrier()
        _, grad, loss = step(slab, None, stacked, targets, np.arange(2), r0s)
        ref = torch.load(refs["grads"][branch][d], mmap=True,
                         weights_only=True)
        err = float((grad - ref.to(dev)).abs().max())
        del grad, ref
        tdist.barrier()
        step_dev, step_top, _ = device_ms(
            lambda: step(slab, None, stacked, targets, np.arange(2), r0s), 1)
        del slab
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tdist.barrier()
        reset_counts()
        _, params, hist = fit.fit_grid(
            targets, sc["cams"], sc["shape"],
            zshard_fit_cfg(branch), sc["run"], mesh=fmesh,
            run_dir=f"{run_root}/{branch}")
        torch.cuda.synchronize()
        res = dict(first_loss=float(loss), grad_err=err, loss=hist["loss"],
                   step_device_ms=step_dev, step_top=step_top,
                   step_ms=hist["step_ms"], launches=counts(),
                   finite=bool(torch.isfinite(params).all()),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if branch == "band":
            key, stacked, _, _ = zshard_step_inputs(sc, "retile", dev)
            after = fit.make_train_step_zsharded(key, 2, CaptureGrad(),
                                                 sc["run"], True, "cuda",
                                                 fmesh)
            res["retile_loss_after"] = float(after(
                params, None, stacked, targets, np.arange(2),
                np.zeros(2, np.int32))[2])
        out["fit"][branch] = res
        del params
        torch.cuda.empty_cache()
        reached(f"fit {branch}")
    return out


def zshard_phase():
    """The z-sharded grid at 512^3 (ROADMAP A1) on ZSHARD_RANKS ranks (see
    ``zshard_rank``): the parent renders the single-card references (the
    frame; the fit's targets; each branch's first-step gradient, saved
    slab by slab in a scratch directory of the checkout and freed before
    the ranks start), starts the ranks, and checks every rank's results.
    Returns the summary and the z path's launches by kernel row."""
    from tpuvr_torch.dist import launch
    from tpuvr_torch.dist.workers import CaptureGrad, image_loss
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis
    from tpuvr_torch.train import fit

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= ZSHARD_RANKS else "gloo"
    world = ZSHARD_RANKS
    layout = (f"{world} ranks, one a card, over NCCL"
              if backend == "nccl"
              else f"{world} ranks sharing card 0 over gloo (time-sliced: "
              f"NCCL refuses two ranks on one card; these times say nothing "
              f"of {world} cards)")
    log(f"[zshard] 512^3 z-sharded grid: {layout}")
    card = card_name_and_limit()
    sc = zshard_scene()
    dev = torch.device("cuda")
    run_root = tempfile.mkdtemp(prefix=".chip_smoke_zshard_",
                                dir=Path(__file__).resolve().parent)
    t0 = time.time()
    try:
        grid = smoke_sphere(sc["n"], device=dev)
        rgb, t = render.render_view(grid, sc["cam"], sc["run"])
        targets = fit.render_all_views(grid, sc["cams"], sc["run"])
        refs = {"rgb": rgb.cpu().numpy(), "t": t.cpu().numpy(),
                "targets": targets.cpu().numpy(), "grads": {}}
        del rgb, t
        # The z renders' gradient reference: the single-card render_view
        # gradient of image_loss at the frame, saved in quarters of Z (the
        # sweep axis), and its forward+backward ms.
        check(dominant_axis(sc["cam"]) == 2, "the z frame must sweep z")
        g = grid.requires_grad_(True)

        def fwd_bwd():
            return torch.autograd.grad(image_loss(*render.render_view(
                g, sc["cam"], sc["run"])), g)

        rgb, t = render.render_view(g, sc["cam"], sc["run"])
        loss = image_loss(rgb, t)
        (zgrad,) = torch.autograd.grad(loss, g)
        del rgb, t
        zref = dict(loss=float(loss.detach()),
                    scale=float(zgrad.abs().max()),
                    ms=cuda_ms(fwd_bwd, 3))
        q = sc["n"] // ZSHARD_RENDER[1]
        refs["zgrad"] = []
        for k in range(ZSHARD_RENDER[1]):
            refs["zgrad"].append(f"{run_root}/zgrad_q{k}.pt")
            torch.save(zgrad[k * q:(k + 1) * q].cpu(), refs["zgrad"][-1])
        del g, zgrad, loss
        grid = grid.detach()
        slab_kernels = zslab_kernels(grid, sc)
        del grid
        ref_steps = {}
        sz = sc["n"] // ZSHARD_FIT[1]
        for branch in ("retile", "band"):
            key, stacked, rows, r0s = zshard_step_inputs(sc, branch, dev)
            step = fit.make_train_step(key, 2, CaptureGrad(), sc["run"],
                                       True, "cuda", rows=rows)
            _, grad, loss = step(fit.init_params(sc["shape"], True),
                                 None, stacked, targets, np.arange(2), r0s)
            paths = []
            for d in range(ZSHARD_FIT[1]):
                paths.append(f"{run_root}/grad_{branch}_z{d}.pt")
                torch.save(grad[d * sz:(d + 1) * sz].cpu(), paths[-1])
            refs["grads"][branch] = paths
            ref_steps[branch] = dict(loss=float(loss), rows=rows,
                                     scale=float(grad.abs().max()))
            del grad, stacked
        del targets
        torch.cuda.empty_cache()
        ref_s = time.time() - t0
        log(f"[zshard] single-card references in {ref_s:.1f} s: "
            f"{ref_steps}; render_view gradient of sum(rgb^2) + sum(T): "
            f"loss {zref['loss']:.7g}, max|grad| {zref['scale']:.6g}, "
            f"{zref['ms']:.3f} ms a forward+backward ({card})")
        ranks = launch.spawn(zshard_rank, world, backend, "cuda",
                             (refs, run_root, 3), timeout_s=600)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    seconds = time.time() - t0
    check([r["rank"] for r in ranks] == list(range(world)), "zshard ranks")
    summary = {"transport": backend, "ranks": world,
               "cards": min(n_cards, world), "layout": layout, "card": card,
               "render_mesh": ZSHARD_RENDER, "fit_mesh": ZSHARD_FIT,
               "grid": sc["n"], "references_s": ref_s, "render": {},
               "grad": {"single_card": zref}, "slab_kernels": slab_kernels,
               "fit": {}}
    n_z = ZSHARD_RENDER[1]
    # One frame a rank: K1 once over its slab; the fold's collectives, and
    # the tiles' gather (one all-reduce).
    frame_want = {"all_gather": {"collective_all_gather": 1},
                  "ring": {"collective_exchange": n_z - 1},
                  "retile": {"collective_all_to_all": 1}}
    zero = ("sweep_bwd", "sweep_fwd_views", "sweep_bwd_views", "tau_sweep",
            "tau_adj", "warp_rows_fwd", "warp_rows_bwd", "sweep_bwd_ring")
    no_collective = {f"collective_{k}": 0 for k in (
        "all_reduce", "broadcast", "all_to_all", "all_gather",
        "reduce_scatter", "exchange")}
    digests = {}
    for fold, extra in frame_want.items():
        rs = [r["render"][fold] for r in ranks]
        want = {**no_collective, "sweep_fwd": 1, "collective_all_reduce": 1,
                **extra, **{k: 0 for k in zero}}
        for r in rs:
            got = {k: r["launches"].get(k, 0) for k in want}
            check(got == want, f"zshard render {fold}: launches {got}, "
                  f"expected {want}")
            check(r["finite"] and r["err_of_max"] <= 1e-5,
                  f"zshard render {fold}: {r['err_of_max']:.3e} of max|rgb| "
                  "against the single-card render (tol 1e-5)")
        check(len({r["digest"] for r in rs}) == 1,
              f"zshard render {fold}: the ranks' images differ")
        digests[fold] = rs[0]["digest"]
        summary["render"][fold] = dict(
            ms_per_frame=rs[0]["ms"], ms_by_rank=[r["ms"] for r in rs],
            err_of_max=max(r["err_of_max"] for r in rs),
            device_ms=rs[0]["device_ms"], top=rs[0]["top"],
            launches=rs[0]["launches"], digest=rs[0]["digest"])
        by_rank = ", ".join(f"{r['ms']:.3f}" for r in rs)
        log(f"[zshard] render 512^3 @ 1024^2 {ZSHARD_RENDER} {fold}: "
            f"{rs[0]['ms']:.3f} ms/frame on rank 0 (ranks {by_rank}), "
            f"{summary['render'][fold]['err_of_max']:.3e} of max|rgb| vs "
            f"the single-card render (tol 1e-5); rank 0 device time "
            f"{rs[0]['device_ms']} ms a frame, by kernel {rs[0]['top']}; "
            f"rank 0 launches and collectives a frame {rs[0]['launches']}")
    summary["render_digests_equal"] = len(set(digests.values())) == 1
    # One forward+backward a rank: K1 and K3 once over its slab; the fold's
    # forward collectives and their transposes (the gathered fold's
    # all_gather and one reduce-scatter, the ring's n_z - 1 exchanges each
    # way, the retile's all_to_all each way); the tiles' gather (one
    # all-reduce, none back); and the slab's all-reduce over 'data' where
    # n_data > 1 (the ZSHARD_FIT mesh).
    grad_want = {
        "all_gather": {"collective_all_gather": 1,
                       "collective_reduce_scatter": 1},
        "ring": {"collective_exchange": 2 * (n_z - 1)},
        "retile": {"collective_all_to_all": 2},
        "retile_2x2": {"collective_all_to_all": 2,
                       "collective_all_reduce": 2}}
    for fold, extra in grad_want.items():
        rs = [r["grad"][fold] for r in ranks]
        zmesh_shape = ZSHARD_FIT if fold == "retile_2x2" else ZSHARD_RENDER
        want = {**no_collective, "collective_all_reduce": 1, **extra,
                **{k: 0 for k in zero}, "sweep_fwd": 1, "sweep_bwd": 1}
        for r in rs:
            got = {k: r["launches"].get(k, 0) for k in want}
            check(got == want, f"zshard grad {fold}: launches {got}, "
                  f"expected {want}")
            check(r["err"] <= 1e-5 * zref["scale"] + r["roundoff"],
                  f"zshard grad {fold}: slab {r['slab']} off the "
                  f"single-card gradient by {r['err']:.3e} (tol 1e-5 of "
                  f"{zref['scale']:.4g} + {r['roundoff']:.3e})")
            check(r["outside"] == 0.0,
                  f"zshard grad {fold}: {r['outside']:.3e} outside the slab")
            check(abs(r["loss"] - zref["loss"]) <= 1e-5 * zref["loss"],
                  f"zshard grad {fold}: loss {r['loss']} against the "
                  f"single card's {zref['loss']}")
        summary["grad"][fold] = dict(
            mesh=zmesh_shape, ms_per_fwd_bwd=rs[0]["ms"],
            ms_by_rank=[r["ms"] for r in rs],
            err_of_max=max(r["err"] for r in rs) / zref["scale"],
            roundoff_of_max=max(r["roundoff"] for r in rs) / zref["scale"],
            device_ms=rs[0]["device_ms"], top=rs[0]["top"],
            launches=rs[0]["launches"],
            peak_gib_by_rank=[r["peak_gib"] for r in rs])
        gs = summary["grad"][fold]
        log(f"[zshard] grad 512^3 @ 1024^2 {zmesh_shape} "
            f"{fold.removesuffix('_2x2')}: {gs['ms_per_fwd_bwd']:.3f} ms a "
            f"forward+backward on rank 0 (ranks "
            f"{', '.join(f'{m:.3f}' for m in gs['ms_by_rank'])}; one card "
            f"{zref['ms']:.3f}; {card}), slab gradient "
            f"{gs['err_of_max']:.3e} of max|grad| vs the single card (tol "
            f"1e-5 + roundoff {gs['roundoff_of_max']:.3e}), zeros outside; "
            f"rank 0 device time {gs['device_ms']} ms, by kernel "
            f"{gs['top']}; peak GiB by rank "
            f"{', '.join(f'{x:.2f}' for x in gs['peak_gib_by_rank'])}; rank "
            f"0 launches and collectives {gs['launches']}")
    n_data, nz_fit = ZSHARD_FIT
    for branch, ref in ref_steps.items():
        fs = [r["fit"][branch] for r in ranks]
        loss = fs[0]["loss"]
        check(all(f["loss"] == loss for f in fs),
              f"zshard fit {branch}: the ranks' losses differ")
        check(len(loss) == ZSHARD_STEPS and all(np.isfinite(loss))
              and all(f["finite"] for f in fs), f"zshard fit {branch} losses")
        if branch == "retile":
            fell = loss[-1] < loss[0]
        else:  # each band step draws its rows: judge the whole images
            after = fs[0]["retile_loss_after"]
            check(all(f["retile_loss_after"] == after for f in fs),
                  "zshard band: the ranks' evaluations differ")
            fell = after < ranks[0]["fit"]["retile"]["first_loss"]
        check(fell, f"zshard fit {branch}: the loss did not fall")
        err = max(f["grad_err"] for f in fs) / ref["scale"]
        check(err <= 1e-5, f"zshard fit {branch}: first-step gradient "
              f"{err:.3e} of max|grad| from the single-card step (tol 1e-5)")
        loss_err = max(abs(f["first_loss"] - ref["loss"]) for f in fs)
        check(loss_err <= 1e-6 * ref["loss"],
              f"zshard fit {branch}: first-step loss off by {loss_err:.3e}")
        steps, views = ZSHARD_STEPS, 2
        buckets = 4  # fit_grid's grad_buckets default
        if branch == "retile":
            per_step = {"collective_all_to_all": 2 * views,
                        "collective_exchange": 2 * views,
                        "collective_all_reduce": 1 + buckets}
        else:
            per_step = {"collective_all_gather": 2 * views,
                        "collective_all_reduce": buckets}
        want = {"sweep_fwd": views * steps, "sweep_bwd": views * steps,
                "collective_broadcast": 2,
                **{k: v * steps for k, v in per_step.items()},
                **{k: 0 for k in zero if k != "sweep_bwd"}}
        for f in fs:
            got = {k: f["launches"].get(k, 0) for k in want}
            check(got == want, f"zshard fit {branch}: launches {got}, "
                  f"expected {want}")
        ms = [float(np.mean(f["step_ms"][1:])) for f in fs]
        summary["fit"][branch] = dict(
            rows=ref["rows"], loss=loss, ms_per_step=ms[0],
            ms_per_step_by_rank=ms, first_step_ms=fs[0]["step_ms"][0],
            grad_err_of_max=err, first_loss=fs[0]["first_loss"],
            single_card_loss=ref["loss"],
            step_device_ms=fs[0]["step_device_ms"], step_top=fs[0]["step_top"],
            peak_gib_by_rank=[f["peak_gib"] for f in fs],
            launches=fs[0]["launches"],
            **({"retile_loss_after": fs[0]["retile_loss_after"]}
               if branch == "band" else {}))
        by_rank = ", ".join(f"{m:.1f}" for m in ms)
        peaks = ", ".join(f"{f['peak_gib']:.2f}" for f in fs)
        trail = " -> ".join(f"{x:.6f}" for x in loss)
        log(f"[zshard] fit 512^3, 2 views at 256^2, {ZSHARD_FIT} {branch} "
            f"(rows {ref['rows'] or 'all'}, {steps} steps): {ms[0]:.1f} "
            f"ms/step after the first on rank 0 (ranks {by_rank}), loss "
            f"{trail}"
            + (f", whole-image loss {fs[0]['retile_loss_after']:.6f} after "
               f"(from {ranks[0]['fit']['retile']['first_loss']:.6f})"
               if branch == "band" else "")
            + f"; rank 0 device time {fs[0]['step_device_ms']} ms a step, "
            f"by kernel {fs[0]['step_top']}"
            + f"; first-step gradient {err:.3e} of max|grad| vs the "
            f"single-card step (tol 1e-5); peak GiB by rank {peaks}; rank 0 "
            f"launches and collectives {fs[0]['launches']}")
    summary["seconds"] = seconds
    log(f"[zshard] phase done in {seconds:.1f} s")
    launches = {
        name: {"zshard_render": sum(
            summary["render"][f]["launches"][name] for f in frame_want),
            "zshard_grad": sum(summary["grad"][f]["launches"][name]
                               for f in grad_want),
            **{f"zshard_fit_{b}": summary["fit"][b]["launches"][name]
               for b in ref_steps}}
        for name in ("sweep_fwd", "sweep_bwd")}
    return summary, launches


def c5_setup():
    """c5's scene and ``tools/c5_train.py``'s training settings, the same in
    the parent and on every rank: the config, the grid shape, c5's camera,
    the tool's C5_VIEWS orbit cameras at 1024^2, its lighting (16 sky
    directions, detached), the tool's render config (ERT 1e-4, 'default')
    for the targets and the fit, c5's render at eps 0 ('highest') for the
    gradient checks, and the tool's TrainConfig."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import RenderConfig, TrainConfig
    from tpuvr_torch.io.synth import orbit_cameras

    c5 = configs.CONFIGS["c5"]
    n = c5["grid_n"]
    return dict(
        cfg=c5, n=n, shape=(n, n, n, 4), cam=configs.camera(c5),
        cams=orbit_cameras(C5_VIEWS, n, res=c5["res"]),
        lighting=c5["lighting"],
        fit_run=RenderConfig(early_stop_eps=1e-4, precision="default"),
        exact=dataclasses.replace(c5["render"], early_stop_eps=0.0),
        train=TrainConfig(lr=3e-2, steps=C5_STEPS, views_per_batch=1,
                          ckpt_every=0, density_softplus=False,
                          steps_per_call=2, seed=0))


@contextlib.contextmanager
def plain_versions():
    """Route the render entry points' sweep (``render_prepared``'s op) and
    the light bake (``ops.lighting``'s batched tau sweeps and the lit
    grid's assembly, detached or not) to their plain PyTorch versions for
    CUDA tensors too: the reference a frame or a step through the kernels
    is held against. The train step takes ``impl="torch"`` itself."""
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ops import render

    names = ("tau_sweep_dirs", "tau_sweep_adj_dirs", "light_apply",
             "light_apply_fwd", "shadow_cotangents", "mask_sum")
    twins = (klight.tau_sweep_dirs_torch, klight.tau_sweep_adj_dirs_torch,
             kla.light_apply_torch, kla.light_apply_torch,
             kla.shadow_cotangents_torch, kla.mask_sum_torch)
    saved = render.resolve_impl, [getattr(olight, n) for n in names]
    render.resolve_impl = lambda impl, t: "torch"
    for name, twin in zip(names, twins):
        setattr(olight, name, twin)
    try:
        yield
    finally:
        render.resolve_impl = saved[0]
        for name, fn in zip(names, saved[1]):
            setattr(olight, name, fn)


def f32_ulps(a, b):
    """Largest distance in f32 units in the last place between two float32
    tensors (signed zeros equal): 0 for the same bits."""
    def key(t):
        i = (t + 0.0).contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


def light_apply_c5(grid, lcfg):
    """K9 and K10 (``kernels.light_apply``) at c5's size, the 512^3 grid
    and its 16 directions, against the ATen passes of their twin
    (``light_apply_torch``): the lit grid and L, and the grid gradient for
    a contiguous cotangent and for one in each sweep axis's layout, as ulp
    distances (0: the same bits, the kernels' contract); CUDA-event times
    of both, and the kernels' byte bounds. Returns the numbers."""
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ref.march import GRID_PERM

    table = olight.direction_table(lcfg)
    axes = [row[0] for row in table]
    scale = lcfg.sky_intensity / lcfg.n_samples
    vox = grid[..., 0].numel()
    out = dict(shape=f"{tuple(grid.shape)} smoke_sphere, {len(table)} "
                     f"directions over sweep axes {sorted(set(axes))}, "
                     "highest",
               fwd_bytes_ms=(len(table) + 9) * 4 * vox / HBM_BYTES_PER_S
               * 1e3,
               fwd_no_l_bytes_ms=(len(table) + 8) * 4 * vox
               / HBM_BYTES_PER_S * 1e3,
               bwd_bytes_ms=9 * 4 * vox / HBM_BYTES_PER_S * 1e3)
    with torch.no_grad():
        taus = olight._TauDirs.apply(grid[..., 0], table, "highest")
        lit, ell = kla._forward(grid, taus, axes, scale, True)
        ref_ell = kla.light_value_torch(taus, axes, scale)
        out["fwd_ulps"] = max(f32_ulps(ell, ref_ell), f32_ulps(
            lit, kla.lit_grid_torch(grid, ref_ell)))
        out["l_range"] = [float(ell.min()), float(ell.max())]
        del lit, ref_ell
        out["fwd_ms"] = cuda_ms(
            lambda: kla._forward(grid, taus, axes, scale, True), 10)
        out["fwd_no_l_ms"] = cuda_ms(
            lambda: kla._forward(grid, taus, axes, scale, False), 10)
        out["fwd_plain_ms"] = cuda_ms(
            lambda: kla.light_apply_torch(grid, taus, axes, scale), 2)
    del taus
    torch.cuda.empty_cache()
    gen = torch.Generator(device=grid.device).manual_seed(9)
    out.update(bwd_ulps=0, bwd_ms_by_layout={}, bwd_plain_ms_by_layout={})
    for layout in ("contiguous", 0, 1, 2):
        if layout == "contiguous":
            g = torch.randn(grid.shape, generator=gen, device=grid.device)
        else:  # a view of a gradient in the sweep layout (S, 4, Ny, Nx)
            p = [grid.shape[i] for i in GRID_PERM[layout][:3]]
            g = torch.randn((p[0], 4, p[1], p[2]), generator=gen,
                            device=grid.device).permute(0, 2, 3, 1).permute(
                tuple(int(i) for i in np.argsort(GRID_PERM[layout])))
        leaf = grid.detach().requires_grad_(True)

        def plain():
            return torch.autograd.grad(kla.lit_grid_torch(leaf, ell), leaf,
                                       g)[0]

        out["bwd_ulps"] = max(out["bwd_ulps"],
                              f32_ulps(kla._backward(g, ell), plain()))
        out["bwd_ms_by_layout"][str(layout)] = cuda_ms(
            lambda: kla._backward(g, ell), 10)
        out["bwd_plain_ms_by_layout"][str(layout)] = cuda_ms(plain, 2)
        del g, leaf
        torch.cuda.empty_cache()
    out["bwd_ms"] = max(out["bwd_ms_by_layout"].values())
    out["bwd_plain_ms"] = max(out["bwd_plain_ms_by_layout"].values())
    del ell
    log(f"[c5] K9/K10 ({out['shape']}) against the ATen passes: K9 "
        f"{out['fwd_ulps']} ulps, {out['fwd_ms']:.4f} ms "
        f"({out['fwd_no_l_ms']:.4f} without L; plain {out['fwd_plain_ms']:.2f}; bound "
        f"{out['fwd_bytes_ms']:.4f} ms, bytes), K10 {out['bwd_ulps']} ulps, "
        f"{out['bwd_ms']:.4f} ms at the slowest cotangent layout "
        f"({out['bwd_ms_by_layout']}; plain {out['bwd_plain_ms']:.2f}; "
        f"bound {out['bwd_bytes_ms']:.4f} ms, bytes)")
    check(out["fwd_ulps"] == 0 and out["bwd_ulps"] == 0,
          f"c5 K9/K10 against the ATen passes: {out['fwd_ulps']} and "
          f"{out['bwd_ulps']} ulps")
    return out


def light_apply_entries(c5):
    """The ``kernels`` summary's rows of K9 and K10, from ``c5_phase``."""
    la = c5["light_apply"]
    rows = []
    for d, ms, ms_no_l in (("fwd", la["fwd_ms"], la["fwd_no_l_ms"]),
                           ("bwd", la["bwd_ms"], None)):
        rows.append({
            "name": f"light_apply_{d}", "route": "cuda",
            "source": "tpuvr_torch/csrc/light_apply.cu",
            "replaces": "none: XLA fuses the light volume's sum and the "
                        "emission multiply into one loop",
            "launches": c5["fit"]["launches"][f"light_apply_{d}"],
            "launches_by_path": {
                "c5_fit": c5["fit"]["launches"][f"light_apply_{d}"],
                "c5_mesh": c5["mesh"]["fit_counts"].get(
                    f"light_apply_{d}", 0)},
            "max_ulps": la[f"{d}_ulps"],
            "ms": ms,
            **({"ms_without_l": ms_no_l,
                "bound_ms_without_l": la["fwd_no_l_bytes_ms"]}
               if d == "fwd" else
               {"ms_by_cotangent_layout": la["bwd_ms_by_layout"]}),
            "plain_ms": la[f"{d}_plain_ms"],
            "bound_ms": la[f"{d}_bytes_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": la["shape"],
        })
    return rows


def c5_one_card(scene_dir):
    """c5 on one card, and the mesh ranks' inputs: (a) the lit targets of
    the tool's views (``render_views_grouped``), saved to ``scene_dir``;
    (b) the c5 lit frame through ``render_view`` at eps 0 and at c5's eps
    1e-4 against the same frame through the plain versions, the 16-direction
    512^3 bake (one K2 launch, clusters of 16) against the plain bake, timed,
    with ``prepare_grid``'s peak memory, and the first fit step's gradient
    at eps 0 ('highest') against the same step through the plain versions
    (saved to ``scene_dir`` for the ranks); (c) ``fit_grid`` for C5_STEPS
    steps with the tool's settings: losses, ms/step, one step's device time
    and host issue time, peak memory, launches by kernel; (d) the lit
    viewer of ``tools/run_judged.py``'s c5 command: the lit frame with its
    bake and alone on a prepared grid at 'default' and 'highest', the bake
    alone, a lit forward+backward (detached light); (e) the same step and
    fit with the light not detached (:func:`c5_shadow`). Returns the
    numbers."""
    from tpuvr_torch.dist.workers import CaptureGrad, fog_params
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ops import render
    from tpuvr_torch.ref.camera import dominant_axis
    from tpuvr_torch.ref.march import GRID_PERM
    from tpuvr_torch.train import fit

    st = c5_setup()
    dev = torch.device("cuda")
    c5, cam, lcfg = st["cfg"], st["cam"], st["lighting"]
    rays = cam.res_x * cam.res_y
    out = {}
    grid = smoke_sphere(st["n"], device=dev)
    axis = dominant_axis(cam)

    # (a) The lit targets.
    torch.cuda.synchronize()
    t0 = time.time()
    targets = fit.render_views_grouped(grid, st["cams"], st["fit_run"],
                                       lighting=lcfg)
    torch.cuda.synchronize()
    out["targets_s"] = time.time() - t0
    check(targets.shape == (C5_VIEWS, c5["res"], c5["res"], 3)
          and bool(torch.isfinite(targets).all())
          and float(targets.max()) > 0.0, "c5 targets")
    np.save(f"{scene_dir}/targets.npy", targets.cpu().numpy())
    log(f"[c5] lit targets: {C5_VIEWS} views at {c5['res']}^2 of "
        f"smoke_sphere({st['n']}) in {out['targets_s']:.2f} s")

    # (b) The lit frame, kernels against plain, at eps 0 and c5's eps.
    cmax = float(grid[..., 1:].abs().max())
    out["frame_check"] = {}
    for eps in (0.0, c5["render"].early_stop_eps):
        run = dataclasses.replace(c5["render"], early_stop_eps=eps)
        reset_counts()
        rgb, t = render.render_view(grid, cam, run, lighting=lcfg)
        torch.cuda.synchronize()
        k_counts = read_counts()
        with plain_versions():
            reset_counts()
            t0 = time.time()
            ref = render.render_view(grid, cam, run, lighting=lcfg)
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            p_counts = read_counts()
        scale = float(ref[0].abs().max())
        err = max_err((rgb, t), ref)
        # eps 0: f32 roundoff; eps > 0: the kernel stops each ray at its
        # own T < eps, the plain version at the slice's maximum T, so
        # |d rgb| <= eps * max|c| (the lit emission is at most the grid's,
        # L <= 1) and |d T| <= eps.
        tol = 1e-5 * scale + eps * max(cmax, 1.0)
        out["frame_check"][f"eps_{eps:g}"] = dict(
            max_abs_err=err, tol=tol, max_rgb=scale, launches=k_counts,
            plain_s=plain_s)
        log(f"[c5] lit frame {st['n']}^3 @ {cam.res_x}^2 eps {eps:g} "
            f"{run.precision}: kernels vs plain max abs err {err:.3e} (tol "
            f"{tol:.3e}, max|rgb| {scale:.4f}); kernel launches {k_counts}; "
            f"plain frame {plain_s:.2f} s")
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(t).all())
              and scale > 0.0 and err <= tol, f"c5 lit frame eps {eps}")
        check(k_counts["sweep_fwd"] > 0 and k_counts["tau_sweep"] == 1
              and k_counts["tau_sweep_dirs"] == lcfg.n_samples
              and k_counts["light_apply_fwd"] == 1
              and k_counts["light_apply_bwd"] == 0
              and k_counts["light_apply_fallback"] == 0
              and not any(p_counts.values()),
              f"c5 lit frame eps {eps}: kernels {k_counts}, plain "
              f"{p_counts}")
        del rgb, t, ref

    # The whole 512^3 bake: K2 against its plain version, timed.
    sigma = grid[..., 0].contiguous()
    table = olight.direction_table(lcfg)
    fields = {a: sigma.permute(GRID_PERM[a][:3]).contiguous()
              for a in sorted({row[0] for row in table})}
    rows = [(fields[a], flip, d_y, d_x, dt)
            for a, flip, d_y, d_x, dt in table]
    before = (klight.launches.copy(), klight.directions.copy())
    taus = klight.tau_sweep_dirs(rows)
    torch.cuda.synchronize()
    route = (dict(klight.launches - before[0]),
             dict(klight.directions - before[1]))
    ref = klight.tau_sweep_dirs_torch(rows)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(taus, ref))
    del taus, ref
    bytes_ms, ops_ms = tau_bound(list(fields.values()), len(rows))
    bake = dict(
        max_abs_err=err, scale=scale, clusters=route[0],
        directions=route[1],
        ms=cuda_ms(lambda: klight.tau_sweep_dirs(rows), 3),
        device_ms=device_ms(lambda: klight.tau_sweep_dirs(rows), 2)[0],
        plain_ms=cuda_ms(lambda: klight.tau_sweep_dirs_torch(rows), 1,
                         warmup=0),
        bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        shape=f"{tuple(sigma.shape)}, {len(rows)} directions over "
              f"{len(fields)} sweep axes, highest")
    del rows, fields, sigma
    reset_counts()
    for _ in range(2):  # the second is the one kept: allocator warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prep = render.prepare_grid(grid, axes=(axis,), lighting=lcfg,
                                   precision=c5["render"].precision)
        torch.cuda.synchronize()
        bake["prepare_grid_wall_ms"] = (time.perf_counter() - t0) * 1e3
        bake["prepare_grid_peak_gib"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        del prep
    bake["prepare_grid_launches"] = read_counts()
    out["bake"] = bake
    log(f"[c5] bake 512^3 ({bake['shape']}): K2 clusters {route[0]}, "
        f"directions {route[1]}, max abs err {err:.3e} of max {scale:.3f} "
        f"(tol 1e-5 of max); {bake['ms']:.4f} ms events, device "
        f"{bake['device_ms']} ms, plain {bake['plain_ms']:.1f} ms, bound "
        f"{bake['bound_ms']:.4f} ms ({bake['bound_by']}); prepare_grid "
        f"(bake and lit grid) {bake['prepare_grid_wall_ms']:.2f} ms wall, "
        f"peak {bake['prepare_grid_peak_gib']:.3f} GiB above the grid")
    check(err <= 1e-5 * scale and route == ({16: 1}, {16: lcfg.n_samples}),
          f"c5 bake: error {err:.3e}, launches {route}")
    p_launches = bake["prepare_grid_launches"]
    check(p_launches["light_apply_fwd"] == 2
          and p_launches["light_apply_bwd"] == 0
          and p_launches["light_apply_fallback"] == 0,
          f"c5 prepare_grid twice: launches {p_launches}")
    out["light_apply"] = light_apply_c5(grid, lcfg)

    # The first fit step's gradient from the fog at eps 0, 'highest'.
    groups = fit.group_views(st["cams"], st["shape"])
    key, (idxs, stacked, _, _) = sorted(groups.items())[0]
    stacked = {k: v.to(dev) for k, v in stacked.items()}
    g_targets = targets[torch.as_tensor(idxs, device=dev)]
    fog = fog_params(st["shape"], dev)
    pick, r0s = np.zeros(1, int), np.zeros(1, np.int32)
    res = {}
    for label, impl in (("kernels", "cuda"), ("plain", "torch")):
        step = fit.make_train_step(key, 1, CaptureGrad(), st["exact"],
                                   False, impl, lighting=lcfg)
        with plain_versions() if impl == "torch" else contextlib.nullcontext():
            reset_counts()
            _, grad, loss = step(fog, None, stacked, g_targets, pick, r0s)
            torch.cuda.synchronize()
            counts = read_counts()
        res[label] = (float(loss), grad, counts)
        if impl == "cuda":
            torch.save(grad.cpu(), f"{scene_dir}/grad.pt")
    (k_loss, k_grad, k_counts), (p_loss, p_grad, p_counts) = (
        res["kernels"], res["plain"])
    scale = float(p_grad.abs().max())
    gerr = float((k_grad - p_grad).abs().max())
    rel = abs(k_loss - p_loss) / p_loss
    out["step_check"] = dict(loss=k_loss, plain_loss=p_loss,
                             loss_rel_err=rel, grad_err_of_max=gerr / scale,
                             max_grad=scale, launches=k_counts, view=idxs[0],
                             group=str(key))
    log(f"[c5] first step (view {idxs[0]}, group {key}, eps 0, highest) "
        f"kernels vs plain: loss {k_loss:.7f} vs {p_loss:.7f} ({rel:.2e} "
        f"relative, tol 1e-6); gradient {gerr / scale:.3e} of max|grad| "
        f"{scale:.3e} (tol 1e-5); kernel launches {k_counts}")
    check(rel <= 1e-6 and gerr <= 1e-5 * scale, "c5 step vs plain")
    check(k_counts["sweep_fwd"] == 1 and k_counts["sweep_bwd"] == 1
          and k_counts["tau_sweep"] == 1 and k_counts["tau_adj"] == 0
          and k_counts["light_apply_fwd"] == 1
          and k_counts["light_apply_bwd"] == 1
          and k_counts["light_apply_fallback"] == 0
          and not any(p_counts.values()),
          f"c5 step: kernels {k_counts}, plain {p_counts}")
    del res, k_grad, p_grad, grad

    # K1 and K3 on that step's sweep inputs (the lit fog in the view's
    # sweep layout, all 1024 rows in one call) at the fit's tier and eps,
    # timed against their plain versions, with their bounds.
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd
    from tpuvr_torch.kernels.sweep_torch import (
        sweep_bwd_torch,
        sweep_fwd_torch,
    )
    from tpuvr_torch.ops.lighting import apply_lighting

    run = st["fit_run"]
    with torch.no_grad():
        grid_sc = render.grid_to_sweep_layout(
            apply_lighting(fog, lcfg, run.precision), key[0])
        args = (grid_sc, tuple(stacked["coeffs"][0]),
                render.slice_enables(grid_sc, key[1], run.use_occupancy)
                * stacked["valid"][0], stacked["dt"][0].contiguous())
    kw = dict(reverse=key[1], sigma_scale=run.sigma_scale,
              early_stop_eps=run.early_stop_eps, precision=run.precision)
    rgb, t = ksweep.sweep_fwd(*args, **kw)
    gen = torch.Generator(device=dev).manual_seed(5)
    bwd_args = (*args, rgb, t, torch.randn(rgb.shape, generator=gen,
                                           device=dev),
                torch.randn(t.shape, generator=gen, device=dev))
    p_out = sweep_fwd_torch(*args, **kw)
    k1_err = max_err((rgb, t), p_out)
    k3 = kbwd.sweep_bwd(*bwd_args, **kw)
    p3 = sweep_bwd_torch(*bwd_args, **kw)
    k3_err = float((k3 - p3).abs().max()) / float(p3.abs().max())
    del k3, p3, p_out
    sweeps = dict(
        k1_ms=cuda_ms(lambda: ksweep.sweep_fwd(*args, **kw), 5),
        k3_ms=cuda_ms(lambda: kbwd.sweep_bwd(*bwd_args, **kw), 3),
        k1_plain_ms=cuda_ms(lambda: sweep_fwd_torch(*args, **kw), 1,
                            warmup=0),
        k3_plain_ms=cuda_ms(lambda: sweep_bwd_torch(*bwd_args, **kw), 1,
                            warmup=0),
        k1_max_abs_err=k1_err, k3_err_of_max=k3_err,
        rays_terminated=int((t < run.early_stop_eps).sum()),
        shape=f"lit fog {tuple(grid_sc.shape)}, rays "
              f"{tuple(args[3].shape)}, {run.precision}, eps "
              f"{run.early_stop_eps:g}")
    for name, bound_fn in (("k1", sweep_fwd_bound), ("k3", sweep_bwd_bound)):
        b, o = bound_fn(args)
        sweeps.update({f"{name}_bytes_ms": b, f"{name}_ops_ms": o,
                       f"{name}_bound_ms": max(b, o),
                       f"{name}_bound_by": "bytes" if b >= o
                       else "operations"})
    out["sweeps"] = sweeps
    log(f"[c5] K1/K3 at the step's inputs ({sweeps['shape']}): K1 "
        f"{sweeps['k1_ms']:.4f} ms (plain {sweeps['k1_plain_ms']:.1f}, "
        f"bound {sweeps['k1_bound_ms']:.4f} {sweeps['k1_bound_by']}), K3 "
        f"{sweeps['k3_ms']:.4f} ms (plain {sweeps['k3_plain_ms']:.1f}, "
        f"bound {sweeps['k3_bound_ms']:.4f} {sweeps['k3_bound_by']}); K1 vs "
        f"plain max abs err {k1_err:.3e} (tol 1e-5), K3 vs plain "
        f"{k3_err:.3e} of max|grad|; rays stopped {sweeps['rays_terminated']}")
    check(k1_err <= 1e-5 + run.early_stop_eps * max(cmax, 1.0),
          "c5 K1 at the step's inputs vs plain")
    del grid_sc, args, bwd_args, rgb, t

    # (c) The fit on one card.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    t0 = time.time()
    _, params, hist = fit.fit_grid(targets, st["cams"], st["shape"],
                                   st["train"], st["fit_run"],
                                   run_dir=f"{scene_dir}/one", lighting=lcfg,
                                   params_init=fog)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    by_size = {"tau_sweep": dict(klight.launches),
               "tau_sweep_dirs": dict(klight.directions)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = hist["loss"]
    ms = float(np.mean(hist["step_ms"][1:]))
    finite = bool(torch.isfinite(params).all())
    del params
    steps = st["train"].steps
    log(f"[c5] fit {st['n']}^3, {C5_VIEWS} lit views at {c5['res']}^2, "
        f"{steps} steps (one view a step, 2 a view group, lr "
        f"{st['train'].lr}, raw density from the fog, "
        f"{st['fit_run'].precision} eps {st['fit_run'].early_stop_eps:g}): "
        f"{ms:.3f} ms/step "
        f"after the first ({hist['step_ms'][0]:.1f} ms), loss "
        + " -> ".join(f"{x:.6f}" for x in loss)
        + f"; peak {peak:.2f} GiB ({held:.2f} held before the fit: the "
        f"grid, the fog, the targets); launches {counts}; tau launches and "
        f"directions by cluster size {by_size}; fit_grid wall {wall:.2f} s")
    check(len(loss) == steps and all(np.isfinite(loss)) and finite,
          "c5 fit losses")
    check(loss[1] < loss[0] and loss[3] < loss[2] and loss[-1] < loss[0],
          f"c5 fit: the loss did not fall within each view's steps {loss}")
    check(counts["sweep_fwd"] == steps and counts["sweep_bwd"] == steps
          and counts["tau_sweep"] == steps and counts["tau_adj"] == 0
          and counts["sweep_fwd_views"] == 0
          and counts["light_apply_fwd"] == steps
          and counts["light_apply_bwd"] == steps
          and counts["light_apply_fallback"] == 0
          and by_size == {"tau_sweep": {16: steps},
                          "tau_sweep_dirs": {16: steps * lcfg.n_samples}},
          f"c5 fit launches {counts}, {by_size}")

    # One step's device time (the profiler) and host issue time (from an
    # idle card, median of 3), as c4's are measured.
    opt = fit.Adam(st["train"].lr)
    state = opt.init(fog)
    step = fit.make_train_step(key, 1, opt, st["fit_run"], False, None,
                               lighting=lcfg)

    def one_step():
        return step(fog, state, stacked, g_targets, pick, r0s)

    dev_ms, top, ops = device_ms(one_step, 1, n_top=12)
    issue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    del state, step
    out["fit"] = dict(
        loss=loss, step_ms=hist["step_ms"], ms_per_step=ms, peak_gib=peak,
        held_gib=held,
        launches=counts, by_cluster_size=by_size, wall_s=wall,
        device_ms_per_step=dev_ms, device_top=top, host_ops_per_step=ops,
        device_busy=None if dev_ms is None else dev_ms / ms,
        host_issue_ms=float(np.median(issue)))
    log(f"[c5] fit step device time: " + (
        "not measured (the profiler saw no device activity)"
        if dev_ms is None else f"{dev_ms:.3f} ms, busy {dev_ms / ms:.3f} "
        "of the step; by kernel " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in top))
        + f"; host clock to issue a step {out['fit']['host_issue_ms']:.3f} "
        f"ms; {ops:.0f} top-level ATen ops")

    # (d) The lit viewer (tools/run_judged.py's c5 command), CUDA events.
    from tpuvr_torch.config import RenderConfig

    viewer = {}
    for prec in ("default", "highest"):
        run = RenderConfig(early_stop_eps=1e-4, precision=prec)
        viewer[f"lit_frame_ms_{prec}"] = cuda_ms(
            lambda: render.render_view(grid, cam, run, lighting=lcfg), 3)
        prep = render.prepare_grid(grid, axes=(axis,), lighting=lcfg,
                                   precision=prec)
        viewer[f"frame_ms_{prec}"] = cuda_ms(
            lambda: render.render_prepared(prep, cam, run), 10)
        del prep
    viewer["lit_frame_device_ms_default"] = device_ms(
        lambda: render.render_view(grid, cam, RenderConfig(
            early_stop_eps=1e-4, precision="default"), lighting=lcfg), 2)[0]
    viewer["bake_ms_default"] = cuda_ms(
        lambda: olight.light_volume(grid[..., 0], lcfg, "default"), 3)
    run = RenderConfig(early_stop_eps=1e-4, precision="default")

    def fwd_bwd():
        g = grid.detach().requires_grad_(True)
        prep = render.prepare_grid(g, axes=(axis,), lighting=lcfg,
                                   precision="default")
        rgb, _ = render.render_prepared(prep, cam, run)
        return torch.autograd.grad(torch.mean((rgb - 0.25) ** 2), g)[0]

    viewer["lit_fwd_bwd_ms_default"] = cuda_ms(fwd_bwd, 3)
    for k in [k for k in viewer if k.startswith(("lit_frame_ms", "frame_ms",
                                                 "lit_fwd_bwd"))]:
        viewer[k.replace("_ms", "_rays_per_s")] = rays / viewer[k] * 1e3
    out["viewer"] = viewer
    log("[c5] lit viewer (events, ms): " + ", ".join(
        f"{k} {v:.4f}" if "rays" not in k else f"{k} {v:.4g}"
        for k, v in viewer.items() if v is not None))

    # (e) The c5-shadow fit: the same step and fit, the light not detached.
    out["shadow"] = c5_shadow(st, grid, fog, key, stacked, g_targets,
                              targets, f"{scene_dir}/shadow")
    del grid, targets, fog, stacked, g_targets
    torch.cuda.empty_cache()
    return out


def c5_shadow(st, grid, fog, key, stacked, g_targets, targets, run_dir):
    """The c5-shadow fit (c5 with ``lighting.detach`` false: the density's
    gradient flows through the 16 directions' transmittance) on one card.
    (a) The first step from the fog at eps 0 ('highest') through the
    kernels against the same step through the plain versions: loss 1e-6
    relative, gradient 1e-5 of max|grad|, as the detached step. The
    kernels' step launches K1, K3, K2, K9, K11, K4 and K12 once each (K2
    and K4 one cluster launch of size 16 over the 16 directions), no K10
    and no fallback to the ATen passes, with one ``light_shadow`` bake and
    one adjoint; the plain step launches nothing. (b) ``fit_grid`` for
    C5_STEPS steps with the tool's settings: K2, K9, K11, K4 and K12 once a
    step (K2 and K4 in clusters of 16, 16 directions each), no K10 and no
    fallback, one shadow bake and adjoint a step; ms/step and peak. (c) K4
    alone over the 16 directions of the 512^3 smoke sphere's density from
    seeded cotangents against its plain version, and K2 and K4 in
    CUDA-event times in interleaved rounds, with their bounds. (d) K11 and
    K12 at 512^3 against their ATen passes (:func:`shadow_kernels_c5`).
    Returns the numbers."""
    from tpuvr_torch.dist.workers import CaptureGrad
    from tpuvr_torch.kernels import lighting as klight
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ref.march import GRID_PERM
    from tpuvr_torch.train import fit

    lcfg = dataclasses.replace(st["lighting"], detach=False)
    n_dirs = lcfg.n_samples
    out = {}

    # (a) The first step, kernels against plain.
    pick, r0s = np.zeros(1, int), np.zeros(1, np.int32)
    res = {}
    for label, impl in (("kernels", "cuda"), ("plain", "torch")):
        step = fit.make_train_step(key, 1, CaptureGrad(), st["exact"],
                                   False, impl, lighting=lcfg)
        with plain_versions() if impl == "torch" else contextlib.nullcontext():
            reset_counts()
            _, grad, loss = step(fog, None, stacked, g_targets, pick, r0s)
            torch.cuda.synchronize()
            counts = read_counts()
            sizes = (dict(klight.launches), dict(klight.adj_launches))
        res[label] = (float(loss), grad, counts, sizes)
        del step, grad
    (k_loss, k_grad, k_counts, k_sizes), (p_loss, p_grad, p_counts, _) = (
        res["kernels"], res["plain"])
    del res
    scale = float(p_grad.abs().max())
    gerr = float((k_grad - p_grad).abs().max())
    rel = abs(k_loss - p_loss) / p_loss
    del k_grad, p_grad
    # The ATen assembly and the shadow counters count calls, not launches.
    calls = ("light_apply_fallback", "light_shadow", "light_shadow_adjoint")
    out["step_check"] = dict(loss=k_loss, plain_loss=p_loss,
                             loss_rel_err=rel, grad_err_of_max=gerr / scale,
                             max_grad=scale, launches=k_counts,
                             clusters={"tau_sweep": k_sizes[0],
                                       "tau_adj": k_sizes[1]},
                             plain_counts=p_counts)
    log(f"[c5-shadow] first step (group {key}, eps 0, highest, light not "
        f"detached) kernels vs plain: loss {k_loss:.7f} vs {p_loss:.7f} "
        f"({rel:.2e} relative, tol 1e-6); gradient {gerr / scale:.3e} of "
        f"max|grad| {scale:.3e} (tol 1e-5); kernel launches {k_counts}; K2 "
        f"and K4 cluster launches by size {k_sizes}; plain {p_counts}")
    check(rel <= 1e-6 and gerr <= 1e-5 * scale, "c5-shadow step vs plain")
    check(k_counts["sweep_fwd"] == 1 and k_counts["sweep_bwd"] == 1
          and k_counts["tau_sweep"] == 1 and k_counts["tau_adj"] == 1
          and k_counts["tau_sweep_dirs"] == n_dirs
          and k_counts["tau_adj_dirs"] == n_dirs
          and k_sizes == ({16: 1}, {16: 1})
          and k_counts["light_apply_fwd"] == 1
          and k_counts["light_apply_bwd"] == 0
          and k_counts["light_apply_shadow_bwd"] == 1
          and k_counts["light_apply_mask"] == 1
          and k_counts["light_apply_fallback"] == 0
          and k_counts["light_shadow"] == 1
          and k_counts["light_shadow_adjoint"] == 1
          and not any(v for k, v in p_counts.items() if k not in calls),
          f"c5-shadow step: kernels {k_counts} {k_sizes}, plain {p_counts}")

    # (b) The fit.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    t0 = time.time()
    _, params, hist = fit.fit_grid(targets, st["cams"], st["shape"],
                                   st["train"], st["fit_run"],
                                   run_dir=run_dir, lighting=lcfg,
                                   params_init=fog)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    by_size = {name: dict(c) for name, c in (
        ("tau_sweep", klight.launches), ("tau_adj", klight.adj_launches),
        ("tau_sweep_dirs", klight.directions),
        ("tau_adj_dirs", klight.adj_directions))}
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = hist["loss"]
    ms = float(np.mean(hist["step_ms"][1:]))
    finite = bool(torch.isfinite(params).all())
    del params
    steps = st["train"].steps
    out["fit"] = dict(loss=loss, step_ms=hist["step_ms"], ms_per_step=ms,
                      peak_gib=peak, held_gib=held, launches=counts,
                      by_cluster_size=by_size, wall_s=wall)
    log(f"[c5-shadow] fit {st['n']}^3, {C5_VIEWS} lit views, {steps} "
        f"steps, light not detached: {ms:.3f} ms/step after the first "
        f"({hist['step_ms'][0]:.1f} ms), loss "
        + " -> ".join(f"{x:.6f}" for x in loss)
        + f"; peak {peak:.2f} GiB ({held:.2f} held before the fit); "
        f"launches {counts}; tau launches and directions by cluster size "
        f"{by_size}; fit_grid wall {wall:.2f} s")
    check(len(loss) == steps and all(np.isfinite(loss)) and finite,
          "c5-shadow fit losses")
    check(counts["sweep_fwd"] == steps and counts["sweep_bwd"] == steps
          and counts["tau_sweep"] == steps and counts["tau_adj"] == steps
          and counts["light_apply_fwd"] == steps
          and counts["light_apply_bwd"] == 0
          and counts["light_apply_shadow_bwd"] == steps
          and counts["light_apply_mask"] == steps
          and counts["light_apply_fallback"] == 0
          and counts["light_shadow"] == steps
          and counts["light_shadow_adjoint"] == steps
          and by_size == {"tau_sweep": {16: steps}, "tau_adj": {16: steps},
                          "tau_sweep_dirs": {16: steps * n_dirs},
                          "tau_adj_dirs": {16: steps * n_dirs}},
          f"c5-shadow fit launches {counts}, {by_size}")

    # (c) K4 alone at 512^3 over the 16 directions against its plain
    # version; K2 and K4 timed in turn.
    sigma = grid[..., 0].contiguous()
    table = olight.direction_table(lcfg)
    fields = {a: sigma.permute(GRID_PERM[a][:3]).contiguous()
              for a in sorted({row[0] for row in table})}
    del sigma
    gen = torch.Generator(device=grid.device).manual_seed(5)
    rows = [(fields[a], flip, d_y, d_x, dt)
            for a, flip, d_y, d_x, dt in table]
    adj_rows = [(torch.randn(fields[a].shape, generator=gen,
                             device=grid.device),
                 flip, d_y, d_x, dt) for a, flip, d_y, d_x, dt in table]
    before = (klight.adj_launches.copy(), klight.adj_directions.copy())
    ds = klight.tau_sweep_adj_dirs(adj_rows)
    torch.cuda.synchronize()
    route = (dict(klight.adj_launches - before[0]),
             dict(klight.adj_directions - before[1]))
    ref = klight.tau_sweep_adj_dirs_torch(adj_rows)
    torch.cuda.synchronize()
    kscale = max(float(r.abs().max()) for r in ref)
    kerr = max(float((a - b).abs().max()) for a, b in zip(ds, ref))
    del ds, ref
    plain_ms = cuda_ms(lambda: klight.tau_sweep_adj_dirs_torch(adj_rows), 1,
                       warmup=0)
    times = interleaved_ms(
        {"k2": lambda: klight.tau_sweep_dirs(rows),
         "k4": lambda: klight.tau_sweep_adj_dirs(adj_rows)}, 3)
    k2_b = tau_bound(list(fields.values()), len(rows))
    k4_b = tau_bound([g for g, *_ in adj_rows], len(adj_rows))
    del rows, adj_rows, fields
    out["k4"] = dict(
        max_abs_err=kerr, scale=kscale, clusters=route[0],
        directions=route[1], ms=times["k4"], plain_ms=plain_ms,
        k2_ms=times["k2"], bytes_ms=k4_b[0], ops_ms=k4_b[1],
        bound_ms=max(k4_b),
        bound_by="bytes" if k4_b[0] >= k4_b[1] else "operations",
        k2_bound_ms=max(k2_b),
        shape=f"{tuple(grid.shape[:3])}, {len(table)} directions, seeded "
              f"cotangents, highest")
    log(f"[c5-shadow] K4 alone ({out['k4']['shape']}): clusters "
        f"{route[0]}, directions {route[1]}, max abs err {kerr:.3e} of max "
        f"{kscale:.3f} (tol 1e-5 of max); K4 {times['k4']:.4f} ms, K2 "
        f"{times['k2']:.4f} ms (events, median of 5 interleaved rounds; "
        f"bounds {max(k4_b):.4f}, {max(k2_b):.4f}); plain K4 "
        f"{plain_ms:.1f} ms")
    check(kerr <= 1e-5 * kscale and route == ({16: 1}, {16: n_dirs}),
          f"c5 K4: error {kerr:.3e}, launches {route}")
    torch.cuda.empty_cache()
    out["k11_k12"] = shadow_kernels_c5(grid, lcfg)
    torch.cuda.empty_cache()
    return out


def shadow_kernels_c5(grid, lcfg):
    """K11 and K12 (``kernels.light_apply.shadow_cotangents`` and
    ``mask_sum``) at c5's size, the 512^3 grid and its 16 directions,
    against their ATen passes (``shadow_cotangents_torch``,
    ``mask_sum_torch``): K11's grid gradient and cotangents for a
    contiguous cotangent G and for one in each sweep axis's layout, K12's
    sum over the taus (standing in for K4's adjoints, which have their
    layouts) with the z sweep's sigma and with the grid's channel 0, as
    ulp distances (0: the same bits); CUDA-event times of both and of their
    ATen passes, and the kernels' byte bounds. K11 writes over its taus, so
    each check starts from a copy. Returns the numbers."""
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.ref.march import GRID_PERM

    table = olight.direction_table(lcfg)
    n = len(table)
    axes = [row[0] for row in table]
    scale = lcfg.sky_intensity / lcfg.n_samples
    vox = grid[..., 0].numel()
    out = dict(shape=f"{tuple(grid.shape)} smoke_sphere, {n} directions "
                     f"over sweep axes {sorted(set(axes))}, highest",
               k11_bytes_ms=(2 * n + 11) * 4 * vox / HBM_BYTES_PER_S * 1e3,
               k12_bytes_ms=(n + 9) * 4 * vox / HBM_BYTES_PER_S * 1e3,
               k11_ulps=0, k11_ms_by_layout={})
    with torch.no_grad():
        taus = olight._TauDirs.apply(grid[..., 0], table, "highest")
    gen = torch.Generator(device=grid.device).manual_seed(11)
    for layout in ("contiguous", 0, 1, 2):
        if layout == "contiguous":
            g = torch.randn(grid.shape, generator=gen, device=grid.device)
        else:  # a view of a gradient in the sweep layout (S, 4, Ny, Nx)
            p = [grid.shape[i] for i in GRID_PERM[layout][:3]]
            g = torch.randn((p[0], 4, p[1], p[2]), generator=gen,
                            device=grid.device).permute(0, 2, 3, 1).permute(
                tuple(int(i) for i in np.argsort(GRID_PERM[layout])))
        cots = [t.clone() for t in taus]
        dgrid = kla.shadow_cotangents(g, grid, cots, axes, scale)
        plain = [t.clone() for t in taus]
        ref = kla.shadow_cotangents_torch(g, grid, plain, axes, scale)
        out["k11_ulps"] = max(out["k11_ulps"], f32_ulps(dgrid, ref),
                              *(f32_ulps(a, b) for a, b in zip(cots, plain)))
        del ref, plain, dgrid
        # Timed on the copy it has written over: the time does not depend
        # on the values.
        out["k11_ms_by_layout"][str(layout)] = cuda_ms(
            lambda: kla.shadow_cotangents(g, grid, cots, axes, scale), 10)
        if layout == 2:
            out["k11_plain_ms"] = cuda_ms(
                lambda: kla.shadow_cotangents_torch(g, grid, cots, axes,
                                                    scale), 2)
        del cots, g
        torch.cuda.empty_cache()
    out["k11_ms"] = max(out["k11_ms_by_layout"].values())
    # K12 over the taus, which have the adjoints' layouts, into a seeded
    # gradient.
    out.update(k12_ulps=0, k12_ms_by_sigma={})
    dgrid = torch.randn(grid.shape, generator=gen, device=grid.device)
    z_sigma = grid[..., 0].contiguous()
    for name, sigma in (("z_copy", z_sigma), ("grid_channel0", grid[..., 0])):
        a, b = dgrid.clone(), dgrid.clone()
        kla.mask_sum(a, taus, axes, sigma)
        kla.mask_sum_torch(b, taus, axes, sigma)
        out["k12_ulps"] = max(out["k12_ulps"], f32_ulps(a, b))
        del b
        out["k12_ms_by_sigma"][name] = cuda_ms(
            lambda: kla.mask_sum(a, taus, axes, sigma), 10)
        if name == "z_copy":
            out["k12_plain_ms"] = cuda_ms(
                lambda: kla.mask_sum_torch(a, taus, axes, sigma), 2)
        del a
    out["k12_ms"] = out["k12_ms_by_sigma"]["z_copy"]
    del dgrid, taus, z_sigma
    torch.cuda.empty_cache()
    out["k11_share"] = out["k11_bytes_ms"] / out["k11_ms"]
    out["k12_share"] = out["k12_bytes_ms"] / out["k12_ms"]
    log(f"[c5-shadow] K11/K12 ({out['shape']}) against the ATen passes: "
        f"K11 {out['k11_ulps']} ulps, {out['k11_ms']:.4f} ms at the slowest "
        f"cotangent layout ({out['k11_ms_by_layout']}; plain "
        f"{out['k11_plain_ms']:.2f}; bound {out['k11_bytes_ms']:.4f} ms, "
        f"bytes: {100 * out['k11_share']:.1f} %), K12 {out['k12_ulps']} "
        f"ulps, {out['k12_ms']:.4f} ms ({out['k12_ms_by_sigma']}; plain "
        f"{out['k12_plain_ms']:.2f}; bound {out['k12_bytes_ms']:.4f} ms, "
        f"bytes: {100 * out['k12_share']:.1f} %)")
    check(out["k11_ulps"] == 0 and out["k12_ulps"] == 0,
          f"c5 K11/K12 against the ATen passes: {out['k11_ulps']} and "
          f"{out['k12_ulps']} ulps")
    return out


def shadow_kernel_entries(c5):
    """The ``kernels`` summary's rows of K11 and K12, from
    :func:`c5_shadow`."""
    sh = c5["shadow"]
    k = sh["k11_k12"]
    rows = []
    for name, key, by in (("light_apply_shadow_bwd", "k11",
                           "ms_by_cotangent_layout"),
                          ("light_apply_mask", "k12", "ms_by_sigma")):
        rows.append({
            "name": name, "route": "cuda", "config": "c5-shadow",
            "source": "tpuvr_torch/csrc/light_apply.cu",
            "replaces": "none: XLA fuses the light volume's transposes into "
                        "loops around the tau sweeps' adjoint",
            "launches": sh["fit"]["launches"][name],
            "launches_by_path": {
                "c5_shadow_step": sh["step_check"]["launches"][name],
                "c5_shadow_fit": sh["fit"]["launches"][name]},
            "max_ulps": k[f"{key}_ulps"],
            "ms": k[f"{key}_ms"],
            by: k[f"{key}_ms_by_layout" if key == "k11"
                  else f"{key}_ms_by_sigma"],
            "plain_ms": k[f"{key}_plain_ms"],
            "bound_ms": k[f"{key}_bytes_ms"], "bound_by": "bytes",
            "share_of_bound": k[f"{key}_share"],
            "library_ms": None,
            "shape": k["shape"],
        })
    return rows


def tau_adj_c5_entry(c5):
    """The ``kernels`` summary's row of K4 at c5's size, from
    :func:`c5_shadow`: its time and error over the 16 directions at 512^3,
    and its launches in the c5-shadow step and fit."""
    sh = c5["shadow"]
    k4 = sh["k4"]
    return {
        "name": "tau_adj", "route": "cuda", "config": "c5-shadow",
        "source": "tpuvr_torch/csrc/tau_adj.cu",
        "also_source": "tpuvr_torch/csrc/tau_cluster.cuh",
        "replaces": "tpuvr/kernels/lighting.py:64",
        "launches": sh["fit"]["launches"]["tau_adj"],
        "launches_by_path": {
            "c5_shadow_step": sh["step_check"]["launches"]["tau_adj"],
            "c5_shadow_fit": sh["fit"]["launches"]["tau_adj"]},
        "clusters_by_size": sh["fit"]["by_cluster_size"]["tau_adj"],
        "directions_by_size": sh["fit"]["by_cluster_size"]["tau_adj_dirs"],
        "max_abs_err": k4["max_abs_err"], "err_scale": k4["scale"],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
        "shape": k4["shape"] + ", one launch",
    }


def c5_rank(scene_dir):
    """One rank of the c5 mesh, started by ``c5_phase``: c5's lit fit on
    the data mesh through ``workers.c5_case`` (its first step's gradient
    against the one-card step saved in ``scene_dir``, then C5_MESH_STEPS
    steps of ``fit_grid``), then ``scaling_table`` at c5's unlit frame
    through ``workers.scaling_case`` (the one-card row on every rank, the
    mesh's row on rank 0). Returns numbers only."""
    import torch.distributed as tdist

    from tpuvr_torch.dist import init as dinit
    from tpuvr_torch.dist.workers import c5_case, scaling_case
    from tpuvr_torch.io.synth import smoke_sphere

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = dinit.data_mesh()
    st = c5_setup()
    t0 = time.time()
    fit = c5_case(
        mesh, device=dev, scene_dir=scene_dir, cams=st["cams"],
        grid_shape=st["shape"],
        cfg=dataclasses.replace(st["train"], steps=C5_MESH_STEPS),
        render_cfg=st["fit_run"], lighting=st["lighting"],
        step_cfg=st["exact"], run_dir=f"{scene_dir}/mesh")
    torch.cuda.empty_cache()
    print(f"[c5] rank {mesh.rank} on {dev}: fit at {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    grid = smoke_sphere(st["n"], device=dev).cpu().numpy()
    tdist.barrier()
    scaling = scaling_case(mesh, device=dev, grid=grid, cam=st["cam"],
                           cfg=st["cfg"]["render"], min_wall=SCALING_MIN_WALL)
    return {"rank": mesh.rank, "device": str(dev), "fit": fit,
            "scaling": scaling}


def c5_phase():
    """c5 (ROADMAP A3): its one-card part (``c5_one_card``), then c5's lit
    fit on a data mesh and the scaling table at c5's frame (``c5_rank``),
    on C5_CARD_RANKS ranks one a card over NCCL or C5_SHARED_RANKS gloo
    ranks sharing card 0. Checks every rank's results: the first mesh
    step's gradient within 1e-5 of max|grad| of the one-card step's and
    its loss within 1e-6, the same losses, gradient and parameters on every
    rank, the mesh's losses within rtol 2e-3 of the one-card fit's (the JAX
    package's bound for a mesh trajectory), the launches and collectives
    of a step and of the fit, and the scaling rows. Returns the summary and
    c5's launches by kernel row."""
    from tpuvr_torch.dist import launch

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= C5_CARD_RANKS else "gloo"
    world = C5_CARD_RANKS if backend == "nccl" else C5_SHARED_RANKS
    layout = (f"{world} ranks, one a card, over NCCL" if backend == "nccl"
              else f"{world} gloo ranks sharing card 0 (time-sliced: NCCL "
              f"refuses two ranks on one card, and four ranks of 20-26 GiB "
              f"do not fit in one card; these times say nothing of several "
              f"cards)")
    log(f"[c5] 512^3 lit at 1024^2; the mesh: {layout}")
    scratch = Path(__file__).resolve().parent / "scratch"
    scratch.mkdir(exist_ok=True)
    scene_dir = tempfile.mkdtemp(prefix="c5_", dir=scratch)
    t0 = time.time()
    try:
        one = c5_one_card(scene_dir)
        one_s = time.time() - t0
        log(f"[c5] one card done in {one_s:.1f} s")
        ranks = launch.spawn(c5_rank, world, backend, "cuda", (scene_dir,),
                             timeout_s=600)
    finally:
        shutil.rmtree(scene_dir, ignore_errors=True)
    mesh_s = time.time() - t0 - one_s
    check([r["rank"] for r in ranks] == list(range(world)), "c5 ranks")
    fits = [r["fit"] for r in ranks]
    f0 = fits[0]
    loss = f0["loss"]
    steps = C5_MESH_STEPS
    n_dirs = c5_setup()["lighting"].n_samples
    for f in fits:
        check(f["grad_err_of_max"] <= 1e-5,
              f"c5 mesh step: gradient {f['grad_err_of_max']:.3e} of "
              "max|grad| from the one-card step (tol 1e-5)")
        check(abs(f["step_loss"] - one["step_check"]["loss"])
              <= 1e-6 * one["step_check"]["loss"],
              f"c5 mesh step: loss {f['step_loss']} vs one card "
              f"{one['step_check']['loss']}")
        check(f["loss"] == loss and f["grad_digest"] == f0["grad_digest"]
              and f["params_digest"] == f0["params_digest"] and f["finite"],
              "c5 mesh: the ranks' losses, gradients or parameters differ")
        want_step = {"sweep_fwd": 1, "sweep_bwd": 1, "tau_sweep_c16": 1,
                     "tau_sweep_dirs": n_dirs, "light_apply_fwd": 1,
                     "light_apply_bwd": 1, "collective_all_reduce": 1 + 4}
        want_fit = {k: v * steps for k, v in want_step.items()}
        want_fit["collective_broadcast"] = 2
        check(f["step_counts"] == want_step and f["fit_counts"] == want_fit,
              f"c5 mesh launches: step {f['step_counts']} (expected "
              f"{want_step}), fit {f['fit_counts']} (expected {want_fit})")
    check(len(loss) == steps and all(np.isfinite(loss)) and loss[1] < loss[0],
          f"c5 mesh losses {loss}")
    one_loss = one["fit"]["loss"][:steps]
    check(np.allclose(loss, one_loss, rtol=2e-3, atol=0),
          f"c5 mesh losses {loss} vs one card {one_loss} (rtol 2e-3)")
    ms = [float(np.mean(f["step_ms"][1:])) for f in fits]
    mesh = dict(transport=backend, ranks=world, cards=min(n_cards, world),
                layout=layout, steps=steps, loss=loss, one_card_loss=one_loss,
                ms_per_step=ms[0], ms_per_step_by_rank=ms,
                first_step_ms=f0["step_ms"][0],
                grad_err_of_max=max(f["grad_err_of_max"] for f in fits),
                peak_gib_by_rank=[f["peak_gib"] for f in fits],
                held_gib_by_rank=[f["held_gib"] for f in fits],
                step_counts=f0["step_counts"], fit_counts=f0["fit_counts"],
                seconds=mesh_s)
    log(f"[c5] mesh fit ({layout.split(' (')[0]}, {steps} steps): "
        f"{ms[0]:.1f} ms/step after the first on rank 0 (ranks "
        + ", ".join(f"{m:.1f}" for m in ms) + "), loss "
        + " -> ".join(f"{x:.6f}" for x in loss)
        + f" (one card " + " -> ".join(f"{x:.6f}" for x in one_loss)
        + f"); first-step gradient {mesh['grad_err_of_max']:.3e} of "
        f"max|grad| from the one-card step (tol 1e-5); peak GiB by rank "
        + ", ".join(f"{p:.2f}" for p in mesh["peak_gib_by_rank"])
        + " (held before the fit "
        + ", ".join(f"{f['held_gib']:.2f}" for f in fits) + ")"
        + f"; rank 0 a step {f0['step_counts']}, a fit {f0['fit_counts']}")

    rows = [r["scaling"] for r in ranks]
    one_row, mesh_row = rows[0][0], rows[0][-1]
    check([r["devices"] for r in rows[0]] == [1, world]
          and all(len(r) == 1 for r in rows[1:]),
          f"c5 scaling rows {rows}")
    check(all(r[0] == one_row for r in rows),
          "c5 scaling: the ranks' one-card rows differ")
    for row in rows[0]:
        check(row["ms_per_frame"] > 0.0 and 0.0 < row["efficiency"] <= 1.05,
              f"c5 scaling row {row}")
    log(f"[c5] scaling table at c5's frame (512^3 @ 1024^2, unlit, ERT "
        f"1e-4, occupancy; {layout.split(' (')[0]}): one card "
        f"{one_row['ms_per_frame']:.5f} ms/frame "
        f"({one_row['rays_per_s']:.5g} rays/s), {world} ranks "
        f"{mesh_row['ms_per_frame']:.5f} ms/frame "
        f"({mesh_row['rays_per_s']:.5g} rays/s), efficiency "
        f"{mesh_row['efficiency']:.5f}")
    summary = dict(one, mesh=mesh, scaling=dict(
        rows=rows[0], layout=layout.split(" (")[0],
        min_wall_s=SCALING_MIN_WALL), one_card_s=one_s,
        seconds=time.time() - t0)
    log(f"[c5] phase done in {summary['seconds']:.1f} s")
    fit_c = one["fit"]["launches"]
    launches = {
        "sweep_fwd": {"c5_fit": fit_c["sweep_fwd"],
                      "c5_mesh": f0["fit_counts"].get("sweep_fwd", 0)},
        "sweep_bwd": {"c5_fit": fit_c["sweep_bwd"],
                      "c5_mesh": f0["fit_counts"].get("sweep_bwd", 0)},
        "tau_sweep": {"c5_fit": fit_c["tau_sweep"],
                      "c5_mesh": f0["fit_counts"].get("tau_sweep_c16", 0)}}
    return summary, launches


def card_name_and_limit():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def expected_bench_launches(full):
    """K1 and K3 launches of ``judged.run`` on the card, from its loop
    lengths: one sweep each way a body call (a frame is one K1, a step or
    a fwd+bwd one K1 and one K3; the extended set's two slab-chunked frame
    loops take one K1 a slab, 4 and 8), and one of each for the
    pixel-gradient error."""
    from tpuvr_torch.bench import judged

    frames = judged.calls("fwd_prepared") * (6 + 4 + 8 if full else 1) + (
        judged.calls("fwd") if full else 0)
    both = (judged.calls("fwd_bwd") * (3 if full else 1)
            + judged.calls("train_step") + judged.calls("train_step_fused")
            + 1)
    return {"sweep_fwd": frames + both, "sweep_bwd": both}


def bench_phase(dev):
    """The benchmark's judged core on the card: (a) ``judged.run`` at the
    headline frame (the extended set under TPUVR_BENCH_FULL), printed as
    the "bench" line beside the card's name and power limit, with (f) the
    K1/K3 launches its loop lengths predict and no other kernel; (b) K3's
    pixel-gradient error against the f64 oracle within twice the plain
    version's plus 1e-7; (c) every roofline fraction in (0, 1.05]; (d) the
    scaling table's one-card row at the headline frame; (e) the c1 frame
    with mode='fixed_dt' against device="cpu" and against the plane sweep
    at step 0.05, timed; (g) slab-chunked early ray termination
    (``ert_phase``). Returns the launches of (a) and of (g)'s counted
    run."""
    from tpuvr_torch import configs
    from tpuvr_torch.bench import judged
    from tpuvr_torch.bench.sweep import scaling_table
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import render

    full = judged.full_from_env()
    card = card_name_and_limit()
    reset_counts()
    line = judged.run(device=None, full=full)
    torch.cuda.synchronize()
    launches = read_counts()
    log(json.dumps({"bench": line, "card": card}))
    want = expected_bench_launches(full)
    others = {k: v for k, v in launches.items() if k not in want and v}
    log(f"[bench] launches {launches}; expected {want}")
    check(all(launches[k] == n for k, n in want.items()) and not others,
          f"bench launches {launches}, expected {want} and no other kernel")
    for key in ("fwd_ms_per_frame", "fwd_bwd_ms_per_frame", "train_step_ms",
                "train_step_fused_ms"):
        check(line[key] > 0.0, f"bench {key} {line[key]}")
    err, plain = (line["pixel_grad_max_abs_err_compiled"],
                  line["pixel_grad_max_abs_err"])
    vs_plain, scale = (line["pixel_grad_compiled_vs_plain"],
                       line["pixel_grad_oracle_max_abs"])
    log(f"[bench] pixel-grad max abs err vs the f64 oracle: K3 {err:.3e}, "
        f"plain (CPU) {plain:.3e} (tol {2 * plain + 1e-7:.3e}); K3 vs plain "
        f"{vs_plain:.3e} (tol {GRAD_TOL['highest'] * scale:.3e}, "
        f"{GRAD_TOL['highest']} of max|oracle| {scale:.4f})")
    check(err <= 2.0 * plain + 1e-7, "K3's pixel-gradient error")
    check(vs_plain <= GRAD_TOL["highest"] * scale,
          "K3's pixel gradient against the plain version's")
    for key in ("sol_fraction_fwd", "sol_fraction_fwd_bwd"):
        check(0.0 < line[key] <= 1.05,
              f"bench {key} {line[key]} outside (0, 1.05]")
    if full:
        check(all(line[key] is not None and line[key] > 0.0 for key in (
            "ert_chunked_speedup_opaque", "ert_chunked_overhead_transparent",
            "fwd_opaque_ert_chunked_ms")), "bench ert_chunked_* fields")
    ert_launches = ert_phase(dev, card)

    head = configs.CONFIGS["headline"]
    grid = smoke_sphere(head["grid_n"], device=dev)
    rows = scaling_table(grid, configs.camera(head), head["render"])
    log(json.dumps({"scaling": rows, "card": card}))
    check(len(rows) == 1 and rows[0]["ms_per_frame"] > 0.0,
          f"scaling table rows {rows}")
    del grid

    c1 = configs.CONFIGS["c1"]
    cam = configs.camera(c1)
    grid = smoke_sphere(c1["grid_n"], device=dev)
    fixed = dataclasses.replace(c1["render"], mode="fixed_dt")
    with torch.no_grad():
        out = render.render_view(grid, cam, fixed)
        ms = cuda_ms(lambda: render.render_view(grid, cam, fixed), 3)
        t0 = time.perf_counter()
        ref = render.render_view(grid.cpu(), cam, fixed, device="cpu")
        cpu_s = time.perf_counter() - t0
        fine = render.render_view(grid, cam, dataclasses.replace(
            fixed, step_dt=0.05))
        sweep = render.render_view(grid, cam, c1["render"])
    torch.cuda.synchronize()
    scale = float(ref[0].abs().max())
    err = max_err([o.cpu() for o in out], ref)
    gap = max_err(fine, sweep)
    fixed_dt = dict(ms_per_frame=ms, cpu_s=cpu_s, max_abs_err_vs_cpu=err,
                    max_rgb=scale, gap_vs_plane_sweep_step_0_05=gap,
                    shape=f"c1 {c1['grid_n']}^3 @ {cam.res_x}^2, step 0.5")
    log(json.dumps({"fixed_dt": fixed_dt, "card": card}))
    check(all(bool(torch.isfinite(o).all()) for o in (*out, *fine)),
          "fixed_dt: non-finite image")
    check(scale > 0.0 and err <= 1e-5 * scale,
          f"fixed_dt card vs cpu {err:.3e} (tol {1e-5 * scale:.3e})")
    check(gap < 0.06, f"fixed_dt at step 0.05 vs the plane sweep {gap:.3e}")
    return launches, ert_launches


def live_slabs(prep, cam, cfg):
    """Slabs the liveness gate of ``ops.vjp.ert_chunked_sweep`` leaves live
    in one frame of ``cfg`` (one row chunk): the gate replayed slab by slab
    through K1, read back on the host. Its launches are no frame's."""
    from tpuvr_torch.ops import render
    from tpuvr_torch.ops import vjp

    plan, _, (gsc, coeffs, en, dt) = render.sweep_inputs(prep, cam, cfg)
    n = cfg.ert_chunks
    sc = gsc.shape[0] // n
    masks = vjp._future_coverage_masks(coeffs, en, *dt.shape, gsc.shape[2],
                                       gsc.shape[3], sc, n)
    op = vjp.sweep_op(plan.reverse, cfg.sigma_scale, cfg.early_stop_eps,
                      "cuda", cfg.precision)
    trans, live = None, 0
    for g in range(n):
        if g and float(torch.amax(torch.where(
                masks[g - 1], trans, 0.0))) < cfg.early_stop_eps:
            break
        lo = gsc.shape[0] - (g + 1) * sc if plan.reverse else g * sc
        tr = slice(g * sc, (g + 1) * sc)
        _, t_g = op(gsc[lo:lo + sc], tuple(c[tr] for c in coeffs), en[tr],
                    dt)
        trans = t_g if trans is None else trans * t_g
        live += 1
    return live


def ert_phase(dev, card):
    """Slab-chunked early ray termination (``ert_chunks`` > 1, ROADMAP A5)
    at the headline frame (256^3 @ 512^2), 'highest' and 'default', with
    the card's kernels: (a) the smoke sphere in 8 slabs at eps 1e-4 against
    one slab within 2e-6; (b) the opaque fog seen from inside its footprint
    in 4 slabs at eps 1e-3 against eps 0 within the ERT bound (rgb 5 eps,
    T eps); (c) the gradient of mean((rgb - 0.25)^2) of the smoke sphere
    through the reverse camera in 4 slabs against one slab within GRAD_TOL
    of max|grad|, and on the fog every gated slab's gradient exactly zero;
    (d) the same frames and gradients through the plain versions on the
    card, K1 and K3 against them; (e) the live slabs the gate left; (f) K1
    and K3 launches of one counted run of the chunked frames and gradients,
    exactly ert_chunks a row chunk, and no host sync in a chunked frame
    and gradient (sync debug mode "error"); (g) ms per frame and per
    forward+backward against the unchunked twins in interleaved rounds, and
    device time by kernel. Returns the counted run's launches."""
    from tpuvr_torch import configs
    from tpuvr_torch.config import RenderConfig
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops import render
    from tpuvr_torch.ops.vjp import row_chunks
    from tpuvr_torch.ref.camera import dominant_axis, look_at_perspective

    t_start = time.perf_counter()
    head = configs.CONFIGS["headline"]
    n, res = head["grid_n"], head["res"]
    c = (n - 1) / 2.0
    cam = configs.camera(head)
    cam_in = type(cam)(center=(c, c, -2.0 * n), forward=(0.0, 0.0, 1.0),
                       up=(0.0, 1.0, 0.0), width=0.9 * n, height=0.9 * n,
                       res_x=res, res_y=res)
    cam_rev = look_at_perspective((c + 3.0 * n, c + 0.2 * n, c - 0.4 * n),
                                  (c, c, c), res_x=res, res_y=res)
    sphere = smoke_sphere(n, device=dev)
    fog = torch.full((n, n, n, 4), 0.5, device=dev)
    preps = {}

    def prep(grid, cam_):
        key = (id(grid), dominant_axis(cam_))
        if key not in preps:
            preps[key] = render.prepare_grid(grid, axes=(key[1],))
        return preps[key]

    # (grid, camera, ERT cfg fields, slabs); eps 0 also for the fog.
    cases = {"transparent": (sphere, cam, dict(early_stop_eps=1e-4), 8),
             "opaque": (fog, cam_in, dict(early_stop_eps=1e-3,
                                          sigma_scale=8.0), 4),
             "grad": (sphere, cam_rev, dict(early_stop_eps=1e-4), 4),
             "opaque_grad": (fog, cam_in, dict(early_stop_eps=1e-3,
                                               sigma_scale=8.0), 4)}

    def cfg_of(name, prec, chunks):
        return RenderConfig(precision=prec, ert_chunks=chunks,
                            **cases[name][2])

    def frame(name, cfg):
        grid, cam_ = cases[name][:2]
        p = prep(grid, cam_)
        return lambda: render.render_prepared(p, cam_, cfg)

    def fwd_bwd(name, cfg):
        grid, cam_ = cases[name][:2]
        axis = dominant_axis(cam_)
        gsc, smax = prep(grid, cam_)[axis]

        def run():
            g = gsc.detach().requires_grad_(True)
            rgb, _ = render.render_prepared({axis: (g, smax)}, cam_, cfg)
            return torch.autograd.grad(torch.mean((rgb - 0.25) ** 2), g)[0]

        return run

    def chunked_calls(prec):
        return [frame("transparent", cfg_of("transparent", prec, 8)),
                frame("opaque", cfg_of("opaque", prec, 4)),
                fwd_bwd("grad", cfg_of("grad", prec, 4)),
                fwd_bwd("opaque_grad", cfg_of("opaque_grad", prec, 4))]

    out = {"shape": f"headline {n}^3 @ {res}^2", "by_precision": {}}
    want = {"sweep_fwd": 0, "sweep_bwd": 0}
    for prec in ("highest", "default"):
        for name, (grid, cam_, _, k) in cases.items():
            cfg = cfg_of(name, prec, k)
            plan, _, _ = render.sweep_inputs(prep(grid, cam_), cam_, cfg)
            rows = row_chunks(plan.n_v, cfg.max_rows_per_call)
            want["sweep_fwd"] += k * rows
            if name.endswith("grad"):
                want["sweep_bwd"] += k * rows
        for fn in chunked_calls(prec):  # warm the frame geometry
            fn()
    torch.cuda.synchronize()
    # The counted run: each chunked frame and gradient once a tier.
    reset_counts()
    for prec in ("highest", "default"):
        for fn in chunked_calls(prec):
            fn()
    torch.cuda.synchronize()
    launches = read_counts()
    others = {k: v for k, v in launches.items() if k not in want and v}
    log(f"[bench] ert launches {launches}; expected {want} (ert_chunks a "
        f"row chunk, whatever the gate did)")
    check(all(launches[k] == v for k, v in want.items()) and not others,
          f"ert launches {launches}, expected {want} and no other kernel")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in chunked_calls("default"):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[bench] ert: no host sync in a chunked frame or gradient")
    out["sync_free"] = True

    for prec in ("highest", "default"):
        res_ = out["by_precision"][prec] = {}
        tol_g = GRAD_TOL[prec]
        t_ch, t_1 = (frame("transparent", cfg_of("transparent", prec, k))()
                     for k in (8, 1))
        o_ch = frame("opaque", cfg_of("opaque", prec, 4))()
        o_off = frame("opaque", RenderConfig(
            precision=prec, early_stop_eps=0.0, sigma_scale=8.0))()
        g_ch, g_1 = (fwd_bwd("grad", cfg_of("grad", prec, k))()
                     for k in (4, 1))
        og_ch = fwd_bwd("opaque_grad", cfg_of("opaque_grad", prec, 4))()
        with plain_versions():
            pt_ch = frame("transparent", cfg_of("transparent", prec, 8))()
            po_ch = frame("opaque", cfg_of("opaque", prec, 4))()
            pg_ch = fwd_bwd("grad", cfg_of("grad", prec, 4))()
        torch.cuda.synchronize()
        live = {name: live_slabs(prep(*cases[name][:2]), cases[name][1],
                                 cfg_of(name, prec, cases[name][3]))
                for name in ("transparent", "opaque", "grad")}
        res_["live_slabs"] = {name: f"{v} of {cases[name][3]}"
                              for name, v in live.items()}
        eps_o = cases["opaque"][2]["early_stop_eps"]
        res_["transparent_vs_one_slab"] = max_err(t_ch, t_1)
        res_["opaque_rgb_vs_eps0"] = float((o_ch[0] - o_off[0]).abs().max())
        res_["opaque_t_vs_eps0"] = float((o_ch[1] - o_off[1]).abs().max())
        scale = float(g_1.abs().max())
        res_["grad_vs_one_slab_of_max"] = float(
            (g_ch - g_1).abs().max()) / scale
        res_["transparent_vs_plain"] = max_err(t_ch, pt_ch)
        res_["opaque_vs_plain"] = max_err(o_ch, po_ch)
        res_["grad_vs_plain_of_max"] = float(
            (g_ch - pg_ch).abs().max()) / float(pg_ch.abs().max())
        sc = og_ch.shape[0] // 4
        gated = range(live["opaque"], 4)
        res_["opaque_gated_slabs_grad_max"] = max(
            (float(og_ch[g * sc:(g + 1) * sc].abs().max()) for g in gated),
            default=0.0)
        log(f"[bench] ert {prec}: live slabs {res_['live_slabs']}; smoke "
            f"sphere 8 slabs vs 1: {res_['transparent_vs_one_slab']:.3e} "
            f"(tol 2e-6); opaque fog 4 slabs vs eps 0: rgb "
            f"{res_['opaque_rgb_vs_eps0']:.3e} (tol {5 * eps_o:g}), T "
            f"{res_['opaque_t_vs_eps0']:.3e} (tol {eps_o:g}); gradient 4 "
            f"slabs vs 1 {res_['grad_vs_one_slab_of_max']:.3e} of max "
            f"{scale:.3e} (tol {tol_g:g}); fog's gated slabs' gradient max "
            f"{res_['opaque_gated_slabs_grad_max']:g} (want 0)")
        log(f"[bench] ert {prec} vs the plain versions on the card: smoke "
            f"sphere {res_['transparent_vs_plain']:.3e}, fog "
            f"{res_['opaque_vs_plain']:.3e} (tol 1e-5 + eps max|c|), "
            f"gradient {res_['grad_vs_plain_of_max']:.3e} of max (tol "
            f"{tol_g:g})")
        check(all(bool(torch.isfinite(t).all())
                  for t in (*t_ch, *o_ch, g_ch, og_ch)), "ert: non-finite")
        check(res_["transparent_vs_one_slab"] <= 2e-6,
              f"ert {prec}: smoke sphere in 8 slabs vs one")
        check(res_["opaque_rgb_vs_eps0"] < 5 * eps_o
              and res_["opaque_t_vs_eps0"] < eps_o,
              f"ert {prec}: opaque fog outside the ERT bound")
        check(res_["grad_vs_one_slab_of_max"] <= tol_g,
              f"ert {prec}: gradient in 4 slabs vs one")
        check(live["opaque"] < 4 and res_["opaque_gated_slabs_grad_max"]
              == 0.0, f"ert {prec}: the fog's gated slabs")
        check(res_["transparent_vs_plain"] <= 1e-5 + 1e-4
              and res_["opaque_vs_plain"] <= 1e-5 + eps_o,
              f"ert {prec}: K1 vs the plain versions")
        check(res_["grad_vs_plain_of_max"] <= tol_g,
              f"ert {prec}: K3 vs the plain versions")
        del t_ch, t_1, o_ch, o_off, g_ch, g_1, og_ch, pt_ch, po_ch, pg_ch

        frames = {"transparent_8": frame("transparent",
                                         cfg_of("transparent", prec, 8)),
                  "transparent_1": frame("transparent",
                                         cfg_of("transparent", prec, 1)),
                  "opaque_4": frame("opaque", cfg_of("opaque", prec, 4)),
                  "opaque_1": frame("opaque", cfg_of("opaque", prec, 1)),
                  "opaque_eps0": frame("opaque", RenderConfig(
                      precision=prec, early_stop_eps=0.0, sigma_scale=8.0))}
        grads = {"grad_4": fwd_bwd("grad", cfg_of("grad", prec, 4)),
                 "grad_1": fwd_bwd("grad", cfg_of("grad", prec, 1))}
        with torch.no_grad():
            res_["ms_per_frame"] = interleaved_ms(frames, 20)
        res_["ms_per_fwd_bwd"] = interleaved_ms(grads, 5)
        res_["device_ms"] = {}
        for name, fn in (("transparent_8", frames["transparent_8"]),
                         ("opaque_4", frames["opaque_4"]),
                         ("grad_4", grads["grad_4"])):
            total, top, _ = device_ms(fn, 3, n_top=4)
            res_["device_ms"][name] = {"total": total, "by_kernel": top}
        fr, fb = res_["ms_per_frame"], res_["ms_per_fwd_bwd"]
        log(f"[bench] ert {prec} ms/frame: " + ", ".join(
            f"{k} {v:.4f}" for k, v in fr.items()) + "; ms/fwd+bwd: "
            + ", ".join(f"{k} {v:.4f}" for k, v in fb.items())
            + f"; chunked speedup on the fog vs eps 0 "
            f"{fr['opaque_eps0'] / fr['opaque_4']:.3f}, overhead on the "
            f"sphere {fr['transparent_8'] / fr['transparent_1']:.3f}")
        for name, d in res_["device_ms"].items():
            log(f"[bench] ert {prec} {name} device ms: " + (
                "not measured" if d["total"] is None else
                f"{d['total']:.4f}; by kernel " + "; ".join(
                    f"{k} {v:.4f}" for k, v in d["by_kernel"])))
    out["seconds"] = time.perf_counter() - t_start
    log(f"[bench] ert phase in {out['seconds']:.1f} s")
    log(json.dumps({"ert_chunks": out, "card": card}))
    return {k: launches[k] for k in want}


def read_png(path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG of one IDAT with filter
    0 rows (``io.image.write_png``'s), decoded with zlib alone; every
    chunk's CRC checked."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(crc == zlib.crc32(kind + body), f"{path}: bad CRC in {kind}")
        chunks[kind] = body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check((depth, color) == (8, 2) and b"IEND" in chunks,
          f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def shell_cli(run_root):
    """The command line at full width on the card: each command through
    ``tpuvr_torch.cli.main``, with its wall time and its kernels' launches
    (the counts set to 0 just before it and read just after)."""
    from tpuvr_torch import cli, configs
    from tpuvr_torch.io.image import to_uint8

    size = {k: configs.CONFIGS[k]["res"] for k in ("c2", "c3")}
    png = os.path.join(run_root, "c3.png")
    commands = {
        "render": ["render", "--config", "c3", "--out", png],
        "turntable": ["turntable", "--config", "c2", "--frames", "8",
                      "--out-dir", os.path.join(run_root, "turntable")],
        "fit": ["fit", "--config", "c4", "--steps", "3", "--run-dir",
                os.path.join(run_root, "fit")],
        "bench": ["bench", "--config", "c1", "--profile",
                  os.path.join(run_root, "trace")],
        "gradcheck": ["gradcheck"],
    }
    out = {}
    for name, argv in commands.items():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        out[name] = {"wall_s": wall, "launches": counts}
        log(f"[shell] cli {' '.join(argv)}: {wall:.3f} s; launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
        if name == "render":
            check(got.shape == (size["c3"], size["c3"], 3)
                  and np.isfinite(got).all() and got.max() > 0.0,
                  "cli render: image")
            check(np.array_equal(read_png(png), to_uint8(got)),
                  "cli render: the PNG is not tonemap of the image")
            check(counts["tau_sweep"] == 1 and counts["sweep_fwd"] == 1,
                  "cli render: one light bake and one sweep expected")
        elif name == "turntable":
            frames = sorted(Path(argv[-1]).glob("frame_*.png"))
            check(got["frames"] == 8 and len(frames) == 8,
                  "cli turntable: 8 frames")
            check(all(read_png(f).shape == (size["c2"], size["c2"], 3)
                      for f in frames), "cli turntable: frame shapes")
            check(counts["sweep_fwd"] == 8, "cli turntable: one K1 a frame")
        elif name == "fit":
            out[name].update(got, cards=torch.cuda.device_count())
            check(got["steps"] == 3 and np.isfinite(got["final_loss"])
                  and got["psnr_db"] > 0.0, f"cli fit: {got}")
            # One card: 64 targets and 64 evaluation renders, one K1 each;
            # 3 steps of one view batch each way. With more cards the fit
            # runs on one rank a card, which count their own launches.
            check(torch.cuda.device_count() > 1 or (
                counts["sweep_fwd"] == 128 and counts["sweep_fwd_views"] == 3
                and counts["sweep_bwd_views"] == 3),
                "cli fit: 128 K1, 3 K5 and 3 K6 expected")
        elif name == "bench":
            out[name]["rows"] = got
            check(got[0] == {"trace_dir": argv[-1]} and os.path.getsize(
                os.path.join(argv[-1], "trace.json")) > 0,
                "cli bench: no trace")
            check(got[1]["ms_per_frame"] > 0.0 and got[-1]["device"]
                  == torch.cuda.get_device_name(0), "cli bench: rows")
            check(0.0 < got[-1]["sol_fraction"] <= 1.05,
                  f"cli bench: sol_fraction {got[-1]['sol_fraction']}")
            check(counts["sweep_fwd"] > 2, "cli bench: K1 not launched")
        else:
            out[name].update(got)
            check(counts["sweep_fwd"] == 1 + 2 * got["probes"]
                  and counts["sweep_bwd"] == 1,
                  "cli gradcheck: K1 and K3 launches")
    # The error is mostly the f32 central difference's: the loss (at most
    # 4 res^2 = 1024 at gradcheck's 16^2) is summed in another order on the
    # card, and each ulp
    # of it moves the difference quotient by ulp / (2 h). The card's error
    # is held within the plain versions' on the same arguments plus two
    # such ulps.
    plain = cli.main(["gradcheck", "--device", "cpu"])
    noise = 2 * float(np.spacing(np.float32(4 * 16**2))) / (2 * 1e-3)
    out["gradcheck"]["cpu_max_abs_err_vs_fd"] = plain["max_abs_err_vs_fd"]
    check(out["gradcheck"]["max_abs_err_vs_fd"]
          <= plain["max_abs_err_vs_fd"] + noise,
          f"cli gradcheck: card {out['gradcheck']} against cpu {plain} "
          f"(tol + {noise:.3e})")
    return out


def shell_phase(dev):
    """The outer shell (ROADMAP A7) on the card: the TVOL codec at 256^3
    (native against numpy, both ways), hollow_shell(256) through
    render_view at the headline frame against device="cpu",
    render_with_geom against render_view at oversample 2, the command line
    at full width (``shell_cli``), and ``dryrun_multichip(4)`` against its
    one-process step. Returns (summary, launches by path)."""
    from tpuvr_torch import configs, entry
    from tpuvr_torch.config import RenderConfig
    from tpuvr_torch.io import volume
    from tpuvr_torch.io.synth import hollow_shell, smoke_sphere
    from tpuvr_torch.ops import render
    from tpuvr_torch.ops.geometry import view_geometry

    summary = {"card": card_name_and_limit()}
    run_root = tempfile.mkdtemp(prefix=".chip_smoke_shell_",
                                dir=Path(__file__).resolve().parent)
    try:
        # (a) TVOL: native and numpy codecs, bit for bit both ways.
        check(volume._lib() is not None, "the native TVOL codec did not load")
        head = configs.CONFIGS["headline"]
        vol = smoke_sphere(head["grid_n"], device=dev).cpu().numpy()
        a, b = os.path.join(run_root, "a.tvol"), os.path.join(run_root,
                                                             "b.tvol")
        times = {}
        for key, fn in (("native_write_s", lambda: volume.save_tvol(a, vol)),
                        ("numpy_write_s",
                         lambda: volume._save_tvol_numpy(b, vol, True)),
                        ("native_read_s", lambda: volume.load_tvol(b)),
                        ("numpy_read_s",
                         lambda: volume._load_tvol_numpy(a))):
            t0 = time.perf_counter()
            got = fn()
            times[key] = time.perf_counter() - t0
            if got is not None:
                check(np.array_equal(got.view(np.uint32),
                                     vol.view(np.uint32)),
                      f"TVOL {key}: not bit for bit")
        same = Path(a).read_bytes() == Path(b).read_bytes()
        check(same, "TVOL: native and numpy files differ")
        summary["tvol"] = dict(times, bytes=os.path.getsize(a),
                               shape=list(vol.shape))
        log(f"[shell] TVOL smoke_sphere({head['grid_n']}) "
            f"{os.path.getsize(a)} bytes: "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
            + "; native and numpy files equal, reads bit for bit")
        del vol

        # (b) hollow_shell(256) at the headline frame, card against CPU.
        cam = configs.camera(head)
        cfg = RenderConfig(early_stop_eps=0.0)
        shell = hollow_shell(head["grid_n"], device=dev)
        # The card's f64 cosine may round to another f32 than the CPU's.
        grid_err = float((shell.cpu() - hollow_shell(
            head["grid_n"], device="cpu")).abs().max())
        check(grid_err <= 1e-6, f"hollow_shell: card and CPU grids differ "
              f"by {grid_err:.3e}")
        reset_counts()
        card = render.render_view(shell, cam, cfg)
        torch.cuda.synchronize()
        counts = read_counts()
        t0 = time.perf_counter()
        ref = render.render_view(shell.cpu(), cam, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = max_err([o.cpu() for o in card], ref)
        empty = float((shell[..., 0] == 0).float().mean())
        summary["hollow_shell"] = dict(max_abs_err=err, cpu_s=cpu_s,
                                       empty_share=empty,
                                       grid_vs_cpu=grid_err)
        log(f"[shell] hollow_shell({head['grid_n']}) front ortho @ "
            f"{cam.res_x}^2 highest eps 0, "
            f"card vs cpu: max abs err {err:.3e} (tol 1e-5); the grid "
            f"vs the CPU's {grid_err:.3e}; empty voxels "
            f"{empty:.4f}; K1 launches {counts['sweep_fwd']}; CPU "
            f"{cpu_s:.2f} s")
        check(err <= 1e-5 and counts["sweep_fwd"] == 1,
              "hollow_shell render card vs cpu")
        del shell, card, ref

        # (c) render_with_geom against render_view, a c2 orbit view at
        # oversample 2.
        c2 = configs.CONFIGS["c2"]
        cfg = dataclasses.replace(c2["render"], oversample=2.0)
        cam = configs.camera(c2)
        grid = smoke_sphere(c2["grid_n"], device=dev)
        axis, reverse, geom, band = view_geometry(
            cam, tuple(grid.shape), oversample=cfg.oversample)
        reset_counts()
        got = render.render_with_geom(grid, geom, axis, reverse, cfg,
                                      band=band)
        torch.cuda.synchronize()
        counts = read_counts()
        want = render.render_view(grid, cam, cfg)
        err = max_err(got, want)
        summary["render_with_geom"] = dict(max_abs_err=err,
                                           rows=int(geom["dt"].shape[0]))
        log(f"[shell] render_with_geom c2 at oversample 2 "
            f"({geom['dt'].shape[0]} rows) vs render_view: max abs err "
            f"{err:.3e} (tol 1e-5); K1 launches {counts['sweep_fwd']}")
        check(err <= 1e-5 and counts["sweep_fwd"] == 1,
              "render_with_geom vs render_view")
        del grid

        # (d) The command line.
        summary["cli"] = shell_cli(run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)

    # (e) The dry run on 4 ranks against one process on the card.
    ranks = 4
    t0 = time.perf_counter()
    out = entry.dryrun_multichip(ranks)
    wall = time.perf_counter() - t0
    ref = entry.dryrun_reference(ranks)
    n_z = entry.dryrun_layout(ranks)[1]
    sz = entry.DRYRUN_GRID // n_z
    scale = float(np.abs(ref["grad"]).max())
    ring_scale = float(np.abs(ref["ring_grad"]).max())
    live = np.abs(ref["grad"]) > 1e-6
    errs = {"loss": 0.0, "grad": 0.0, "slab": 0.0, "ring_grad": 0.0}
    for res in out:
        d = res["z"]
        m = live[d * sz:(d + 1) * sz]
        errs["loss"] = max(errs["loss"], abs(res["loss"] - ref["loss"])
                           / ref["loss"])
        errs["grad"] = max(errs["grad"], float(np.abs(
            res["grad"] - ref["grad"]).max()) / scale)
        errs["slab"] = max(errs["slab"], float(np.abs(
            res["slab"] - ref["params"][d * sz:(d + 1) * sz])[m].max()))
        errs["ring_grad"] = max(errs["ring_grad"], float(np.abs(
            res["ring_grad"] - ref["ring_grad"]).max()) / ring_scale)
        check(res["launches"].get("sweep_fwd", 0) > 0
              and res["launches"].get("sweep_bwd", 0) > 0,
              f"dry run rank: no K1 or K3 launch ({res['launches']})")
    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    # 1e-5 of max|grad|, and the roundoff of the sum over the ranks.
    grad_tol = 1e-5 + 3 * 2.0**-24 * ranks
    summary["dryrun"] = dict(ranks=ranks, backend=backend, wall_s=wall,
                             digests=[r["digest"] for r in out],
                             launches=out[0]["launches"], **{
                                 f"{k}_err": v for k, v in errs.items()})
    log(f"[shell] dryrun_multichip({ranks}) over {backend}: {wall:.2f} s; "
        f"loss {out[0]['loss']:.6f} vs one process {ref['loss']:.6f} "
        f"(rel {errs['loss']:.2e}, tol 1e-6); gradient "
        f"{errs['grad']:.2e} of max|grad| (tol {grad_tol:.2e}); slabs "
        f"{errs['slab']:.2e} where |g| > 1e-6 (tol 1e-6); ring gradient "
        f"{errs['ring_grad']:.2e} of max|grad| (tol {grad_tol:.2e}); slab "
        f"digests "
        + " ".join(r["digest"][:12] for r in out))
    check(errs["loss"] <= 1e-6 and errs["grad"] <= grad_tol
          and errs["slab"] <= 1e-6 and errs["ring_grad"] <= grad_tol,
          "dry run against the one-process step")
    for r, res in enumerate(out):
        check(res["digest"] == out[r % n_z]["digest"],
              "dry run: the ranks of a slab differ")
    paths = {f"shell_{k}": v["launches"] for k, v in summary["cli"].items()}
    paths["shell_dryrun"] = collections.Counter()
    for res in out:
        paths["shell_dryrun"].update(
            {k: v for k, v in res["launches"].items()
             if not k.startswith("collective_")})
    return summary, paths


def finish(t_start):
    """The cards, the card's name and power limit, and the contract line."""
    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60, check=True)
    for line in cards.stdout.strip().splitlines():
        log(f"[device] {line}")
    log(card_name_and_limit())
    log(f"chip_smoke: done in {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase",
                        choices=("all", "dist", "zshard", "warp", "bwd",
                                 "fwd", "light", "bench", "c5", "shell"),
                        default="all",
                        help="'dist': build, then the data-parallel path "
                             "alone; 'zshard': build, then the z-sharded "
                             "grid at 512^3 alone; 'warp': build, then the row warp's "
                             "kernels (K7, K8) alone; 'bwd': build, then "
                             "the backward sweep (K6, K3) alone, with "
                             "digests of its gradients and its stages' "
                             "times; 'fwd': build, then the forward sweep "
                             "(K1, K5) alone, with digests of its outputs, "
                             "times and geometry; 'light': build, then the "
                             "light bake's tau sweep and its adjoint (K2, "
                             "K4) alone, with digests, times and the lit "
                             "fit's first-step gradient; 'bench': build, "
                             "then the benchmark's judged core at the "
                             "headline frame (TPUVR_BENCH_FULL=1 adds the "
                             "extended set), its scaling row and the c1 "
                             "fixed-step frame; 'c5': build, then c5 (512^3 "
                             "lit at 1024^2) on one card and on a data mesh, "
                             "with the scaling table at its frame; 'shell': "
                             "build, then the outer shell (TVOL codec, "
                             "hollow_shell, render_with_geom, the command "
                             "line, the 4-rank dry run)")
    opts = parser.parse_args(argv)
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
    logs = _build.build({"fwd": ("sweep_fwd",),
                         "zshard": ("sweep_fwd", "sweep_bwd"),
                         "bench": ("sweep_fwd", "sweep_bwd"),
                         "c5": ("sweep_fwd", "sweep_bwd", "tau_sweep",
                                "tau_adj", "light_apply"),
                         "shell": ("sweep_fwd", "sweep_bwd", "tau_sweep",
                                   "tau_adj", "light_apply"),
                         "light": ("tau_sweep", "tau_adj", "light_apply")}.get(
                             opts.phase, _build.SOURCES))
    log(f"[build] {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in ptxas_report(text):
            log(f"[build] {name}: {line}")
    if opts.phase == "dist":
        dist, ring_entry, _ = dist_phase()
        log(json.dumps({"dist": dist}))
        log(json.dumps({"kernels": [ring_entry]}))
        return finish(t_start)
    if opts.phase == "zshard":
        zshard, _ = zshard_phase()
        log(json.dumps({"zshard": zshard}))
        return finish(t_start)
    if opts.phase == "warp":
        log(json.dumps({"warp": warp_kernels(dev)}))
        return finish(t_start)
    if opts.phase == "bwd":
        log(json.dumps({"bwd": bwd_phase(dev)}))
        return finish(t_start)
    if opts.phase == "fwd":
        log(json.dumps({"fwd": fwd_phase(dev)}))
        return finish(t_start)
    if opts.phase == "light":
        log(json.dumps({"light": light_phase(dev)}))
        return finish(t_start)
    if opts.phase == "bench":
        bench_phase(dev)
        return finish(t_start)
    if opts.phase == "c5":
        c5, _ = c5_phase()
        log(json.dumps({"c5": c5}))
        log(json.dumps({"kernels": light_apply_entries(c5)
                        + [tau_adj_c5_entry(c5)]
                        + shadow_kernel_entries(c5)}))
        return finish(t_start)
    if opts.phase == "shell":
        shell, _ = shell_phase(dev)
        log(json.dumps({"shell": shell}))
        return finish(t_start)

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
        bytes_ms, ops_ms = sweep_fwd_bound(args)
        ray_slices, in_support = sweep_work(args)[3:]
        t_run = outs[(run.precision, run.early_stop_eps)][1]
        sweep_ms[name] = dict(
            ms=cuda_ms(lambda: ksweep.sweep_fwd(*args, **kw), 10),
            plain_ms=cuda_ms(lambda: sweep_fwd_torch(*args, **kw), 2),
            bytes_ms=bytes_ms, ops_ms=ops_ms, ray_slices=ray_slices,
            in_support=in_support,
            library_ms=grid_sample_ms(args),
            rays_terminated=int((t_run < run.early_stop_eps).sum()))
        log(f"[kernel] sweep_fwd {name} ({run.precision}, eps "
            f"{run.early_stop_eps:g}): " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in sweep_ms[name].items()))
        del grid, args, outs

    light = light_kernels(dev)
    bwd = backward_kernels(dev)
    vb = view_batch_kernels(dev)
    wk = warp_kernels(dev)

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

    # 3. The main path at full size, through the entry points.
    reset_counts()
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
            before = (klight.launches.copy(), klight.directions.copy())
            prep = render.prepare_grid(grid, axes=(axis,),
                                       lighting=cfg["lighting"],
                                       precision=run.precision)
            torch.cuda.synchronize()
            bake_ms = (time.time() - t0) * 1e3
            bake_route = (dict(klight.launches - before[0]),
                          dict(klight.directions - before[1]))
            n_dirs = cfg["lighting"].n_samples
            check(len(bake_route[0]) == 1 and 0 not in bake_route[0]
                  and list(bake_route[0].values()) == [1]
                  and list(bake_route[1].values()) == [n_dirs],
                  f"light bake: one cluster launch of {n_dirs} directions "
                  f"expected, got launches {bake_route[0]} directions "
                  f"{bake_route[1]}")
            bake_dev, bake_top, _ = device_ms(lambda: render.prepare_grid(
                grid, axes=(axis,), lighting=cfg["lighting"],
                precision=run.precision), 1)
            log(f"[main] c3 light bake ({cfg['lighting'].n_samples} "
                f"directions, prepare_grid, tau launches by cluster size "
                f"{bake_route[0]}): {bake_ms:.2f} ms; device " + (
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
        dev_ms, top, ops = device_ms(
            lambda: render.render_prepared(prep, cam, run), n_frames)
        frames[name] = dict(ms_per_frame=ms, rays_per_s=rays / ms * 1e3,
                            device_ms_per_frame=dev_ms, host_ops=ops,
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
    launches = read_counts()
    main_sizes = (dict(klight.launches), dict(klight.directions))
    log(f"[main] launches on the main path: {launches}; tau_sweep launches "
        f"and directions by cluster size {main_sizes}")
    check(launches["sweep_fwd"] > 0, "main path never launched sweep_fwd")
    check(launches["tau_sweep"] > 0, "main path never launched tau_sweep")

    # 4. The training path.
    run_root = tempfile.mkdtemp(prefix=".chip_smoke_",
                                dir=Path(__file__).resolve().parent)
    try:
        train = training(dev, run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    lit_sizes = {name: set(train["lit"]["by_cluster_size"][name])
                 for name in ("tau_sweep", "tau_adj")}
    held = light["check_run_routes"]["lit_fit_table"]
    check(all(lit_sizes[name] == set(r[name]) for r in held.values()
              for name in lit_sizes),
          f"lit fit took clusters {lit_sizes}, its table was held at {held}")
    # 5. The data-parallel path; rank 0's counts join the launches.
    dist, ring_entry, dist_fits = dist_phase()
    for mode in DIST_MODES:
        train[f"dist_{mode}"] = {"launches": dist_fits[0][mode]["launches"]}
    # 6. The z-sharded grid at 512^3; rank 0's counts join the launches.
    zshard, z_launches = zshard_phase()
    train_paths = ("c4", "c4_fused", "c4_loop", "c4_fused_loop", "c4_rows",
                   "c4_fused_rows", "psnr_rows", "lit",
                   *(f"dist_{mode}" for mode in DIST_MODES))
    launches_by_path = {
        name: {"render": launches.get(name, 0),
               **{p: train[p]["launches"][name] for p in train_paths}}
        for name in ("sweep_fwd", "sweep_bwd", "tau_sweep", "tau_adj",
                     "tau_sweep_dirs", "tau_adj_dirs", "sweep_fwd_views",
                     "sweep_bwd_views", "warp_rows_fwd", "warp_rows_bwd")}

    for name, by_path in z_launches.items():
        launches_by_path[name].update(by_path)
    for name in ("sweep_fwd", "sweep_bwd"):
        launches_by_path[name]["dist_grad"] = sum(
            dist["grad"][p]["launches"][name] for p in dist["grad"])
    # 7. The benchmark's judged core; its K1/K3 launches join the counts.
    bench_launches, ert_launches = bench_phase(dev)
    for name in ("sweep_fwd", "sweep_bwd"):
        launches_by_path[name]["bench"] = bench_launches[name]
        launches_by_path[name]["ert_chunks"] = ert_launches[name]
    # 8. c5 on one card and on a data mesh; its counts join the launches.
    c5, c5_launches = c5_phase()
    for name, by_path in c5_launches.items():
        launches_by_path[name].update(by_path)
    # 9. The outer shell; each of its paths' counts joins the launches.
    shell, shell_launches = shell_phase(dev)
    for path, counts in shell_launches.items():
        for name, by_path in launches_by_path.items():
            by_path[path] = counts.get(name, 0)
    shell_paths = tuple(shell_launches)

    def train_launches(name):
        return (sum(train[p]["launches"][name] for p in train_paths)
                + sum(n for p, n in z_launches.get(name, {}).items()
                      if p.startswith("zshard_fit"))
                + sum(launches_by_path[name].get(p, 0) for p in (
                    "bench", "ert_chunks", "c5_fit", "zshard_grad",
                    "dist_grad", *shell_paths)))

    def bound(bytes_ms, ops_ms):
        return {"bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    # 10. Summary.
    head = sweep_ms["headline"]
    bc4 = bwd["by_config"]["c4"]
    kernels = [
        {
            "name": "sweep_fwd", "route": "cuda",
            "source": "tpuvr_torch/csrc/sweep_fwd.cu", "views": 1,
            "replaces": "tpuvr/kernels/sweep.py:179",
            "also_replaces": "tpuvr/kernels/sweep.py:491",
            "launches": (launches["sweep_fwd"] + sum(
                launches_by_path["sweep_fwd"][p] for p in (
                    "bench", "ert_chunks", "c5_fit", "zshard_grad",
                    "dist_grad", *shell_paths))),
            "max_abs_err": sweep_err,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            **bound(head["bytes_ms"], head["ops_ms"]),
            "library_ms": head["library_ms"],
            "library_call": "grid_sample of one slice x S (yardstick)",
            "shape": "headline 256^3 @ 512^2, default, eps 1e-4",
            "by_config": sweep_ms,
            "launches_by_path": launches_by_path["sweep_fwd"],
            "softplus_max_abs_err": bwd["softplus_fwd_err"],
            "softplus_ms_c4": bwd["softplus_fwd_ms"],
            "ray_slices": head["ray_slices"],
            "in_support": head["in_support"],
            "c4_view_ms": vb["fwd_loop_ms"] / vb["views"],
            "c4_view_bound": bound(vb["k1_view_bytes_ms"],
                                   vb["k1_view_ops_ms"]),
        },
        {
            "name": "tau_sweep", "route": "cuda",
            "source": "tpuvr_torch/csrc/tau_sweep.cu",
            "also_source": "tpuvr_torch/csrc/tau_cluster.cuh",
            "replaces": "tpuvr/kernels/lighting.py:33",
            "also_replaces": "tpuvr/kernels/lighting.py:176",
            "launches": (launches["tau_sweep"]
                         + launches_by_path["tau_sweep"]["c5_fit"]
                         + sum(launches_by_path["tau_sweep"][p]
                               for p in shell_paths)),
            "launches_by_path": launches_by_path["tau_sweep"],
            "directions_by_path": launches_by_path["tau_sweep_dirs"],
            "directions_per_launch": (launches["tau_sweep_dirs"]
                                      / launches["tau_sweep"]),
            "clusters_by_size": main_sizes[0],
            "directions_by_size": main_sizes[1],
            "check_run_routes": light["check_run_routes"],
            "max_abs_err": light["max_abs_err"],
            "ms": light["bake_ms"],
            "device_ms": light["bake_device_ms"],
            "plain_ms": light["plain_bake_ms"],
            **bound(light["bake_bytes_ms"], light["bake_ops_ms"]),
            "library_ms": None,
            "one_direction": {
                "ms": light["one_ms"], "device_ms": light["one_device_ms"],
                "plain_ms": light["plain_one_ms"],
                **bound(light["one_bytes_ms"], light["one_ops_ms"])},
            "c5_512": light["c5"],
            "c5_bake": c5["bake"],
            "lit_fit_table": {k: light["lit_fit"][k] for k in (
                "max_abs_err", "adj_max_abs_err")},
            "shape": light["shape"] + ", one launch, highest",
        },
        {
            "name": "sweep_bwd", "route": "cuda",
            "source": "tpuvr_torch/csrc/sweep_bwd.cu", "views": 1,
            "replaces": "tpuvr/kernels/sweep_bwd.py:58",
            "also_replaces": "tpuvr/kernels/sweep_bwd.py:341",
            "launches": train_launches("sweep_bwd"),
            "launches_by_path": launches_by_path["sweep_bwd"],
            "max_abs_err": bwd["max_abs_err"],
            "ms": bc4["ms"],
            "plain_ms": bwd["plain_ms"],
            **bound(bc4["bytes_ms"], bc4["ops_ms"]),
            "library_ms": None,
            "ray_slices": bc4["ray_slices"],
            "in_support": bc4["in_support"],
            "shape": "c4: 256^3, first orbit view at 256^2, highest",
            "by_config": bwd["by_config"],
        },
        {
            "name": "tau_adj", "route": "cuda",
            "source": "tpuvr_torch/csrc/tau_adj.cu",
            "also_source": "tpuvr_torch/csrc/tau_cluster.cuh",
            "replaces": "tpuvr/kernels/lighting.py:64",
            "also_replaces": "tpuvr/kernels/lighting.py:131",
            "launches": train["lit"]["launches"]["tau_adj"],
            "launches_by_path": launches_by_path["tau_adj"],
            "directions_by_path": launches_by_path["tau_adj_dirs"],
            "directions_per_launch": (train["lit"]["launches"]["tau_adj_dirs"]
                                      / train["lit"]["launches"]["tau_adj"]),
            "clusters_by_size": train["lit"]["by_cluster_size"]["tau_adj"],
            "directions_by_size": train["lit"]["by_cluster_size"][
                "tau_adj_dirs"],
            "max_abs_err": light["adj_max_abs_err"],
            "ms": light["adj_bake_ms"],
            "device_ms": light["adj_bake_device_ms"],
            "plain_ms": light["adj_plain_bake_ms"],
            **bound(light["adj_bake_bytes_ms"], light["adj_bake_ops_ms"]),
            "library_ms": None,
            "one_direction": {
                "ms": light["adj_one_ms"],
                "device_ms": light["adj_one_device_ms"],
                "plain_ms": light["adj_plain_one_ms"],
                **bound(light["one_bytes_ms"], light["one_ops_ms"])},
            "shape": light["shape"] + " (seeded cotangents), one launch, "
                     "highest",
        },
        {
            "name": "sweep_fwd_views", "route": "cuda",
            "source": "tpuvr_torch/csrc/sweep_fwd.cu",
            "views": vb["views"],
            "replaces": "tpuvr/kernels/sweep.py:270",
            "launches": train_launches("sweep_fwd_views"),
            "launches_by_path": launches_by_path["sweep_fwd_views"],
            "max_abs_err": vb["max_abs_err"],
            "max_abs_err_vs_k1_loop": vb["bit_err_vs_k1"],
            "ms": vb["fwd_ms"],
            "k1_loop_ms": vb["fwd_loop_ms"],
            "plain_ms": vb["fwd_plain_ms"],
            **bound(vb["fwd_bytes_ms"], vb["fwd_ops_ms"]),
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes a "
                            "view-batched sweep",
            "ray_slices": vb["ray_slices"],
            "in_support": vb["in_support"],
            "shape": vb["shape"] + ", highest",
        },
        {
            "name": "sweep_bwd_views", "route": "cuda",
            "source": "tpuvr_torch/csrc/sweep_bwd.cu",
            "views": vb["views"],
            "replaces": "tpuvr/kernels/sweep_bwd.py:165",
            "launches": train_launches("sweep_bwd_views"),
            "launches_by_path": launches_by_path["sweep_bwd_views"],
            "max_abs_err": vb["bwd_max_abs_err"],
            "err_of_max_vs_k3_sum": vb["k3_sum_err_of_max"],
            "ms": vb["bwd_ms"],
            "k3_loop_ms": vb["bwd_loop_ms"],
            "plain_ms": vb["bwd_plain_ms"],
            **bound(vb["bwd_bytes_ms"], vb["bwd_ops_ms"]),
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes a sweep's "
                            "gradient",
            "ray_slices": vb["ray_slices"],
            "in_support": vb["in_support"],
            "slab": vb["slab"],
            "shape": vb["shape"] + ", highest",
        },
    ]
    # The row warp's kernels, timed at the axis-1 plan (32x32 tiles, f_v
    # 88); the axis-0 plan's numbers are under "by_plan".
    w1 = wk["cases"]["axis1"]
    for d, replaces, err in (
            ("fwd", "tpuvr/kernels/warp.py:59", wk["fwd_max_abs_err"]),
            ("bwd", "tpuvr/kernels/warp.py:93", wk["bwd_max_abs_err"])):
        kernels.append({
            "name": f"warp_rows_{d}", "route": "cuda",
            "source": "tpuvr_torch/csrc/warp_rows.cu",
            "replaces": replaces,
            "launches": train_launches(f"warp_rows_{d}"),
            "launches_by_path": launches_by_path[f"warp_rows_{d}"],
            "max_abs_err": err,
            **({"err_of_max_grad": wk["bwd_err_of_max"],
                "bit_identical_over_two_calls": all(
                    c["bwd_bit_identical"] for c in wk["cases"].values())}
               if d == "bwd" else {}),
            "ms": w1[f"{d}_ms"],
            "device_ms": w1[f"{d}_device_ms"],
            "host_us": w1[f"{d}_host_us"],
            "plain_ms": w1[f"{d}_plain_ms"],
            **bound(w1["bytes_ms"], w1["ops_ms"]),
            "library_ms": w1[f"{d}_library_ms"],
            "library_device_ms": w1[f"{d}_library_device_ms"],
            "library_host_us": w1[f"{d}_library_host_us"],
            "library_call": ("grid_sample (bilinear, border, align_corners)"
                             if d == "fwd" else
                             "aten.grid_sampler_2d_backward, input gradient"),
            "shape": f"one c4 view, axis 1: {w1['plan']}, lattice "
                     f"{w1['lattice']}",
            "by_plan": {a: {k: v for k, v in c.items()
                            if k.endswith(("_ms", "_us")) or k == "plan"}
                        for a, c in wk["cases"].items()},
        })
    kernels.append(ring_entry)
    kernels.extend(light_apply_entries(c5))
    kernels.append(tau_adj_c5_entry(c5))
    kernels.extend(shadow_kernel_entries(c5))
    log(json.dumps({"frames": frames}))
    log(json.dumps({"train": train}))
    log(json.dumps({"dist": dist}))
    log(json.dumps({"zshard": zshard}))
    log(json.dumps({"c5": c5}))
    log(json.dumps({"shell": shell}))
    log(json.dumps({"kernels": kernels}))
    return finish(t_start)


if __name__ == "__main__":
    sys.exit(main())
