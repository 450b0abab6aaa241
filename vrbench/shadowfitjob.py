"""The shadow-fit traffic: the fit traffic (:mod:`vrbench.fitjob`) of a
configuration whose light is not detached, so that every step's gradient
flows through the sky light's transmittance into the density as well.

The run is :func:`vrbench.fitjob.run`'s, unchanged. The check follows its
first steps with :mod:`vrbench.ref.shadow`, the reference that
differentiates the shadows, and compares the fit's numbers
(:func:`vrbench.check.fit_numbers`). One card only.
"""

from __future__ import annotations

import sys
import time

import torch

from vrbench import check, fitjob, shadowwork
from vrbench.ref import shadow as RS
from vrbench.ref import train as RT


def reference(cfg, inp, device, fault=None) -> dict:
    """The shadow reference's readings of the check steps, from the inputs
    the system was given."""
    losses, g, c, _ = RS.follow(
        RT.initial_params(cfg, device), inp.views, inp.targets, cfg,
        check.CHECK_STEPS, inp.draw.fit_seed, row_block=check.REF_ROW_BLOCK,
        fault=fault)
    return {"losses": losses, "grad_norms": g.tolist(),
            "change_norms": c.tolist()}


def bounds(cfg, prog, views) -> dict:
    """:func:`vrbench.fitjob.bounds`, with the light's adjoint (K4) and the
    lit grid's assembly each way, every step (:mod:`vrbench.shadowwork`)."""
    out = fitjob.bounds(cfg, prog, views, 1)
    vox = cfg["grid_n"] ** 3
    n_dirs = cfg["lighting"]["n_samples"]
    out["tau_adj"] = prog["trace_steps"] * shadowwork.tau_adj_ms(vox, n_dirs)
    out["assembly"] = prog["trace_steps"] * shadowwork.assembly_ms(vox,
                                                                   n_dirs)
    return out


def cell(cfg, traffic, args, device):
    """Run the cell: (readings, the numbers compared, steps attempted)."""
    if traffic.get("ranks", 1) != 1 or cfg["lighting"]["detach"]:
        raise ValueError("the shadow fit runs on one card, its light not "
                         "detached")
    prog, inp = fitjob.run(cfg, traffic, args.seed, args.seconds,
                           bool(args.trace), device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference(cfg, inp, device)
    print(f"vrbench: the reference took {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if args.trace:
        prog["bounds"] = bounds(cfg, prog, inp.views)
    return (prog, check.fit_numbers(prog, ref),
            prog["steps"] + prog.get("trace_steps", 0))
