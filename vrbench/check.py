"""The numbers that decide ``correct``: the system's readings against the
plain reference's, each compared with its limit from
``vrbench/limits/<workload>.json``.

Fit cells: ``loss_gap``, the largest relative gap of the check steps'
losses; ``grad_gap``, of the first gradient's norm, leaf by leaf (the
grid's four channels); ``step_gap``, of the parameters' change over the
check steps. A leaf's gap is the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of ``step_gap``.

Viewer cells: ``frame_err``, the largest absolute error of a kept frame's
colour; ``prep_err``, of the prepared lit grid.
"""

from __future__ import annotations

import numpy as np

from vrbench import scene
from vrbench.ref import geometry as G
from vrbench.ref import sweep as S
from vrbench.ref import train as RT

CHECK_STEPS = 3  # the fit's first steps, which the reference follows
REF_ROW_BLOCK = 512  # rows the reference re-marches under autograd at once


def leaf_gap(prog, ref, keep=None) -> float:
    prog, ref = np.asarray(prog, float), np.asarray(ref, float)
    den = np.maximum(ref, np.median(ref))
    gap = np.abs(prog - ref) / den
    if keep is not None:
        gap = gap[keep]
    return float(gap.max())


def fit_numbers(prog: dict, ref: dict) -> dict:
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    g_ref = np.asarray(ref["grad_norms"])
    return {
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_gap": leaf_gap(prog["grad_norms"], g_ref),
        "step_gap": leaf_gap(prog["change_norms"], ref["change_norms"],
                             g_ref >= 1e-3 * np.median(g_ref)),
    }


def fit_reference(cfg, inp, device, fault=None) -> dict:
    """The reference's readings of the check steps, from the inputs the
    system was given."""
    losses, g, c, _ = RT.follow(
        RT.initial_params(cfg, device), inp.views, inp.targets, cfg,
        CHECK_STEPS, inp.draw.fit_seed, row_block=REF_ROW_BLOCK, fault=fault)
    return {"losses": losses, "grad_norms": g.tolist(),
            "change_norms": c.tolist()}


def view_numbers(cfg, seed, cams, kept, prep, device) -> dict:
    """``prep_err`` and ``frame_err`` of a viewer run; frees ``prep``."""
    n = cfg["grid_n"]
    draw = scene.Draw(seed, n)
    lit = S.lit(scene.smoke_scene(n, draw, device), cfg.get("lighting"))
    prep_err = 0.0
    for axis in sorted(prep):
        ref = G.sweep_layout(lit, axis)
        prep_err = max(prep_err, float((prep[axis][0] - ref).abs().max()))
        del ref
    prep.clear()
    frame_err = 0.0
    by_pose = {}
    for pose, img in kept.values():
        by_pose.setdefault(pose, []).append(img)
    for pose, imgs in sorted(by_pose.items()):
        v = G.view(cams[pose], lit.shape, device)
        rgb, _ = S.render(lit, v, cfg["early_stop_eps"], cfg["use_occupancy"])
        rgb = rgb.cpu()
        for img in imgs:
            frame_err = max(frame_err, float((img - rgb).abs().max()))
    return {"frame_err": frame_err, "prep_err": prep_err}


def judge(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)

