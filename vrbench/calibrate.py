"""The readings that the limits of ``vrbench/limits/<workload>.json`` are
set from, on the chip at the cell's own size:

    python3 vrbench/calibrate.py --workload c5-fit --seeds 11 12 13 ...

For each seed, in one process: the system as the configuration states it
(the lower readings), the control (the system's 'default' tier: bf16
resampling where the configuration states 'highest'), and for fit cells
the faults planted in the reference put in the system's place
('half_batch', 'altered', and 'no_exchange' for a mesh cell). A
configuration's fit on a mesh runs its ranks through
``tpuvr_torch.dist.launch.spawn``. One JSON line a seed and mode; the
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vrbench import check, fitjob, viewjob  # noqa: E402
from vrbench.ref.sweep import strict_f32  # noqa: E402
from vrbench.spec import Spec  # noqa: E402


MODES = (("program", None), ("control", "default"))


def rank_checks(cfg, traffic, seeds):
    """One rank of a mesh: the check readings of every seed and mode."""
    from tpuvr_torch.dist.init import data_mesh

    mesh, device = data_mesh(), fitjob.rank_device()
    return {(seed, mode): fitjob.run(cfg, traffic, seed, 0.0, False, device,
                                     mesh=mesh, precision=precision,
                                     window=False)[0]
            for seed in seeds for mode, precision in MODES}


def fit_modes(cfg, traffic, seed, device, faults, mesh_runs=None):
    """The readings of one seed; ``mesh_runs`` holds the program's from a
    mesh (:func:`rank_checks`), else it runs here."""
    out = {}
    for mode, precision in MODES:
        if mesh_runs is not None:
            out[mode] = mesh_runs[(seed, mode)]
        else:
            out[mode] = fitjob.run(cfg, traffic, seed, 0.0, False, device,
                                   precision=precision, window=False)[0]
    inp = fitjob.Inputs(cfg, traffic, seed, device)
    ref = check.fit_reference(cfg, inp, device)
    rows = {m: check.fit_numbers(p, ref) for m, p in out.items()}
    for fault in faults:
        planted = check.fit_reference(cfg, inp, device, fault=fault)
        rows[fault] = check.fit_numbers(planted, ref)
    return rows


def view_modes(cfg, traffic, seed, device):
    rows = {}
    for mode, precision in (("program", None), ("control", "default")):
        prog, cams = viewjob.run(cfg, traffic, seed, 0.0, False, device,
                                 precision=precision, window=False)
        rows[mode] = check.view_numbers(cfg, seed, cams,
                                        prog["kept"], prog["prep"], device)
        del prog
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=None)
    args = p.parse_args()
    spec = Spec()
    w = spec.workload(args.workload)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    strict_f32()
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    faults = args.faults
    if faults is None:
        faults = ["half_batch", "altered"] + (
            ["no_exchange"] if traffic.get("ranks", 1) > 1 else [])
    mesh_runs = None
    if traffic.get("ranks", 1) > 1:
        from tpuvr_torch.dist.launch import spawn

        mesh_runs = spawn(rank_checks, traffic["ranks"], "nccl", "cuda",
                          args=(cfg, traffic, args.seeds),
                          timeout_s=3000.0)[0]
    for seed in args.seeds:
        t0 = time.time()
        if traffic["kind"] == "fit":
            rows = fit_modes(cfg, traffic, seed, device, faults, mesh_runs)
        else:
            rows = view_modes(cfg, traffic, seed, device)
        for mode, nums in rows.items():
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "mode": mode, **nums}), flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
