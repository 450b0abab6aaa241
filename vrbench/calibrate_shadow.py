"""The readings that the limits of a shadow-fit cell
(``vrbench/limits/<workload>.json``, traffic kind ``shadowfit``) are set
from, on the chip at the cell's own size:

    python3 vrbench/calibrate_shadow.py --workload c5-shadow-fit --seeds 11 12

For each seed, in one process: the system as the configuration states it
(the lower readings), the control (the system's 'default' tier where the
configuration states 'highest'), and the faults planted in the shadow
reference put in the system's place ('half_batch', 'altered' and
'detached': the light's gradient left out). One JSON line a seed and
mode; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vrbench import check, fitjob  # noqa: E402
from vrbench import shadowfitjob as J  # noqa: E402
from vrbench.ref.sweep import strict_f32  # noqa: E402
from vrbench.spec import Spec  # noqa: E402

FAULTS = ("half_batch", "altered", "detached")


def modes(cfg, traffic, seed, device, faults=FAULTS):
    """{mode: the numbers compared} of one seed."""
    inp = fitjob.Inputs(cfg, traffic, seed, device)
    ref = J.reference(cfg, inp, device)
    rows = {}
    for mode, precision in (("program", None), ("control", "default")):
        prog = fitjob.run(cfg, traffic, seed, 0.0, False, device,
                          precision=precision, window=False)[0]
        rows[mode] = check.fit_numbers(prog, ref)
        torch.cuda.empty_cache()
    for fault in faults:
        planted = J.reference(cfg, inp, device, fault=fault)
        rows[fault] = check.fit_numbers(planted, ref)
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    spec = Spec()
    w = spec.workload(args.workload)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    if traffic["kind"] != "shadowfit":
        raise SystemExit(f"{w['name']} is not a shadow fit "
                         "(vrbench/calibrate.py calibrates the others)")
    strict_f32()
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.time()
        for mode, nums in modes(cfg, traffic, seed, device).items():
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "mode": mode, **nums}), flush=True)
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
