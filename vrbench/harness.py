"""Run one cell once and print its result line.

The cell's configuration, traffic mix, limits and metric readers are
found by name (:mod:`vrbench.spec`). The traffic's ``kind`` names the job
module ``vrbench/<kind>job.py`` (``fit``: :mod:`vrbench.fitjob`, ``view``:
:mod:`vrbench.viewjob`), whose ``cell`` runs the cell. After the window
the program's state is freed and the plain reference decides ``correct``;
each metric's reader, ``vrbench/metrics/<metric>.py``, reads its number
from the run's readings; the compared numbers and their limits end
standard error and the result line.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import torch

from vrbench import check, trace
from vrbench.guard import forbidden_modules
from vrbench.ref.sweep import strict_f32
from vrbench.spec import Spec


def power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(args, t_start: float, spec: Spec = None, device=None) -> int:
    """Run the cell; ``spec`` and ``device`` are for the tests, which
    run a copy of the benchmark on the CPU without looking for a card."""
    spec = spec or Spec()
    w = spec.workload(args.workload)
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(w["name"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < w["chips"]):
            print(f"vrbench: {w['name']} needs {w['chips']} CUDA device(s);"
                  f" found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)  # the host's work is Python: no idle pool
    strict_f32()
    job = importlib.import_module(f"vrbench.{traffic['kind']}job")
    prog, numbers, attempted = job.cell(cfg, traffic, args, device)
    prog["setup_s"] = prog["t_window"] - t_start
    correct = check.judge(numbers, limits) and prog["failed"] == 0
    ctx = dict(prog, kind=traffic["kind"])
    if args.trace:
        ctx["kernels"] = trace.program_kernels(spec.root)
    metrics = {}
    for m in spec.metrics(w["name"], "per_layer" if args.trace
                          else "end_to_end"):
        value = spec.reader(m["name"])(ctx)
        if value is None and not args.trace:
            print(f"vrbench: no reading of {m['name']} in {w['name']}",
                  file=sys.stderr)
            return 4
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": w["chips"],
                   "memory_peak_bytes": int(prog["peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(prog["failed"]), "metrics": metrics,
              "device": device_info}
    if args.trace:
        tr = prog["trace"]
        device_info["busy_s"] = prog.get("busy_s", tr["busy_s"])
        device_info["window_s"] = prog.get("trace_window_s", tr["window_s"])
        result["breakdown"] = {"device_ops": trace.top(tr["by_kernel"]),
                               "idle_gaps": trace.top(tr["gaps"])}
    result["card"] = power_limit()
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    bad = sorted(set(forbidden_modules()) | set(prog.get("forbidden", ())))
    if bad:
        print(f"vrbench: loaded {bad}; the benchmark may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
