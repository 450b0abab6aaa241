"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose sizes and
options are in ``vrbench/configs/<config>.json``, and a traffic mix, whose
parameters are in ``vrbench/traffic/<traffic>.json`` (its ``kind`` names
the job, ``vrbench/<kind>job.py``); each metric, end-to-end or per-layer,
has its reader in ``vrbench/metrics/<metric>.py``, and each cell the
limits of its correctness check in ``vrbench/limits/<workload>.json``.
Adding a cell, a configuration, a mix of an existing kind or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def check_names(bench: dict) -> None:
    """Raise ValueError for a name or unit outside the benchmark's
    alphabet: names of letters, digits, ``_``, ``.`` and ``-`` (at most
    64, not starting with ``.`` or ``-``), units of those and ``/`` and
    ``%`` (at most 16)."""
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        names += list(c["reduced"])
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        if not UNIT.match(m["unit"]):
            raise ValueError(f"unit {m['unit']!r} of {m['name']!r}")
    for n in names:
        if not NAME.match(n):
            raise ValueError(f"name {n!r}")


class Spec:
    """The benchmark as declared, rooted at ``root`` (a checkout)."""

    def __init__(self, root: Path = REPO):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        check_names(self.bench)
        self.here = self.root / "vrbench"

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.here / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.here / "limits" / f"{workload}.json")

    def metrics(self, workload: str, kind: str) -> list:
        """The cell's ``end_to_end`` or ``per_layer`` entries: those whose
        ``workloads`` name it, or that have none."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``vrbench/metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "vrbench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
