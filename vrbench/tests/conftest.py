"""A copy of the benchmark, its configurations cut to 16^3, that the
tests run on the CPU through the harness (no look for a card)."""

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"c4": dict(grid_n=16, res=16, n_views=16),
        "c5": dict(grid_n=16, res=16, n_views=4)}


def copy_bench(dst: Path, sizes=TINY) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst)
    shutil.copytree(REPO / "vrbench", dst / "vrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in sizes.items():
        path = dst / "vrbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
    return dst


@pytest.fixture
def tiny(tmp_path):
    from vrbench.spec import Spec

    torch.set_num_threads(2)
    return Spec(copy_bench(tmp_path))


def run_cell(spec, workload, capsys, trace=0, seed=2**31 + 7, seconds=None):
    """Run one cell of ``spec`` on the CPU; (exit code, result or None).
    A traced window is one cycle of steps or poses: the CPU profile of the
    plain versions' many operations is slow to read."""
    if seconds is None:
        seconds = 0.05 if trace else 0.5
    from vrbench import harness

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    capsys.readouterr()
    rc = harness.main(args, time.time(), spec=spec, device=torch.device("cpu"))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
