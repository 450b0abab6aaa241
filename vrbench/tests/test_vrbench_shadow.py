"""The shadow-fit job (``vrbench/shadowfitjob.py``, cell c5-shadow-fit)
through the harness on the CPU at 16^3: correct as configured, with its
end-to-end and span metrics; not correct in the control's lower precision
or with the timed path broken underneath, the port's light detached
among the faults."""

import math

import pytest

from conftest import run_cell
from test_vrbench_harness import _altered, _half_batch, _unchanged

CELL = "c5-shadow-fit"


def _detached(monkeypatch):
    """The port's light detached: the shadows' gradient left out."""
    from tpuvr_torch.ops import lighting

    real = lighting.apply_lighting

    def apply(grid, cfg, precision="highest", detach=None):
        return real(grid, cfg, precision, detach=True)

    monkeypatch.setattr(lighting, "apply_lighting", apply)


def test_the_cell_is_cut_to_16(tiny):
    cfg = tiny.config(tiny.workload(CELL)["config"])
    assert cfg["grid_n"] == 16 and cfg["lighting"]["detach"] is False


@pytest.mark.parametrize("trace", [0, 1])
def test_the_shadow_fit_runs_correct(tiny, capsys, trace):
    rc, res = run_cell(tiny, CELL, capsys, trace=trace)
    assert rc == 0 and res["correct"], res
    assert set(res["check"]) == {"loss_gap", "grad_gap", "step_gap"}
    names = {m["name"] for m in tiny.metrics(
        CELL, "per_layer" if trace else "end_to_end")}
    if not trace:
        assert set(res["metrics"]) == names == {"step_ms", "peak_gib",
                                                "setup_s"}
        return
    # the CPU runs no kernel of the system's: no roofline there
    assert set(res["metrics"]) == names - {"tau_roofline.shadow",
                                           "sweep_roofline.shadow"}
    for name, m in res["metrics"].items():
        assert math.isfinite(m["value"]), name
    assert res["metrics"]["adjoint_ms.shadow"]["value"] > 0
    assert res["metrics"]["plan_ms.shadow"]["value"] > 0


def test_the_control_is_not_correct(tiny, capsys):
    import json

    path = tiny.here / "configs" / "c5-shadow.json"
    cfg = json.loads(path.read_text())
    cfg["precision"] = "default"
    path.write_text(json.dumps(cfg))
    rc, res = run_cell(tiny, CELL, capsys)
    assert rc == 0 and not res["correct"], res["check"]


FAULTS = [_unchanged, _half_batch, _altered, _detached]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch, fault):
    fault(monkeypatch)
    rc, res = run_cell(tiny, CELL, capsys)
    assert rc == 0 and not res["correct"], res["check"]


def test_a_system_without_the_shadow_span_reads_no_adjoint(
        tiny, capsys, monkeypatch):
    """As the parent of the span, whose snapshot holds no
    ``tpuvr.light.adjoint``: the traced run reports the other metrics and
    leaves ``adjoint_ms.shadow`` out."""
    from vrbench import spans

    real = spans.snapshot

    def without():
        snap = real()
        if snap:
            snap["totals"].pop("tpuvr.light.adjoint", None)
        return snap

    monkeypatch.setattr(spans, "snapshot", without)
    rc, res = run_cell(tiny, CELL, capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert "idle_share.shadow" in res["metrics"]
    assert "adjoint_ms.shadow" not in res["metrics"]
