"""The readers of the system's own spans on the CPU at 16^3: a traced run
of each one-card cell reports the span metrics its entries list, finite
and above 0, and none of the others; an untraced run reports none."""

import math

from conftest import run_cell

SPAN_METRICS = {"issue_ms.c4", "issue_ms.fit", "plan_ms.c4", "plan_ms.fit",
                "plan_ms.view"}


def test_traced_cells_report_their_span_metrics(tiny, capsys):
    for w in tiny.bench["workloads"]:
        if w["chips"] > 1:
            continue
        want = {m["name"] for m in tiny.metrics(w["name"], "per_layer")
                } & SPAN_METRICS
        assert want, w["name"]
        rc, res = run_cell(tiny, w["name"], capsys, trace=1)
        assert rc == 0 and res["correct"], (w["name"], res)
        got = set(res["metrics"]) & SPAN_METRICS
        assert got == want, w["name"]
        for name in got:
            value = res["metrics"][name]["value"]
            assert math.isfinite(value) and value > 0, (name, value)
        rc, res = run_cell(tiny, w["name"], capsys, trace=0)
        assert rc == 0 and not set(res["metrics"]) & SPAN_METRICS


def test_the_mesh_cell_lists_none(tiny):
    assert not {m["name"] for m in tiny.metrics("c5-fit-x4", "per_layer")
                } & SPAN_METRICS


def test_a_system_without_the_spans_reads_nothing(tiny, capsys, monkeypatch):
    """A system without ``tpuvr_torch.utils.trace`` (as before it had
    one): the traced run reports the other metrics and leaves these out."""
    import sys

    monkeypatch.setitem(sys.modules, "tpuvr_torch.utils.trace", None)
    rc, res = run_cell(tiny, "c5-orbit", capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert "idle_share.view" in res["metrics"]
    assert not set(res["metrics"]) & SPAN_METRICS
