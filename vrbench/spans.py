"""Readings of the system's own phase spans (``tpuvr_torch.utils.trace``),
from the snapshot of its latest recording period: in a traced run, the
profiled call that follows the untraced window, since the spans are on
while the profiler runs. Each returns None where the run's kind is not
its own or the system recorded nothing there: a system without the spans,
or the parent process of a run on several cards, whose ranks keep theirs.
"""

from __future__ import annotations


def snapshot():
    """The system's snapshot, or None where it holds no span."""
    try:
        from tpuvr_torch.utils.trace import snapshot as read
    except ImportError:
        return None
    snap = read()
    return snap if snap["totals"] else None


def issue_ms(ctx):
    """Mean host ms of the profiled call's steps, each from its entry to
    its return (the steps' request records). This is the host's time in
    the step, waits on the card included: a copy to the card that blocks
    until the queued work is done counts here, and moves this reading
    where it moves to another phase."""
    snap = snapshot() if ctx["kind"] == "fit" else None
    steps = snap and snap["requests"].get("fit.step")
    if not steps:
        return None
    return 1e3 * steps["host_s"] / steps["count"]


def plan_ms_fit(ctx):
    """Host ms of ``fit_grid``'s planning (``tpuvr.fit.plan``) in one
    profiled call, over the untraced window's steps: what one call's
    planning adds to each step of ``step_ms``."""
    snap = snapshot() if ctx["kind"] == "fit" else None
    plan = snap and snap["totals"].get("tpuvr.fit.plan")
    if not plan:
        return None
    return 1e3 * plan["host_s"] / plan["count"] / ctx["steps"]


def plan_ms_view(ctx):
    """Mean host ms a profiled frame spends in ``render_prepared``'s
    planning (``tpuvr.render.plan``) before its sweep is issued."""
    snap = snapshot() if ctx["kind"] == "view" else None
    plan = snap and snap["totals"].get("tpuvr.render.plan")
    frames = snap and snap["requests"].get("render.frame")
    if not (plan and frames):
        return None
    return 1e3 * plan["host_s"] / frames["count"]
