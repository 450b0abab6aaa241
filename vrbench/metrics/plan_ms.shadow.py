"""Host ms of one profiled shadow-fit ``fit_grid`` call's planning span
(``tpuvr.fit.plan``) over the untraced window's steps: what a call's
planning adds to each step of ``step_ms``. None for a system without the
span."""

from vrbench.spans import snapshot


def read(ctx):
    snap = snapshot() if ctx["kind"] == "shadowfit" else None
    plan = snap and snap["totals"].get("tpuvr.fit.plan")
    if not plan:
        return None
    return 1e3 * plan["host_s"] / plan["count"] / ctx["steps"]
