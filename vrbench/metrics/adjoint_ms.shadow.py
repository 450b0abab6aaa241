"""Mean host ms per profiled shadow-fit step in the system's span
``tpuvr.light.adjoint``: the shadows' backward (the adjoint launch, the
relu masks and the directions' sum), on autograd's thread, inside the
step's ``tpuvr.fit.backward``. None for a system without the span."""

from vrbench.spans import snapshot


def read(ctx):
    snap = snapshot() if ctx["kind"] == "shadowfit" else None
    adj = snap and snap["totals"].get("tpuvr.light.adjoint")
    if not adj or not ctx.get("trace_steps"):
        return None
    return 1e3 * adj["host_s"] / ctx["trace_steps"]
