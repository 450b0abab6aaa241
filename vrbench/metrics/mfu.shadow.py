"""The whole shadow-fit step's share of the card's peak: the least time of
its stages (the sweeps, the bake (K2), its adjoint (K4), Adam, and the lit
grid's assembly each way; a profiled step's mean) over the untraced
window's step_ms."""

from vrbench.readers import step_ms


def read(ctx):
    if ctx["kind"] != "shadowfit" or not ctx.get("trace_steps"):
        return None
    b = ctx["bounds"]
    least = (b["sweep_fwd"] + b["sweep_bwd"] + b["tau"] + b["tau_adj"]
             + b["adam"] + b["assembly"]) / ctx["trace_steps"]
    return 100.0 * least / step_ms(ctx)
