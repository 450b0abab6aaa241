"""The whole frame's share of the card's peak: the least time of its
forward sweep and pixel warp (``vrbench/work.py``), a profiled frame's
mean, over the untraced window's frame_ms."""


def read(ctx):
    if ctx["kind"] != "view" or not ctx.get("trace_frames"):
        return None
    b = ctx["bounds"]
    least = (b["sweep_fwd"] + b["warp"]) / ctx["trace_frames"]
    return 100.0 * least / (ctx["window_s"] / ctx["frames"] * 1e3)
