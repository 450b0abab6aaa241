"""Share of the forward sweep's least time in its device time, in a
viewer's profiled frames: every frame's bound (``vrbench/work.py``) over the device
seconds of the kernels of ``sweep_fwd.cu`` (K1)."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if ctx["kernels"].get(name) == "sweep_fwd")
    if ctx["kind"] != "view" or t <= 0:
        return None
    return 100.0 * ctx["bounds"]["sweep_fwd"] / (t * 1e3)
