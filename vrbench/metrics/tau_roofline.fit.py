"""Share of the light bake's least time in its device time, in a lit
fit's profiled call: the density read once and each direction's optical depth
written once, every step (``vrbench/work.py``), over the device seconds
of the kernels of ``tau_sweep.cu`` and ``tau_cluster.cuh`` (K2; the
adjoint K4 shares the cluster kernel, and runs only with undetached
light)."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if ctx["kernels"].get(name) in ("tau_sweep", "tau_cluster"))
    if ctx["kind"] != "fit" or t <= 0 or not ctx["bounds"]["tau"]:
        return None
    return 100.0 * ctx["bounds"]["tau"] / (t * 1e3)
