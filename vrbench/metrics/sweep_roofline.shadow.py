"""Share of the sweeps' least time in their device time, in a shadow
fit's profiled call: the forward and backward sweep bounds of
:func:`vrbench.fitjob.bounds` over the device seconds of the kernels of
``sweep_fwd.cu`` and ``sweep_bwd.cu`` (K1, K3)."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if ctx["kernels"].get(name) in ("sweep_fwd", "sweep_bwd"))
    if ctx["kind"] != "shadowfit" or t <= 0:
        return None
    b = ctx["bounds"]
    return 100.0 * (b["sweep_fwd"] + b["sweep_bwd"]) / (t * 1e3)
