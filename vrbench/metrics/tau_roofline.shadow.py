"""Share of the light's least time in its device time, in a shadow fit's
profiled call: the bake's bound (density read once, each direction's
optical depth written once; ``vrbench/work.py``) and its adjoint's
(each direction's cotangent read once and its gradient written once;
``vrbench/shadowwork.py``), every step, over the device seconds of the
kernels of ``tau_sweep.cu``, ``tau_adj.cu`` and ``tau_cluster.cuh`` (K2
and K4, which share the cluster kernel)."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if ctx["kernels"].get(name) in ("tau_sweep", "tau_adj",
                                            "tau_cluster"))
    if ctx["kind"] != "shadowfit" or t <= 0:
        return None
    b = ctx["bounds"]
    return 100.0 * (b["tau"] + b["tau_adj"]) / (t * 1e3)
