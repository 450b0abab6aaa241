"""Readings that more than one metric takes, each for its own cells; a
metric's file under ``vrbench/metrics/`` names the one it reads.

``ctx`` is the run's readings: ``setup_s``, ``peak_bytes``, the untraced
window's ``window_s`` and ``steps`` (fit) or ``frames`` and ``latency_s``
(viewer); in a traced run also the profiled call's ``trace_steps`` or
``trace_frames``, its ``trace`` summary, the least ms of its stages
(``bounds``, :mod:`vrbench.work`) and the program's kernels by source
(``kernels``). A reader returns None where the run has nothing for it.
"""

from __future__ import annotations

from vrbench.trace import is_nccl


def step_ms(ctx):
    """The window's wall time over its steps."""
    return ctx["window_s"] / ctx["steps"] * 1e3


def idle_share(ctx):
    """Share of the traced span in which no kernel ran on the card (rank
    0's on a mesh)."""
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def sweep_roofline_fit(ctx):
    """The profiled steps' forward and backward sweep bounds over the
    device seconds of the kernels of ``sweep_fwd.cu`` and ``sweep_bwd.cu``
    (K1/K5, K3/K6)."""
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if ctx["kernels"].get(name) in ("sweep_fwd", "sweep_bwd"))
    if ctx["kind"] != "fit" or t <= 0:
        return None
    b = ctx["bounds"]
    return 100.0 * (b["sweep_fwd"] + b["sweep_bwd"]) / (t * 1e3)


def passes_ms_fit(ctx):
    """Device ms per profiled step in every kernel that is neither the
    system's own (``tpuvr_torch/csrc``) nor NCCL's: ATen's copies,
    elementwise and reduction kernels, Adam, memcpy and memset."""
    if ctx["kind"] != "fit" or not ctx.get("trace_steps"):
        return None
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if name not in ctx["kernels"] and not is_nccl(name))
    return t * 1e3 / ctx["trace_steps"]


def mfu_fit(ctx):
    """The step's least time (sweeps, bake, Adam; a profiled step's mean)
    over the untraced window's ``step_ms``."""
    if ctx["kind"] != "fit" or not ctx.get("trace_steps"):
        return None
    b = ctx["bounds"]
    least = (b["sweep_fwd"] + b["sweep_bwd"] + b["tau"] + b["adam"]) \
        / ctx["trace_steps"]
    return 100.0 * least / step_ms(ctx)
