"""torch.profiler over a traced run's profiled call, which follows the
untraced window: reduced to what the per-layer readers and the breakdown
need: device seconds by kernel, the device's busy time inside the traced
span, and its idle gaps by what the host was doing then.

The traced span is :data:`SPAN`, which the benchmark's loop opens around
its calls into the system. A device interval counts as far
as it lies inside that span. A gap is attributed to the outermost host
operation running at its midpoint (an ATen operator, a CUDA runtime call,
or the autograd engine's function on its own thread), or to ``python``
when none was.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from pathlib import Path

import torch

SPAN = "vrbench.window"
SECONDS = 12  # the traced call's length at most: a steady part that reads in time
_KERNEL = re.compile(r"(\w+)(?:<[^()]*>)?\(")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")


def kernel_name(key: str) -> str:
    """The function name of a device event (a demangled kernel signature),
    or the key itself cut to 48 characters (a memcpy or memset)."""
    m = _KERNEL.search(key)
    return m.group(1) if m else key[:48]


def program_kernels(root: Path) -> dict:
    """{kernel name: source stem} of every ``__global__`` function in the
    system's CUDA sources (``tpuvr_torch/csrc``): the port's own kernels."""
    out = {}
    for path in sorted((Path(root) / "tpuvr_torch" / "csrc").glob("*.cu*")):
        for name in _GLOBAL.findall(path.read_text()):
            out[name] = path.name.split(".")[0]
    return out


def is_nccl(name: str) -> bool:
    return name.startswith("nccl")


@contextlib.contextmanager
def window():
    """Profile (CPU and CUDA activity) inside, the whole marked by
    :data:`SPAN`; yields a holder whose ``prof`` is the profiler once the
    block has ended."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Window", (), {"prof": None})()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            yield holder
    holder.prof = prof


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(cpu):
    """Each thread's outermost events and its :data:`SPAN`'s children, from
    (start, end, thread, name) tuples."""
    out = []
    for thread in {c[2] for c in cpu}:
        open_ends = []
        for a, b, _, name in sorted(c for c in cpu if c[2] == thread):
            while open_ends and open_ends[-1][0] <= a:
                open_ends.pop()
            if not open_ends or open_ends[-1][1] == SPAN:
                if name != SPAN:
                    out.append((a, b, name))
            open_ends.append((b, name))
    return sorted(out)


def summarize(prof) -> dict:
    """{"window_s", "busy_s", "by_kernel": {name: s}, "gaps": {host op:
    s}} of a profiled window, read from the profiler's raw events (the
    event tree that ``prof.events()`` builds costs minutes at the window's
    size)."""
    from torch.autograd import DeviceType

    cpu, device, by_kernel = [], [], {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == SPAN:
                spans.append((a, b))
            cpu.append((a, b, e.start_thread_id(), name))
        elif not (name == SPAN or getattr(e, "is_user_annotation",
                                          lambda: False)()):
            device.append((a, b, kernel_name(name)))
    w0 = min(a for a, _ in spans)
    w1 = max(b for _, b in spans)
    kept = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) * 1e-6
            kept.append((a, b))
    busy = _merge(kept)
    host = [h for h in _top_level(cpu) if h[1] > w0 and h[0] < w1]
    starts = [h[0] for h in host]
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "python"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 65, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "by_kernel": by_kernel, "gaps": gaps}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
