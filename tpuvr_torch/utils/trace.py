"""Phase spans and counters of the port, on the profiler's clock.

A span marks one phase of the host's work: the trainer's ``tpuvr.fit.*``
(``fit_grid``'s planning, draws, relayouts, loss readbacks and
checkpoints; each step's gather, forward, bake, loss, backward, reduce and
Adam), a frame's ``tpuvr.render.*`` (plan, sweep, warp) and
``prepare_grid``'s ``tpuvr.prepare.*`` (bake, layout), and the shadows'
backward ``tpuvr.light.adjoint`` (``ops.lighting``: the adjoint launch,
the relu masks and the directions' sum of an undetached bake). The spans
are flat: none encloses another, so a profiler's timeline names each
stretch of host time after the one phase it fell in. One exception:
``tpuvr.light.adjoint`` runs inside the backward, so it falls in time
inside ``tpuvr.fit.backward``; on the card it runs on autograd's own
thread, where no request is open.

Spans are on while a torch profiler runs, or inside :func:`recording`.
Off, :func:`span` checks the profiler's flag and returns a shared null
context: nothing is allocated or timed. On, the span is a
``torch.profiler.record_function`` while the profiler runs (so it lands
in the profiler's timeline, on the device trace's clock) and an in-memory
record of its name, its start and end (``time.perf_counter_ns``) and the
request it belongs to.

A request is one step of ``fit_grid`` (kind ``"fit.step"``, numbered by
the step) or one ``render_prepared`` call (``"render.frame"``, numbered in
turn): :func:`request` keeps its own start and end, and the spans that ran
inside it, as its request record. Spans outside a request name one
themselves, or belong to none.

:func:`snapshot` returns the latest recording period: exact totals by span
name and by request kind, the newest :data:`DETAIL` span and request
records, and the kernel launches and counted collectives since the
period began. A period begins where :func:`recording` is entered, or at
the first span that finds spans on after one that found them off.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled

DETAIL = 4096  # span and request records kept with their times, the newest

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()


_COUNTERS = []  # registered readers of the launch and collective counters


def counter(read):
    """Register ``read()``, which returns {name: count so far} of one
    module's kernel launches or collectives, for :func:`launch_counts`.
    Each counting module registers its own when it is imported, so this
    module imports none of them. Returns ``read``."""
    _COUNTERS.append(read)
    return read


def launch_counts():
    """This process's kernel launches and counted collectives so far, as a
    flat Counter: one-view sweeps ("sweep_fwd", "sweep_bwd"), view
    batches ("sweep_fwd_views", "sweep_bwd_views"), the light bake's
    launches by cluster size ("tau_sweep_c<size>", "tau_adj_c<size>"; size
    0 counts the plane loop's planes) and the directions they swept
    ("tau_sweep_dirs", "tau_adj_dirs"), the row warp's launches
    ("warp_rows_fwd", "warp_rows_bwd"), the lit grid's assembly
    ("light_apply_fwd", "light_apply_bwd", "light_apply_shadow_bwd",
    "light_apply_mask", "light_apply_fallback"), the
    differentiable light bakes and their backward passes ("light_shadow",
    "light_shadow_adjoint"), the ring backward's calls that
    launched K6 ("sweep_bwd_ring"), and each collective
    ("collective_<kind>"). Subtract two of them for what ran between. The
    counters live beside what they count, in ``tpuvr_torch.kernels`` and
    ``tpuvr_torch.dist.init``, and register with :func:`counter`; a module
    not yet imported has counted nothing."""
    out = collections.Counter()
    for read in _COUNTERS:
        out.update(read())
    return out


class _Period:
    """What one recording period has recorded."""

    def __init__(self):
        self.totals = {}  # span name -> [count, host ns]
        self.requests = {}  # request kind -> [count, host ns]
        self.spans = collections.deque(maxlen=DETAIL)
        self.records = collections.deque(maxlen=DETAIL)
        self.seq = collections.Counter()  # request numbers by kind
        self.launches = launch_counts()


class _Open(threading.local):
    """A thread's open request."""

    def __init__(self):
        self.request = None


class _Recorder:
    """The process's recording state: the latest period, whether the last
    span found spans on, the depth of :func:`recording` blocks, and each
    thread's open request."""

    def __init__(self):
        self.period = None
        self.on = False
        self.depth = 0
        self.open = _Open()

    def begin(self):
        self.period = _Period()
        self.on = True


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "request", "t0", "rf")

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        if not _REC.on:
            _REC.begin()
        if _REC.open.request is not None:
            self.request = _REC.open.request.key
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _LOCK:
            p = _REC.period
            tot = p.totals.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += t1 - self.t0
            p.spans.append((self.name, self.t0, t1, self.request))
            if _REC.open.request is not None:
                _REC.open.request.phases.append((self.name, self.t0, t1))
        return False


class _Request:
    __slots__ = ("kind", "number", "key", "t0", "phases", "outer")

    def __init__(self, kind, number):
        self.kind, self.number = kind, number

    def __enter__(self):
        if not _REC.on:
            _REC.begin()
        with _LOCK:
            p = _REC.period
            if self.number is None:
                self.number = p.seq[self.kind]
            p.seq[self.kind] += 1
        self.key = (self.kind, self.number)
        self.phases = []
        self.outer = _REC.open.request
        _REC.open.request = self
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _REC.open.request = self.outer
        with _LOCK:
            p = _REC.period
            tot = p.requests.setdefault(self.kind, [0, 0])
            tot[0] += 1
            tot[1] += t1 - self.t0
            p.records.append({"kind": self.kind, "id": self.number,
                              "start_ns": self.t0, "end_ns": t1,
                              "phases": self.phases})
        return False


def span(name: str, request=None):
    """A context manager marking one phase of the host's work as ``name``.

    ``request`` (a (kind, number) pair) names the request a span outside
    any open :func:`request` belongs to; inside one, the span belongs to
    that. Off (no profiler running, no :func:`recording`), a flag check
    and a shared null context."""
    if _REC.depth or _profiler_enabled():
        return _Span(name, request)
    _REC.on = False
    return _NULL


def request(kind: str, number=None):
    """A context manager around one request, a step ("fit.step", its step
    number) or a frame ("render.frame", numbered in turn when ``number``
    is None): its start and end and the spans inside it become its request
    record. Off, as :func:`span`."""
    if _REC.depth or _profiler_enabled():
        return _Request(kind, number)
    _REC.on = False
    return _NULL


@contextlib.contextmanager
def recording():
    """Spans on inside, with or without a profiler: a new recording period
    begins on entry (host totals by phase without a profiler's cost)."""
    _REC.begin()
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def snapshot() -> dict:
    """The latest recording period (empty where none began):

    - ``totals``: {span name: {"count", "host_s", "self_s"}}, exact; the
      spans are flat, so a span's self time is its host time (the one
      span on autograd's thread is left inside ``tpuvr.fit.backward``'s);
    - ``requests``: {kind: {"count", "host_s"}}, exact, of the request
      records (a step from its entry to its return, a frame likewise);
    - ``spans``: the newest :data:`DETAIL` spans as (name, start ns, end ns,
      request) with request a (kind, number) pair or None;
    - ``records``: the newest :data:`DETAIL` request records, each
      {"kind", "id", "start_ns", "end_ns", "phases": [(name, start ns, end
      ns), ...]};
    - ``launches``: the kernel launches and counted collectives since the
      period began (:func:`launch_counts`; since the process started where
      no period did), those that ran.
    """
    with _LOCK:
        p = _REC.period
        if p is None:
            return {"totals": {}, "requests": {}, "spans": [], "records": [],
                    "launches": dict(+launch_counts())}
        return {
            "totals": {n: {"count": c, "host_s": h * 1e-9, "self_s": h * 1e-9}
                       for n, (c, h) in p.totals.items()},
            "requests": {k: {"count": c, "host_s": h * 1e-9}
                         for k, (c, h) in p.requests.items()},
            "spans": list(p.spans),
            "records": [dict(r, phases=list(r["phases"])) for r in p.records],
            "launches": dict(launch_counts() - p.launches),
        }
