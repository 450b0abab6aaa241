"""tpuvr_torch.utils.trace: the port's phase spans and its one counter
system, on the CPU (``device="cpu"``, the plain versions).

Off (no profiler, no ``recording()``), a span is a flag check: the fits
and frames here enter no ``record_function``. Under a profiler every
documented span is in the timeline, no two of them nest, each step's
request record holds its phases, and the numbers the spans wrap come out
bit for bit as they do with spans off.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpuvr_torch import cli
from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.io.synth import orbit_cameras, smoke_sphere
from tpuvr_torch.ops.render import prepare_grid, render_prepared
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.train.fit import fit_grid, render_all_views
from tpuvr_torch.utils import trace

N = 12
RES = 16
RCFG = RenderConfig(early_stop_eps=0.0)
LIGHT = LightingConfig(mode="lightvolume", n_samples=3)
STEP_SPANS = {"tpuvr.fit.gather", "tpuvr.fit.forward", "tpuvr.fit.loss",
              "tpuvr.fit.backward", "tpuvr.fit.adam"}
CALL_SPANS = {"tpuvr.fit.plan", "tpuvr.fit.draw", "tpuvr.fit.drain"}
RENDER_SPANS = {"tpuvr.render.plan", "tpuvr.render.sweep",
                "tpuvr.render.warp"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """8 orbit views (2 per sweep group) of the smoke sphere and their
    renders."""
    gt = smoke_sphere(N, device="cpu")
    cams = orbit_cameras(8, N, res=RES, elevation_deg=25.0)
    targets = render_all_views(gt, cams, RCFG, device="cpu")
    return gt, cams, targets


def _fit(scene, tmp_path, steps=3, lighting=None, **cfg_kw):
    gt, cams, targets = scene
    kw = dict(lr=2e-2, steps=steps, views_per_batch=2, ckpt_every=0, seed=3)
    kw.update(cfg_kw)
    _, params, hist = fit_grid(targets, cams, gt.shape, TrainConfig(**kw),
                               RCFG, run_dir=str(tmp_path), lighting=lighting,
                               device="cpu")
    return params, hist


def _frame(scene, lighting=None):
    gt, cams, _ = scene
    prep = prepare_grid(gt, axes=(dominant_axis(cams[0]),),
                        lighting=lighting, device="cpu")
    return render_prepared(prep, cams[0], RCFG, device="cpu")


def _spans(prof):
    """(start ns, end ns, thread, name) of the profile's ``tpuvr.*`` host
    events."""
    return sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
         e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CPU and e.name().startswith("tpuvr."))


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, its spans). A span run
    first with spans off, as any work between two profiled stretches
    would, makes the profiled stretch a recording period of its own."""
    with trace.span("tpuvr.unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_spans_off_enter_no_record_function(scene, tmp_path, monkeypatch):
    """No profiler and no recording(): a fit and a frame never reach
    record_function, and the (empty) period stays empty."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    with trace.recording():
        pass  # a fresh, empty period
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _fit(scene, tmp_path, lighting=LIGHT)
    _frame(scene, LIGHT)
    snap = trace.snapshot()
    assert snap["totals"] == snap["requests"] == {}
    assert snap["spans"] == snap["records"] == []


@pytest.mark.parametrize("lit", [False, True], ids=["plain", "lit"])
def test_fit_spans_in_the_profile_and_flat(scene, tmp_path, lit):
    """Every trainer span of a one-card fit is in the profile (the bake
    when lit; the fused mode's relayout and the checkpoint when plain, in
    blocks of 2 steps), on the main thread, and none nests in
    another; the snapshot's totals count the same spans."""
    if lit:
        want = CALL_SPANS | STEP_SPANS | {"tpuvr.fit.bake"}
        kw = dict(lighting=LIGHT)
    else:  # blocks of 2 steps: the fused mode
        want = CALL_SPANS | STEP_SPANS | {"tpuvr.fit.relayout",
                                          "tpuvr.fit.ckpt"}
        kw = dict(steps=4, ckpt_every=2, steps_per_call=2)
    _, spans = _profiled(lambda: _fit(scene, tmp_path, **kw))
    assert {s[3] for s in spans} == want
    assert len({s[2] for s in spans}) == 1
    for (a0, a1, _, na), (b0, b1, _, nb) in zip(spans, spans[1:]):
        assert a1 <= b0, (na, nb)
    totals = trace.snapshot()["totals"]
    assert set(totals) == want
    for name in want:
        assert totals[name]["count"] == sum(s[3] == name for s in spans)
        assert 0 < totals[name]["self_s"] <= totals[name]["host_s"]


def test_step_records_hold_their_phases(scene, tmp_path):
    """Each step's request record runs from its entry to its return and
    holds its phases, inside it and in order; the draw and the drain
    name the step they serve."""
    with trace.recording():
        _fit(scene, tmp_path, steps=3, lighting=LIGHT)
    snap = trace.snapshot()
    recs = snap["records"]
    assert [(r["kind"], r["id"]) for r in recs] == [("fit.step", i)
                                                   for i in range(3)]
    for r in recs:
        names = [ph[0] for ph in r["phases"]]
        assert names == ["tpuvr.fit.gather", "tpuvr.fit.forward",
                         "tpuvr.fit.bake", "tpuvr.fit.forward",
                         "tpuvr.fit.loss", "tpuvr.fit.backward",
                         "tpuvr.fit.adam"]
        ends = [t for ph in r["phases"] for t in ph[1:]]
        assert ends == sorted(ends)
        assert r["start_ns"] <= ends[0] and ends[-1] <= r["end_ns"]
    steps = snap["requests"]["fit.step"]
    assert steps["count"] == 3
    assert steps["host_s"] == pytest.approx(
        sum(r["end_ns"] - r["start_ns"] for r in recs) * 1e-9)
    draws = [s[3] for s in snap["spans"] if s[0] == "tpuvr.fit.draw"]
    drains = [s[3] for s in snap["spans"] if s[0] == "tpuvr.fit.drain"]
    assert draws == drains == [("fit.step", i) for i in range(3)]
    assert [s[3] for s in snap["spans"]
            if s[0] == "tpuvr.fit.plan"] == [None]


def test_spans_change_no_number(scene, tmp_path):
    """Losses and parameters bit for bit the same with spans on (under a
    profiler, and under recording()) and off."""
    runs = [_fit(scene, tmp_path / "off", lighting=LIGHT)]
    runs.append(_profiled(lambda: _fit(scene, tmp_path / "prof",
                                       lighting=LIGHT))[0])
    with trace.recording():
        runs.append(_fit(scene, tmp_path / "rec", lighting=LIGHT))
    (p0, h0) = runs[0]
    for p, h in runs[1:]:
        assert h["loss"] == h0["loss"]
        assert torch.equal(p, p0)
    frames = [_frame(scene, LIGHT), _profiled(lambda: _frame(scene, LIGHT))[0]]
    for a, b in zip(*frames):
        assert torch.equal(a, b)


def test_frame_and_prepare_spans(scene):
    """A lit prepare_grid and a frame: the prepare spans and the three
    render spans, flat, and the frame's request record holds the render
    spans; frames are numbered in turn."""
    (_, _), spans = _profiled(lambda: _frame(scene, LIGHT))
    assert [s[3] for s in spans] == ["tpuvr.prepare.bake",
                                     "tpuvr.prepare.layout",
                                     "tpuvr.render.plan",
                                     "tpuvr.render.sweep",
                                     "tpuvr.render.warp"]
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0]
    gt, cams, _ = scene
    prep = prepare_grid(gt, axes=(dominant_axis(cams[0]),), device="cpu")
    with trace.recording():
        for _ in range(3):
            render_prepared(prep, cams[0], RCFG, device="cpu")
    recs = trace.snapshot()["records"]
    assert [(r["kind"], r["id"]) for r in recs] == [("render.frame", i)
                                                   for i in range(3)]
    for r in recs:
        assert [ph[0] for ph in r["phases"]] == sorted(RENDER_SPANS)


def test_two_profiled_periods_two_snapshots(scene):
    """A period per profiled stretch: the second snapshot holds only the
    second stretch's frames."""
    gt, cams, _ = scene
    prep = prepare_grid(gt, axes=(dominant_axis(cams[0]),), device="cpu")

    def frames(n):
        for _ in range(n):
            render_prepared(prep, cams[0], RCFG, device="cpu")

    snaps = []
    for n in (2, 3):
        frames(1)  # unprofiled: spans off in between
        _profiled(lambda: frames(n))
        snaps.append(trace.snapshot())
    assert [s["requests"]["render.frame"]["count"] for s in snaps] == [2, 3]
    assert [s["totals"]["tpuvr.render.sweep"]["count"]
            for s in snaps] == [2, 3]
    assert [len(s["records"]) for s in snaps] == [2, 3]


def test_the_cli_profile_holds_the_render_spans(tmp_path, monkeypatch):
    """``cli.py bench --profile``'s Chrome trace names the frame's
    phases."""
    from tpuvr_torch.bench import sweep

    table = sweep.scaling_table
    monkeypatch.setattr(sweep, "scaling_table",
                        lambda *a, **k: table(*a, min_wall=0.05, **k))
    cli.main(["bench", "--config", "c1", "--scale", "0.125",
              "--device", "cpu", "--profile", str(tmp_path)])
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert RENDER_SPANS <= names


def test_launch_counts_one_system():
    """The module's counter holds every key of both readers, which read
    it: ``dist.workers.launch_counts`` without the row warp's and the
    ring's, ``chip_smoke.read_counts`` by kernel row."""
    import chip_smoke

    full = trace.launch_counts()
    assert {"warp_rows_fwd", "warp_rows_bwd", "sweep_bwd_ring"} <= set(full)
    old = workers.launch_counts()
    assert set(full) - set(old) == {"warp_rows_fwd", "warp_rows_bwd",
                                    "sweep_bwd_ring"}
    assert all(full[k] == n for k, n in old.items())
    rows = chip_smoke.read_counts()
    assert rows["sweep_bwd_ring"] == full["sweep_bwd_ring"]
    assert rows["tau_sweep"] == sum(n for k, n in full.items()
                                    if k.startswith("tau_sweep_c"))


def test_mesh_step_reduce_span(scene, tmp_path):
    """On a data mesh of two gloo ranks the step's gradient all-reduce is
    its own span, and the snapshot's launches hold the collectives the
    fit issued."""
    gt, cams, targets = scene
    cfg = TrainConfig(lr=2e-2, steps=2, views_per_batch=2, ckpt_every=0,
                      seed=3)
    case = dict(fn=workers.fit_case, targets=np.asarray(targets), cams=cams,
                grid_shape=tuple(gt.shape), cfg=cfg, render_cfg=RCFG,
                run_dir=str(tmp_path))
    out = launch.spawn(workers.run_suite, 2, "gloo", "cpu",
                       ([("fit", workers.traced_case, case, {})],),
                       timeout_s=120)
    for rank in out:
        _, snap = rank["fit"]
        assert set(snap["totals"]) == (CALL_SPANS | STEP_SPANS
                                       | {"tpuvr.fit.reduce"})
        assert snap["totals"]["tpuvr.fit.reduce"]["count"] == 2
        assert snap["launches"]["collective_all_reduce"] == 2 * (1 + 4)


def test_device_ms_leaves_out_the_spans(scene, tmp_path):
    """``chip_smoke.device_ms`` sums ``device_per_name``, which counts each
    kernel once: a span's key average is a user annotation, and where
    Kineto also gives it a device range over the kernels inside it (on the
    card), that range is skipped."""
    import types

    import chip_smoke

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(scene, tmp_path, steps=2)
    avgs = list(prof.key_averages())
    spans = [e for e in avgs if e.key.startswith("tpuvr.")]
    assert {e.key for e in spans} == CALL_SPANS | STEP_SPANS
    assert all(e.is_user_annotation for e in spans)
    assert chip_smoke.device_per_name(avgs, 2) == {}

    def on_card(key, us, annotation):
        return types.SimpleNamespace(key=key, device_type=DeviceType.CUDA,
                                     self_device_time_total=us,
                                     is_user_annotation=annotation)

    kernel = on_card("void sweep_fwd_kernel<4>(float const*)", 250.0, False)
    ranges = [on_card(e.key, 1000.0, True) for e in spans]
    assert chip_smoke.device_per_name([*avgs, kernel, *ranges], 2) == {
        "sweep_fwd_kernel": 0.125}


def test_counters_register_with_the_trace_module():
    """The trace module imports no counting module: each registers its
    reader when imported. A fresh process that imports the trace module
    alone reads no counter and loads nothing of ``tpuvr_torch.kernels``
    or ``tpuvr_torch.dist``; importing them brings their keys."""
    import pathlib
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from tpuvr_torch.utils import trace\n"
        "print(json.dumps([trace.launch_counts(), sorted(\n"
        "    m for m in sys.modules if m.startswith(('tpuvr_torch.kernels',\n"
        "                                            'tpuvr_torch.dist')))]))\n"
        "from tpuvr_torch.dist import init\n"
        "from tpuvr_torch.kernels import lighting, ring_bwd\n"
        "init.collectives['all_reduce'] += 2\n"
        "print(json.dumps(trace.launch_counts()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=pathlib.Path(__file__).parents[1])
    first, second = (json.loads(line)
                     for line in out.stdout.strip().splitlines())
    assert first == [{}, []]
    assert second["collective_all_reduce"] == 2
    assert {"tau_sweep_dirs", "tau_adj_dirs", "sweep_fwd", "sweep_bwd",
            "sweep_bwd_ring"} <= set(second)
