"""The harness on the CPU at 16^3: it finds a cell's files by name, and a
run whose timed path is broken underneath, or that runs in the control's
lower precision, comes out not correct."""

import json
import multiprocessing

import pytest
import torch

from conftest import run_cell


def test_every_cell_runs_correct_on_the_cpu(tiny, capsys):
    for w in tiny.bench["workloads"]:
        if w["chips"] > 1:
            continue
        for trace in (0, 1):
            rc, res = run_cell(tiny, w["name"], capsys, trace=trace)
            assert rc == 0 and res["correct"], (w["name"], res)
            names = {m["name"] for m in tiny.metrics(
                w["name"], "per_layer" if trace else "end_to_end")}
            assert set(res["metrics"]) <= names
            assert list(res)[-1] == "check"
            if not trace:
                assert set(res["metrics"]) == names


def test_a_new_config_mix_and_metric_are_found_by_name(tiny, capsys):
    """Throwaway cells from data files alone: a configuration that runs
    the fit with checkpoints on, a mix of it on a ring of more poses than
    the system's geometry cache holds, and a metric of each kind."""
    here = tiny.here
    cfg = json.loads((here / "configs" / "c4.json").read_text())
    cfg.update(name="c4-small", n_views=8, ckpt_every=2)
    (here / "configs" / "c4-small.json").write_text(json.dumps(cfg))
    (here / "traffic" / "fit-copy.json").write_text(
        (here / "traffic" / "fit.json").read_text())
    mix = json.loads((here / "traffic" / "orbit.json").read_text())
    mix.update(poses=20, warmup_rounds=2, check_frames=4)
    (here / "traffic" / "orbit-free.json").write_text(json.dumps(mix))
    (here / "metrics" / "window_steps.fit.py").write_text(
        "def read(ctx):\n    return ctx['trace_steps']\n")
    (here / "metrics" / "steps_per_s.py").write_text(
        "def read(ctx):\n    return ctx['steps'] / ctx['window_s']\n")
    for cell in ("c4-small-fit", "c4-small-orbit"):
        (here / "limits" / f"{cell}.json").write_text(
            (here / "limits" / "c4-fit.json").read_text()
            if cell.endswith("fit") else
            (here / "limits" / "c5-orbit.json").read_text())
    bench = tiny.bench
    bench["configs"].append(dict(bench["configs"][0], name="c4-small",
                                 file="vrbench/configs/c4-small.json"))
    bench["workloads"] += [
        {"name": "c4-small-fit", "config": "c4-small", "traffic": "fit-copy",
         "chips": 1, "why": "a throwaway cell"},
        {"name": "c4-small-orbit", "config": "c4-small",
         "traffic": "orbit-free", "chips": 1, "why": "a throwaway cell"}]
    bench["end_to_end"].append({
        "name": "steps_per_s", "unit": "steps/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": ["c4-small-fit"]})
    bench["per_layer"].append({
        "name": "window_steps.fit", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "trainer",
        "moves": "steps_per_s", "workloads": ["c4-small-fit"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("step_ms", "frame_ms", "frame_p95_ms"):
            m["workloads"].append(
                "c4-small-fit" if m["name"] == "step_ms" else "c4-small-orbit")
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(bench))
    from vrbench.spec import Spec

    spec = Spec(tiny.root)
    rc, res = run_cell(spec, "c4-small-fit", capsys)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["steps_per_s"]["value"] > 0
    rc, res = run_cell(spec, "c4-small-fit", capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["window_steps.fit"]["value"] > 0
    assert "window_steps.fit" not in run_cell(spec, "c4-fit", capsys,
                                              trace=1)[1]["metrics"]
    rc, res = run_cell(spec, "c4-small-orbit", capsys)
    assert rc == 0 and res["correct"], res["check"]
    assert res["attempted"] % 20 == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "peak_gib",
                                   "setup_s"}


@pytest.mark.parametrize("workload", ["c4-fit", "c5-fit", "c5-orbit"])
def test_the_control_is_not_correct(tiny, capsys, workload):
    """The control: the system's bf16 'default' tier where the
    configuration states 'highest'."""
    name = tiny.workload(workload)["config"]
    path = tiny.here / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    cfg["precision"] = "default"
    path.write_text(json.dumps(cfg))
    rc, res = run_cell(tiny, workload, capsys)
    assert rc == 0 and not res["correct"], res["check"]


def _unchanged(monkeypatch):
    from tpuvr_torch.train import fit

    monkeypatch.setattr(fit.Adam, "update",
                        lambda self, g, s: (torch.zeros_like(g), s))


def _half_batch(monkeypatch):
    """Half the minibatch's views left out, the mean over the rest; a
    one-view minibatch loses half its image rows."""
    from tpuvr_torch.train import fit

    real = fit.make_train_step

    def make(key, n_views, *a, **k):
        if n_views == 1:
            return real(key, n_views, *a, **k)
        h = n_views // 2
        step = real(key, h, *a, **k)
        return lambda p, s, g, t, pick, r0s: step(p, s, g, t, pick[:h],
                                                  r0s[:h])

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def mean(x, *a, **k):
            if x.dim() == 3 and not a and not k:
                return torch.mean(x[:x.shape[0] // 2])
            return torch.mean(x, *a, **k)

    monkeypatch.setattr(fit, "make_train_step", make)
    monkeypatch.setattr(fit, "torch", Torch())


def _altered(monkeypatch):
    """Every image the sweep produces scaled by 1.01, where it is made."""
    from tpuvr_torch.ops import render
    from tpuvr_torch.train import fit

    real_op = fit.sweep_op

    def sweep_op(*a, **k):
        op = real_op(*a, **k)

        def altered(*args):
            rgb, trans = op(*args)
            return rgb * 1.01, trans
        return altered

    real_frame = render.render_prepared

    def frame(*a, **k):
        rgb, trans = real_frame(*a, **k)
        rgb = rgb.clone()
        rgb[0, 0, 0] += 0.05
        return rgb, trans

    monkeypatch.setattr(fit, "sweep_op", sweep_op)
    monkeypatch.setattr(render, "render_prepared", frame)


def _no_exchange(monkeypatch):
    from tpuvr_torch.train import fit

    monkeypatch.setattr(fit, "bucketed_all_reduce", lambda g, mesh, n=4: g)


CASES = [("c4-fit", _unchanged), ("c4-fit", _half_batch),
         ("c4-fit", _altered), ("c5-fit", _unchanged),
         ("c5-fit", _half_batch), ("c5-fit", _altered),
         ("c5-orbit", _altered), ("c5-fit-x4", _no_exchange)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                            workload, fault):
    fault(monkeypatch)
    if tiny.workload(workload)["chips"] > 1:
        # the ranks inherit the fault planted in this process
        fork = multiprocessing.get_context("fork")
        monkeypatch.setattr(multiprocessing, "get_context",
                            lambda method=None: fork)
    rc, res = run_cell(tiny, workload, capsys)
    assert rc == 0 and not res["correct"], res["check"]


def test_a_rank_that_loads_the_jax_package_prints_no_result(
        tiny, capsys, monkeypatch):
    """Each rank reads its own modules once its window has closed."""
    import sys

    from vrbench import fitjob

    real = fitjob.run

    def run(*a, **k):
        out = real(*a, **k)
        sys.modules["tpuvr.planted"] = sys
        return out

    monkeypatch.setattr(fitjob, "run", run)
    fork = multiprocessing.get_context("fork")
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda method=None: fork)
    rc, res = run_cell(tiny, "c5-fit-x4", capsys)
    assert "tpuvr.planted" not in sys.modules  # the ranks', not this one's
    assert rc == 3 and res is None


def test_the_mesh_cell_runs_correct_on_gloo(tiny, capsys):
    rc, res = run_cell(tiny, "c5-fit-x4", capsys)
    assert rc == 0 and res["correct"], res["check"]
    assert res["device"]["count"] == 4
