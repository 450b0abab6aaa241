"""``python -m tpuvr_torch.cli`` on ``--device cpu`` (the plain PyTorch
versions), each command at a ``--scale`` that gives 8^3-16^3, held
against the port's own entry points and the JAX package's ``tpuvr.cli``.

Tolerances: ``render`` equal to ``render_view`` bit for bit (the same
calls) and its PNG to ``tonemap`` of the image; ``fit``'s loss equal to a
direct ``fit_grid`` call's and within 1e-5 relative of the JAX package's
``fit_grid`` (f32 roundoff of two implementations); on 2 gloo ranks within
1e-5 relative of one process (the tiles' and gradient's sums);
``gradcheck``'s error below twice the JAX command's on the same arguments
(both are mostly the f32 central difference's).
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import configs as jconfigs
from chip_smoke import read_png
from tpuvr import cli as jcli
from tpuvr.io.synth import orbit_cameras as jorbit_cameras
from tpuvr.io.synth import smoke_sphere as jsmoke_sphere
from tpuvr.train import fit as jfit
from tpuvr_torch import cli, configs
from tpuvr_torch.dist import launch
from tpuvr_torch.io.image import to_uint8
from tpuvr_torch.io.synth import orbit_cameras, smoke_sphere
from tpuvr_torch.ops.render import render_view
from tpuvr_torch.train import fit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("config,scale", [("c1", 0.125), ("c2", 0.0625),
                                          ("c3", 0.03125)])
def test_render_equals_render_view(tmp_path, capsys, config, scale):
    out = tmp_path / "frame.png"
    rgb = cli.main(["render", "--config", config, "--scale", str(scale),
                    "--device", "cpu", "--out", str(out)])
    cfg = configs.CONFIGS[config]
    n = max(8, int(cfg["grid_n"] * scale))
    res = max(8, int(cfg["res"] * scale))
    assert n <= 16
    ref, _ = render_view(smoke_sphere(n, device="cpu"),
                         configs.CAMERAS[cfg["camera"]](n, res),
                         cfg["render"], lighting=cfg["lighting"],
                         device="cpu")
    np.testing.assert_array_equal(rgb, ref.numpy())
    np.testing.assert_array_equal(read_png(out), to_uint8(rgb))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"rendered {res}x{res} in ")
    assert lines[0].endswith(f"mean {rgb.mean():.4f}")
    assert lines[1] == f"wrote {out}"


def test_turntable_writes_every_frame(tmp_path, capsys):
    out_dir = tmp_path / "tt"
    rec = cli.main(["turntable", "--config", "c2", "--scale", "0.0625",
                    "--device", "cpu", "--frames", "3",
                    "--out-dir", str(out_dir)])
    assert rec["frames"] == 3 and rec["out_dir"] == str(out_dir)
    assert _json_lines(capsys.readouterr().out) == [rec]
    cams = orbit_cameras(3, 8, res=16)
    grid = smoke_sphere(8, device="cpu")
    for i, cam in enumerate(cams):
        ref, _ = render_view(grid, cam, configs.CONFIGS["c2"]["render"],
                             device="cpu")
        np.testing.assert_array_equal(
            read_png(out_dir / f"frame_{i:04d}.png"), to_uint8(ref))


FIT_VIEWS = 16  # c4's 64 cut to 16: 4 of each of its 4 view groups


def _fit_argv(run_dir):
    return ["fit", "--config", "c4", "--scale", "0.0625", "--device", "cpu",
            "--steps", "2", "--run-dir", str(run_dir),
            "--set", f"n_views={FIT_VIEWS}"]


def test_fit_matches_fit_grid_and_jax(tmp_path, capsys):
    """The command's loss is a direct ``fit_grid`` call's, and the JAX
    package's ``fit_grid(mesh=None)`` on the same scene and views."""
    rec = cli.main(_fit_argv(tmp_path / "cli"))
    out = capsys.readouterr().out
    assert _json_lines(out) == [rec]
    assert "mesh=None" in out and rec["steps"] == 2
    c4 = configs.CONFIGS["c4"]
    n, res, n_views = 16, 16, FIT_VIEWS
    tcfg = dataclasses.replace(c4["train"], steps=2)
    cams = orbit_cameras(n_views, n, res=res)
    targets = fit.render_all_views(smoke_sphere(n, device="cpu"), cams,
                                   c4["render"], device="cpu")
    grid, _, hist = fit.fit_grid(targets, cams, (n, n, n, 4), tcfg,
                                 c4["render"], run_dir=str(tmp_path / "t"),
                                 device="cpu")
    assert rec["final_loss"] == hist["loss"][-1]
    assert rec["psnr_db"] == fit.evaluate_psnr(grid, cams, targets,
                                               c4["render"], device="cpu")
    jc4 = jconfigs.load("c4")
    jcams = jorbit_cameras(n_views, n, res=res)
    jtargets = jfit.render_all_views(jsmoke_sphere(n), jcams, jc4["render"])
    _, _, jhist = jfit.fit_grid(
        jtargets, jcams, (n, n, n, 4),
        dataclasses.replace(jc4["train"], steps=2), jc4["render"],
        run_dir=str(tmp_path / "j"))
    assert abs(rec["final_loss"] - jhist["loss"][-1]) <= (
        1e-5 * jhist["loss"][-1])


def test_fit_on_two_ranks_matches_one(tmp_path, capsys):
    """The body a multi-card fit runs on each rank, here on 2 gloo ranks
    on the CPU over a 'data' mesh: rank 0's record against one process."""
    one = cli.main(_fit_argv(tmp_path / "one"))
    args = argparse.Namespace(
        config="c4", scale=0.0625, device="cpu",
        sets=[f"n_views={FIT_VIEWS}"], steps=2,
        run_dir=str(tmp_path / "mesh"), resume=False)
    ranks = launch.spawn(cli._fit_rank, 2, "gloo", "cpu", (args, 1),
                         timeout_s=240)
    assert ranks[0]["steps"] == ranks[1]["steps"] == 2
    assert ranks[0]["final_loss"] == ranks[1]["final_loss"]
    assert abs(ranks[0]["final_loss"] - one["final_loss"]) <= (
        1e-5 * one["final_loss"])
    assert abs(ranks[0]["psnr_db"] - one["psnr_db"]) <= 1e-3


def test_fit_layout_without_cards():
    """One card or the CPU: no mesh, whatever the config's."""
    for name in ("c4", "c5", "c1"):
        assert cli._fit_layout(dict(configs.CONFIGS[name]), "cpu") == (1, 1)


def test_bench_profiles_and_reports(tmp_path, capsys, monkeypatch):
    """The trace, the one-card row and the roofline report, each naming
    the device (the scaling loop cut to 50 ms of frames from 2 s)."""
    from tpuvr_torch.bench import sweep

    table = sweep.scaling_table
    monkeypatch.setattr(sweep, "scaling_table",
                        lambda *a, **k: table(*a, min_wall=0.05, **k))
    trace = tmp_path / "trace"
    recs = cli.main(["bench", "--config", "c1", "--scale", "0.125",
                     "--device", "cpu", "--profile", str(trace)])
    assert _json_lines(capsys.readouterr().out) == recs
    assert recs[0] == {"trace_dir": str(trace)}
    assert os.path.getsize(trace / "trace.json") > 0
    row, rep = recs[1], recs[-1]
    assert row["devices"] == 1 and row["ms_per_frame"] > 0
    assert row["device"] == rep["device"] == "cpu"
    assert rep["chip"] == "h100_sxm" and 0.0 < rep["active_fraction"] <= 1.0


def test_bench_refuses_a_tpu_chip(capsys):
    with pytest.raises(SystemExit):
        cli.main(["bench", "--chip", "v5e", "--device", "cpu"])
    assert "h100_sxm" in capsys.readouterr().err


SETS = [["ert_chunks=8", "steps_per_call=16", "grid_n=128"],
        ["max_rows_per_call=None", "use_occupancy=false", "lr=0.5",
         "precision=default", "n_views=12"],
        ["oversample=2", "rays_per_view=4096", "seed=3"]]


def _overridden(apply, cfg, sets):
    """(the overridden config, None) or (None, the SystemExit's message)."""
    try:
        return apply(dict(cfg), sets), None
    except SystemExit as e:
        return None, str(e)


@pytest.mark.parametrize("sets", SETS, ids=str)
def test_overrides_match_jax(sets):
    """Each package's overrides on c3, c4 and c5 (c3 has no train fields:
    both refuse ``steps_per_call`` with one message)."""
    for name in ("c4", "c3", "c5"):
        ours, our_err = _overridden(cli._apply_overrides,
                                    configs.CONFIGS[name], sets)
        theirs, their_err = _overridden(jcli._apply_overrides,
                                        jconfigs.load(name), sets)
        assert our_err == their_err
        if theirs is None:
            continue
        for slot in ("render", "train", "lighting", "mesh_cfg"):
            if theirs.get(slot) is None:
                continue
            assert (dataclasses.asdict(ours[slot])
                    == dataclasses.asdict(theirs[slot])), (name, slot)
        for key in ("grid_n", "res", "n_views"):
            assert ours.get(key) == theirs.get(key)


@pytest.mark.parametrize("bad", ["ert_chunks", "no_such_field=1"])
def test_override_errors_match_jax(bad):
    with pytest.raises(SystemExit) as theirs:
        jcli._apply_overrides(dict(jconfigs.load("c1")), [bad])
    with pytest.raises(SystemExit) as ours:
        cli._apply_overrides(dict(configs.CONFIGS["c1"]), [bad])
    assert str(ours.value) == str(theirs.value)


def test_set_reaches_the_render(tmp_path):
    """``--set oversample=2`` changes the rendered frame (c2's orbit
    camera) as ``render_view`` at oversample 2 renders it."""
    rgb = cli.main(["render", "--config", "c2", "--scale", "0.0625",
                    "--device", "cpu", "--set", "oversample=2"])
    cfg = dataclasses.replace(configs.CONFIGS["c2"]["render"], oversample=2.0)
    ref, _ = render_view(smoke_sphere(8, device="cpu"),
                         configs.orbit_persp(8, 16), cfg, device="cpu")
    np.testing.assert_array_equal(rgb, ref.numpy())


def test_gradcheck_against_jax(capsys):
    argv = ["gradcheck", "--grid-n", "8", "--res", "8"]
    ours = cli.main(argv + ["--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [ours]
    jcli.main(argv + ["--impl", "xla"])
    (theirs,) = _json_lines(capsys.readouterr().out)
    assert ours["probes"] == theirs["probes"] == 10
    assert ours["max_abs_err_vs_fd"] < 2 * theirs["max_abs_err_vs_fd"]
