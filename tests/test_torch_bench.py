"""tpuvr_torch.bench on the CPU: the roofline's counts against the JAX
package's and against the sweep's own work, the judged core at its CPU
size, the f64 gradient oracle against the JAX benchmark's, and the scaling
table on a 2-rank gloo mesh."""

import ast
import dataclasses
import math
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tpuvr.bench import roofline as jroof
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.ref import camera as jcam
from tpuvr_torch import configs as tconfigs
from tpuvr_torch.bench import judged
from tpuvr_torch.bench import roofline as troof
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.ops import render as trender
from tpuvr_torch.train.fit import Adam


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Hundreds of small ops a frame or step: one thread per test worker
    runs them far faster than pools oversubscribed by the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cam(jc):
    return camera_from_fields(type(jc).__name__, **dataclasses.asdict(jc))


def _bench_fields():
    """The keys of bench.py's JSON line: the judged core's and the
    extended set's."""
    tree = ast.parse(Path(bench.__file__).read_text())
    core = extended = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                core = keys
            elif "fwd_f32_rays_per_s" in keys:
                extended = keys
    return core, extended


CORE, EXTENDED = _bench_fields()
# The port's line adds the kernels' gradient against the plain version's
# and the oracle's scale.
PORT_ONLY = {"pixel_grad_compiled_vs_plain", "pixel_grad_oracle_max_abs"}

SHAPES = [(64, 64, 64, 256, 256), (24, 16, 20, 32, 40)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sweep_cost_bytes_match_jax(shape, backward):
    for af in (1.0, 0.25):
        _, want = jroof.sweep_cost(*shape, active_fraction=af,
                                   backward=backward)
        _, got = troof.sweep_cost(*shape, active_fraction=af,
                                  backward=backward)
        assert got == want


def _sweep_args(jc, n, cfg=RenderConfig()):
    grid = trender.prepare_grid(torch.as_tensor(np.array(smoke_sphere(n))),
                                device="cpu")
    return trender.sweep_inputs(grid, _port_cam(jc), cfg, "cpu")


CAMS = {
    "ortho": tconfigs.front_ortho(20, 24),
    "perspective": jcam.look_at_perspective((9.5, 9.5 - 60.0, 23.0),
                                            (9.5, 9.5, 9.5), res_x=24,
                                            res_y=20),
}


@pytest.mark.parametrize("name", sorted(CAMS))
def test_sweep_cost_flops_count_the_support(name):
    plan, _, args = _sweep_args(CAMS[name], 20)
    shape = (plan.n_planes, 20, 20, plan.n_v, plan.n_u)
    support = troof.support_samples(args)
    assert 0 < support < plan.n_planes * plan.n_v * plan.n_u
    flops, _ = troof.sweep_cost(*shape, args=args)
    assert flops == troof.SWEEP_FLOPS_PER_SAMPLE * support
    flops, _ = troof.sweep_cost(*shape, args=args, backward=True)
    assert flops == (troof.SWEEP_FLOPS_PER_SAMPLE
                     + troof.BWD_FLOPS_PER_SAMPLE) * support
    # Without the arguments, the upper bound: every ray-slice.
    flops, _ = troof.sweep_cost(*shape, active_fraction=0.5)
    assert flops == troof.SWEEP_FLOPS_PER_SAMPLE * 0.5 * math.prod(
        shape[:1] + shape[3:])
    # The kernel-table bounds count the same samples.
    _, ops_ms = troof.sweep_fwd_bound(args)
    assert ops_ms == pytest.approx(troof.SWEEP_FLOPS_PER_SAMPLE * support
                                   / troof.F32_FLOP_PER_S * 1e3)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("name", sorted(CAMS))
def test_roofline_never_beats_its_bound(name, backward):
    plan, _, args = _sweep_args(CAMS[name], 20)
    shape = (plan.n_planes, 20, 20, plan.n_v, plan.n_u)
    sol = troof.roofline_report(1.0, *shape, backward=backward,
                                args=args)["speed_of_light_s"]
    assert sol > 0.0
    for factor in (1.0, 1.5, 1e3):
        rep = troof.roofline_report(sol * factor, *shape, backward=backward,
                                    args=args)
        assert 0.0 < rep["sol_fraction"] <= 1.0
        assert rep["sol_fraction"] == pytest.approx(1.0 / factor)
        assert rep["chip"] == "h100_sxm" and rep["bound"] in ("compute",
                                                              "memory")
    # The same peak at every tier: no kernel uses the tensor cores.
    for precision in ("default", "high"):
        assert troof.roofline_report(sol, *shape, precision=precision,
                                     backward=backward, args=args)[
            "speed_of_light_s"] == sol


def _ortho16(n=16):
    c = (n - 1) / 2.0
    return jcam.OrthoCamera(center=(c, c, -2.0 * n), forward=(0.0, 0.0, 1.0),
                            up=(0.0, 1.0, 0.0), width=1.4 * n,
                            height=1.4 * n, res_x=16, res_y=16)


@pytest.mark.parametrize("occupancy", [True, False])
@pytest.mark.parametrize("cam", ["ortho", "perspective", "fly_through"])
def test_measured_active_fraction_matches_jax(cam, occupancy):
    """Includes the JAX package's sparse scene (density in a quarter of
    the slices: 0.25 of the dense one)."""
    n = 16
    c = (n - 1) / 2.0
    jc = {"ortho": _ortho16(n),
          "perspective": jcam.look_at_perspective(
              (c, c - 3.0 * n, c + 0.7 * n), (c, c, c), res_x=16, res_y=16),
          "fly_through": jcam.look_at_perspective(
              (c, c + 0.1, c - 0.3 * n), (c + 0.5, c, n + 5.0), res_x=16,
              res_y=16)}[cam]
    dense = np.ones((n, n, n, 4), np.float32)
    sparse = dense.copy()
    sparse[n // 4:, :, :, 0] = 0.0
    jcfg = JRenderConfig(use_occupancy=occupancy)
    tcfg = RenderConfig(use_occupancy=occupancy)
    for grid in (dense, sparse):
        want = jroof.measured_active_fraction(jnp.asarray(grid), jc, jcfg)
        got = troof.measured_active_fraction(torch.as_tensor(grid),
                                             _port_cam(jc), tcfg)
        assert got == pytest.approx(want, abs=1e-7)
    if cam == "ortho":
        assert troof.measured_active_fraction(
            torch.as_tensor(sparse), _port_cam(jc), tcfg) == (
            0.25 if occupancy else 1.0)


@pytest.fixture(scope="module")
def smoke_line():
    return judged.run(device="cpu", smoke=True)


def test_judged_run_returns_the_bench_line(smoke_line):
    out = smoke_line
    assert CORE is not None and EXTENDED is not None
    assert set(out) == set(CORE) - {"vs_baseline"} | PORT_ONLY
    assert (out["grid"], out["frame"], out["backend"], out["impl"]) == (
        32, 64, "cpu", "torch")
    assert out["pixel_grad_max_abs_err_compiled"] is None
    assert out["pixel_grad_compiled_vs_plain"] is None
    assert out["pixel_grad_oracle_max_abs"] > out["pixel_grad_max_abs_err"]
    for k, v in out.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0.0, k
    assert out["value"] == pytest.approx(64 * 64 / (
        out["fwd_ms_per_frame"] / 1e3))
    assert 0.0 < out["sol_fraction_fwd"] <= 1.0
    assert 0.0 < out["sol_fraction_fwd_bwd"] <= 1.0
    assert out["active_fraction"] == 1.0


def test_judged_run_full_adds_the_extended_set(monkeypatch):
    """``full`` adds bench.py's extended fields (timing stubbed out: one
    call of each body), none of them None."""
    def once(body, carry, name, on_card):
        body(carry)
        return 1e-3

    monkeypatch.setattr(judged, "timed_marginal", once)
    out = judged.run(device="cpu", smoke=True, full=True)
    assert set(out) == (set(CORE) | set(EXTENDED)) - {"vs_baseline"} | (
        PORT_ONLY)
    for k in EXTENDED:
        assert out[k] is not None, k


def test_judged_core_loop_lengths_are_bench_pys():
    assert judged.LOOPS == {"fwd_prepared": (64, 256), "fwd": (32, 128),
                            "fwd_bwd": (16, 64), "train_step": (8, 32),
                            "train_step_fused": (8, 32)}
    assert judged.calls("fwd_bwd") == 1 + 3 * 80


def test_timed_marginal_refuses_a_non_positive_time():
    """A body slower in the short loops than in the long ones (the warm-up
    and 3 x 8 calls sleep) gives a negative marginal, which raises."""
    def body(count):
        if count <= 3 * 8:
            time.sleep(2e-3)
        return count + 1

    with pytest.raises(RuntimeError, match="non-positive"):
        judged.timed_marginal(body, 0, "train_step", False)


def test_raw_grid_train_step_lowers_the_loss():
    """bench_train_step's step is a real Adam step on the raw grid."""
    n = 12
    grid = torch.as_tensor(np.array(smoke_sphere(n)))
    cam = _port_cam(tconfigs.front_ortho(n, 16))
    cfg = RenderConfig(early_stop_eps=0.0)
    opt = Adam(1e-2)
    step = judged.raw_grid_step(cam, cfg, opt, "cpu")
    params, state = grid.clone(), opt.init(grid)
    losses = []
    for _ in range(4):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert judged.bench_train_step(grid, cam, cfg, "cpu") > 0.0


@pytest.fixture(scope="module")
def jax_fixture():
    """bench.py's gradient fixture; it turns x64 off when done, which the
    rest of the process needs on."""
    try:
        return bench._grad_fixture(jax, jnp)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_grad_oracle_matches_jax(jax_fixture):
    plan_j, oracle_j = jax_fixture[:2]
    plan, oracle, gsc, coeffs, enables, dt_map = judged.grad_fixture()
    assert dataclasses.asdict(plan) == dataclasses.asdict(plan_j)
    assert oracle.dtype == torch.float64 and oracle_j.dtype == np.float64
    assert float(np.abs(oracle_j).max()) > 0.1
    np.testing.assert_allclose(oracle.numpy(), oracle_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        gsc.numpy(), np.asarray(jax_fixture[2]))


def test_plain_pixel_grad_error_within_twice_jaxs(jax_fixture,
                                                  smoke_line):
    errs = bench.grad_accuracy(jax, jnp, jax_fixture)
    err = judged.grad_accuracy(judged.grad_fixture(), "cpu")
    assert smoke_line["pixel_grad_max_abs_err"] == err
    assert 0.0 < err <= 2.0 * errs["xla"]


def test_scaling_table_on_two_gloo_ranks():
    n = 16
    grid = np.array(smoke_sphere(n))
    cam = _port_cam(_ortho16(n))
    case = [("scaling", workers.scaling_case,
             dict(grid=grid, cam=cam, cfg=RenderConfig(), min_wall=0.05),
             {})]
    out = launch.spawn(workers.run_suite, 2, "gloo", "cpu", (case,),
                       timeout_s=240)
    rows0, rows1 = (o["scaling"] for o in out)
    assert [r["devices"] for r in rows0] == [1, 2]
    assert [r["devices"] for r in rows1] == [1]
    for row in rows0:
        assert row["ms_per_frame"] > 0.0 and row["efficiency"] > 0.0
        assert row["rays_per_s"] == pytest.approx(
            256 / (row["ms_per_frame"] / 1e3))
    assert rows0[0]["efficiency"] == 1.0
