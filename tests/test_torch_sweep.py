"""tpuvr_torch's plain forward sweep held against the JAX package's scan
twin (``sweep_fwd_xla``, the CPU reference its own tests use) and, at a
tiny size, against the Pallas kernels in interpret mode.

Tolerances: f64 rtol 1e-12 (both sides sum the same two non-zero taps per
tent row; only matmul order differs), f32 atol 1e-5 at 'highest' and
'high' (the JAX side evaluates exp with its own Cody-Waite routine, about
2-3 ulp, compounded over the slices).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.io.synth import smoke_sphere
from tpuvr.kernels import sweep as jsweep
from tpuvr.kernels.sweep_xla import sweep_fwd_xla
from tpuvr.ops import geometry as jgeo
from tpuvr.ops import vjp as jvjp
from tpuvr.ops.render import grid_to_sweep_layout as jlayout
from tpuvr.ref import camera as jcam
from tpuvr_torch.kernels import sweep as tsweep
from tpuvr_torch.kernels import sweep_torch as st
from tpuvr_torch.ops import vjp as tvjp

N = 12
RES = 16
C = (N - 1) / 2.0

CAMS = {
    "ortho": jcam.OrthoCamera(
        center=(C, C, -2.0 * N), forward=(0.1, -0.15, 1.0),
        up=(0.0, 1.0, 0.0), width=1.4 * N, height=1.4 * N,
        res_x=RES, res_y=RES),
    "persp_rev": jcam.look_at_perspective(
        (C + 2.6 * N, C + 0.2 * N, C - 0.4 * N), (C, C, C),
        res_x=RES, res_y=RES),
    "persp_y": jcam.look_at_perspective(
        (C - 0.3 * N, C - 2.5 * N, C + 0.6 * N), (C, C, C),
        res_x=RES, res_y=RES),
}


def _inputs(cam_name, dtype, seed=0):
    """Sweep-layout grid, coeffs, enables and dt as numpy, one random
    disabled slice in traversal order."""
    cam = CAMS[cam_name] if isinstance(cam_name, str) else cam_name
    grid = smoke_sphere(N, dtype=jnp.dtype(dtype))
    axis = jcam.dominant_axis(cam)
    plan, _ = jgeo.plan_sweep(cam, grid.shape, axis)
    gsc = np.array(jlayout(grid, axis))
    coeffs = tuple(np.array(c) for c in jgeo.slice_coeffs(
        plan, jnp.dtype(dtype)))
    dt = np.array(jgeo.ray_dt(plan, jnp.dtype(dtype)))
    en = np.ones(gsc.shape[0], dtype)
    en[np.random.default_rng(seed).integers(1, gsc.shape[0] - 1)] = 0
    return gsc, coeffs, en, dt, plan.reverse


def _run_both(cam_name, dtype, precision, eps, sigma_scale=1.3):
    gsc, coeffs, en, dt, reverse = _inputs(cam_name, dtype)
    kw = dict(reverse=reverse, sigma_scale=sigma_scale, early_stop_eps=eps,
              precision=precision)
    jr, jt = sweep_fwd_xla(jnp.asarray(gsc), tuple(map(jnp.asarray, coeffs)),
                           jnp.asarray(en), jnp.asarray(dt), **kw)
    tr, tt = st.sweep_fwd_torch(
        torch.as_tensor(gsc), tuple(map(torch.as_tensor, coeffs)),
        torch.as_tensor(en), torch.as_tensor(dt), **kw)
    return (np.asarray(jr), np.asarray(jt)), (tr.numpy(), tt.numpy())


@pytest.mark.parametrize("cam_name", sorted(CAMS))
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_sweep_matches_xla_f64(cam_name, eps):
    (jr, jt), (tr, tt) = _run_both(cam_name, "float64", "highest", eps)
    np.testing.assert_allclose(tr, jr, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tt, jt, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cam_name", sorted(CAMS))
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_sweep_matches_xla_f32(cam_name, precision, eps):
    (jr, jt), (tr, tt) = _run_both(cam_name, "float32", precision, eps)
    assert np.abs(jr).max() > 0.1  # the scene is seen
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)


def test_ert_terminates_dense_scene():
    """An opaque scene seen only through the grid: ERT changes T by at
    most eps and rgb by at most eps * max|c| against the untruncated
    sweep."""
    narrow = jcam.OrthoCamera(center=(C, C, -2.0 * N), forward=(0, 0, 1.0),
                              up=(0.0, 1.0, 0.0), width=0.5 * N,
                              height=0.5 * N, res_x=RES, res_y=RES)
    gsc, coeffs, en, dt, reverse = _inputs(narrow, "float32")
    gsc[:, 0] += 1.0
    args = (torch.as_tensor(gsc), tuple(map(torch.as_tensor, coeffs)),
            torch.as_tensor(en), torch.as_tensor(dt))
    eps = 1e-3
    r0, t0 = st.sweep_fwd_torch(*args, reverse=reverse)
    r1, t1 = st.sweep_fwd_torch(*args, reverse=reverse, early_stop_eps=eps)
    assert not torch.equal(r0, r1)
    cmax = float(np.abs(gsc[:, 1:]).max())
    assert (r1 - r0).abs().max() <= eps * cmax
    assert (t1 - t0).abs().max() <= eps


def test_interp_matrices_equal():
    args = (0.73, -1.4, 1.21, 2.3)
    ja, jb = jsweep._interp_matrices(*map(jnp.float32, args),
                                     9, 7, 6, 11, jnp.float32)
    ta, tb = st._interp_matrices(*(torch.tensor(a, dtype=torch.float32)
                                   for a in args), 9, 7, 6, 11,
                                 torch.float32)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sweep_dot_matches(precision):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 9)).astype(np.float32)
    b = rng.standard_normal((9, 5)).astype(np.float32)
    ref = np.asarray(jsweep.sweep_dot(jnp.asarray(a), jnp.asarray(b),
                                      precision, jnp.float32))
    out = st.sweep_dot(torch.as_tensor(a), torch.as_tensor(b),
                       precision).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_round_bf16_is_round_to_nearest_even():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(4096).astype(np.float32) * 7)
    ref = x.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(st.round_bf16(x), ref)


def test_default_tier_within_bf16_error():
    """'default' (one bf16 pass per stage) stays within the ~5e-3 image
    error the config states, against true f32."""
    gsc, coeffs, en, dt, reverse = _inputs("persp_rev", "float32")
    args = (torch.as_tensor(gsc), tuple(map(torch.as_tensor, coeffs)),
            torch.as_tensor(en), torch.as_tensor(dt))
    rh, th = st.sweep_fwd_torch(*args, reverse=reverse, precision="highest")
    rd, td = st.sweep_fwd_torch(*args, reverse=reverse, precision="default")
    assert not torch.equal(rh, rd)
    assert (rh - rd).abs().max() <= 5e-3
    assert (th - td).abs().max() <= 5e-3


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        st.sweep_dot(torch.ones(2, 2), torch.ones(2, 2), "low")


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_wrapper_runs_twin_on_cpu(precision):
    gsc, coeffs, en, dt, reverse = _inputs("persp_y", "float32")
    args = (torch.as_tensor(gsc), tuple(map(torch.as_tensor, coeffs)),
            torch.as_tensor(en), torch.as_tensor(dt))
    before = tsweep.launches.copy()
    a = tsweep.sweep_fwd(*args, reverse=reverse, precision=precision)
    b = st.sweep_fwd_torch(*args, reverse=reverse, precision=precision)
    assert tsweep.launches == before  # the CPU path launches nothing
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("max_rows", [4, 5])
def test_chunked_sweep_matches_jax(max_rows):
    gsc, coeffs, en, dt, reverse = _inputs("persp_rev", "float32")
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0)
    jop = jvjp.sweep_op(impl="xla", **kw)
    jr, jt = jvjp.chunked_sweep(jop, jnp.asarray(gsc),
                                tuple(map(jnp.asarray, coeffs)),
                                jnp.asarray(en), jnp.asarray(dt),
                                max_rows=max_rows)
    top = tvjp.sweep_op(impl="torch", **kw)
    tr, tt = tvjp.chunked_sweep(top, torch.as_tensor(gsc),
                                tuple(map(torch.as_tensor, coeffs)),
                                torch.as_tensor(en), torch.as_tensor(dt),
                                max_rows=max_rows)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_twin_matches_pallas_interpret():
    """The JAX package's own Pallas forward (interpret mode, dense and
    banded routes) against the twin at a tiny size."""
    n, res = 8, 8
    grid = smoke_sphere(n)
    cam = jcam.OrthoCamera(center=(3.5, 3.5, -16.0), forward=(0, 0, 1.0),
                           up=(0.0, 1.0, 0.0), width=11.0, height=11.0,
                           res_x=res, res_y=res)
    plan, _ = jgeo.plan_sweep(cam, grid.shape, 2)
    gsc = jlayout(grid, 2)
    coeffs = jgeo.slice_coeffs(plan)
    en = jnp.ones((n,), jnp.float32)
    dt = jgeo.ray_dt(plan)
    jr, jt = jsweep.sweep_fwd(gsc, coeffs, en, dt, interpret=True)
    tr, tt = st.sweep_fwd_torch(
        torch.as_tensor(np.array(gsc)),
        tuple(torch.as_tensor(np.array(c)) for c in coeffs),
        torch.as_tensor(np.array(en)), torch.as_tensor(np.array(dt)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_resolve_impl():
    t = torch.zeros(1)
    assert tvjp.resolve_impl(None, t) == "torch"
    assert tvjp.resolve_impl("auto", t) == "torch"
    assert tvjp.resolve_impl("torch", t) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        tvjp.resolve_impl("cuda", t)
    with pytest.raises(ValueError, match="unknown"):
        tvjp.resolve_impl("pallas", t)


def test_twin_is_differentiable_on_cpu():
    gsc, coeffs, en, dt, reverse = _inputs("ortho", "float64")
    g = torch.as_tensor(gsc).requires_grad_(True)
    op = tvjp.sweep_op(reverse, 1.0, 0.0, "torch")
    rgb, _ = op(g, tuple(map(torch.as_tensor, coeffs)), torch.as_tensor(en),
                torch.as_tensor(dt))
    rgb.sum().backward()
    assert torch.isfinite(g.grad).all() and g.grad.abs().sum() > 0

