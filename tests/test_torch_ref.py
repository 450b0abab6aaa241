"""tpuvr_torch's oracles held against the JAX package's on the CPU:
trilinear sampling and its transpose, compositing, camera rays, the
fixed-step and plane-sweep marchers (with their grid gradients), the
intermediate-lattice rays and the occupancy reductions, in float64 at
1e-12; ``render_view(mode="fixed_dt")`` in float32 at 1e-6, lit and
unlit. Inputs are made from seeded numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.kernels import occupancy as jocc
from tpuvr.ops import geometry as jgeo
from tpuvr.ops.render import render_view as jrender_view
from tpuvr.ref import camera as jcam
from tpuvr.ref import composite as jcomp
from tpuvr.ref import march as jmarch
from tpuvr.ref import sample as jsample
from tpuvr_torch.config import LightingConfig, RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.kernels import occupancy as tocc
from tpuvr_torch.ops import geometry as tgeo
from tpuvr_torch.ops.render import render_view as trender_view
from tpuvr_torch.ref import camera as tcam
from tpuvr_torch.ref import composite as tcomp
from tpuvr_torch.ref import march as tmarch
from tpuvr_torch.ref import sample as tsample

F64 = 1e-12
N = 10
RES = 8
C = (N - 1) / 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Hundreds of small ops a frame or step: one thread per test worker
    runs them far faster than pools oversubscribed by the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol=F64):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _port_cam(jc):
    return camera_from_fields(type(jc).__name__, **dataclasses.asdict(jc))


def _grid(n=N, seed=0):
    """smoke_sphere plus seeded noise (some density negative), f64."""
    rng = np.random.default_rng(seed)
    g = np.array(smoke_sphere(n, dtype=jnp.float64))
    return g + 0.05 * rng.standard_normal(g.shape)


# Points in range, on the one-voxel margin and outside the (6, 7, 8) grid.
POINTS = {
    "inside": ((0.0, 7.0), (0.0, 6.0), (0.0, 5.0)),
    "margin": ((-1.0, 0.0), (6.0, 7.0), (5.0, 6.0)),
    "outside": ((-4.0, -1.0), (7.0, 10.0), (-3.0, -1.0)),
}


def _points(kind, m=64, seed=1):
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1), (z0, z1) = POINTS[kind]
    return np.stack([rng.uniform(x0, x1, m), rng.uniform(y0, y1, m),
                     rng.uniform(z0, z1, m)], axis=-1).reshape(8, 8, 3)


@pytest.mark.parametrize("kind", sorted(POINTS))
def test_trilinear_matches_jax(kind):
    g = np.random.default_rng(2).standard_normal((6, 7, 8, 4))
    pts = _points(kind)
    want = jsample.trilinear(jnp.asarray(g), jnp.asarray(pts))
    got = tsample.trilinear(_t(g), _t(pts))
    assert got.shape == (8, 8, 4)
    _close(got, want)
    if kind == "outside":
        assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("kind", sorted(POINTS))
def test_trilinear_scatter_add_matches_jax_and_autograd(kind):
    g = np.random.default_rng(2).standard_normal((6, 7, 8, 4))
    pts = _points(kind)
    vals = np.random.default_rng(3).standard_normal((8, 8, 4))
    want = jsample.trilinear_scatter_add(g.shape, jnp.asarray(pts),
                                         jnp.asarray(vals), jnp.float64)
    got = tsample.trilinear_scatter_add(g.shape, _t(pts), _t(vals),
                                        torch.float64)
    _close(got, want)
    gt = _t(g).requires_grad_(True)
    (auto,) = torch.autograd.grad(tsample.trilinear(gt, _t(pts)), gt,
                                  _t(vals))
    _close(got, auto.numpy())


def test_compositing_matches_jax():
    rng = np.random.default_rng(4)
    sig = rng.uniform(0.0, 2.0, (5, 7))
    dt = rng.uniform(0.1, 1.0, (5, 7))
    rgb = rng.uniform(0.0, 1.0, (5, 7, 3))
    acc = rng.uniform(0.0, 1.0, (5, 3))
    trans = rng.uniform(0.0, 1.0, 5)
    _close(tcomp.alpha_from_sigma(_t(sig), _t(dt)),
           jcomp.alpha_from_sigma(sig, dt))
    for got, want in zip(
            tcomp.composite_step(_t(acc), _t(trans), _t(rgb[:, 0]),
                                 _t(sig[:, 0]), _t(dt[:, 0])),
            jcomp.composite_step(acc, trans, rgb[:, 0], sig[:, 0],
                                 dt[:, 0])):
        _close(got, want)
    seg_b = (rgb[:, 1], trans[::-1].copy())
    for got, want in zip(
            tcomp.segment_compose((_t(acc), _t(trans)),
                                  tuple(_t(x) for x in seg_b)),
            jcomp.segment_compose((acc, trans), seg_b)):
        _close(got, want)
    for got, want in zip(tcomp.composite_ray(_t(rgb), _t(sig), _t(dt)),
                         jcomp.composite_ray(rgb, sig, dt)):
        _close(got, want)


CAMERAS = {
    "ortho": jcam.OrthoCamera(center=(C, C, -2.0 * N),
                              forward=(0.2, -0.3, 1.0), up=(0.0, 1.0, 0.0),
                              width=1.4 * N, height=1.2 * N, res_x=RES,
                              res_y=RES + 2),
    "perspective": jcam.look_at_perspective((C, C - 3.0 * N, C + 0.7 * N),
                                            (C, C, C), res_x=RES + 3,
                                            res_y=RES),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_camera_rays_match_jax(name, dtype):
    jc = CAMERAS[name]
    jo, jd = jcam.camera_rays(jc, dtype=jnp.dtype(dtype))
    to, td = tcam.camera_rays(_port_cam(jc), dtype=getattr(torch, dtype))
    assert to.dtype == getattr(torch, dtype) and to.shape == jo.shape
    tol = F64 if dtype == "float64" else 1e-6
    _close(to, jo, tol * N)
    _close(td, jd, tol)


def test_intersect_aabb_and_permute_match_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-3.0, 12.0, (40, 3))
    d = rng.standard_normal((40, 3))
    d[:5, 0] = 0.0   # parallel to a slab: the 1/eps branch
    d[5:8, 2] = 1e-10
    lo, hi = np.full(3, -1.0), np.asarray([8.0, 9.0, 10.0])
    for got, want in zip(tmarch.intersect_aabb(_t(o), _t(d), _t(lo), _t(hi)),
                         jmarch.intersect_aabb(o, d, lo, hi)):
        assert bool(torch.isfinite(got).all())
        got, want = np.asarray(got), np.asarray(want)
        _close(got[8:], want[8:])
        # t ~ 1e10 where a component is ~ eps: held relative to its size.
        np.testing.assert_allclose(got[:8], want[:8], rtol=1e-15, atol=0)
    g = rng.standard_normal((4, 5, 6, 4))
    for axis in range(3):
        for got, want in zip(
                tmarch.permute_for_sweep(_t(g), _t(o), _t(d), axis),
                jmarch.permute_for_sweep(jnp.asarray(g), o, d, axis)):
            assert tuple(got.shape) == want.shape
            _close(got, want, 0.0)


def _march_cam(axis, reverse, persp):
    """A camera sweeping ``axis``, in reverse when ``reverse``."""
    sign = -1.0 if reverse else 1.0
    fwd = [0.2, -0.3, 0.25]
    fwd[axis] = sign
    if persp:
        eye = np.full(3, C) - 3.0 * N * np.asarray(fwd) / np.linalg.norm(fwd)
        return jcam.look_at_perspective(tuple(eye), (C, C, C), res_x=RES,
                                        res_y=RES)
    center = tuple(C - 3.0 * N * f / np.linalg.norm(fwd) for f in fwd)
    return jcam.OrthoCamera(center=center, forward=tuple(fwd),
                            width=1.4 * N, height=1.4 * N, res_x=RES,
                            res_y=RES)


MARCH_CAMS = [(axis, rev, persp) for axis in range(3)
              for rev in (False, True) for persp in (False, True)]


def _loss(rgb, trans):
    return (rgb * rgb).sum() + trans.sum()


@pytest.mark.parametrize("march", ["fixed_dt", "plane_sweep"])
@pytest.mark.parametrize("axis,reverse,persp", MARCH_CAMS)
def test_marchers_and_grid_gradients_match_jax(march, axis, reverse, persp):
    jc = _march_cam(axis, reverse, persp)
    assert jcam.dominant_axis(jc) == axis
    grid = _grid(seed=axis)
    o, d = jcam.camera_rays(jc, dtype=jnp.float64)
    to, td = tcam.camera_rays(_port_cam(jc), dtype=torch.float64)
    if march == "fixed_dt":
        cfg = dict(step_dt=1.1, sigma_scale=1.5, tmin=2.0)

        def jrun(g):
            return jmarch.render_fixed_dt(g, o, d, JRenderConfig(**cfg))

        def trun(g):
            return tmarch.render_fixed_dt(g, to, td, RenderConfig(**cfg))
    else:
        cfg = dict(sigma_scale=1.5)

        def jrun(g):
            return jmarch.render_plane_sweep(g, o, d, axis,
                                             JRenderConfig(**cfg))

        def trun(g):
            return tmarch.render_plane_sweep(g, to, td, axis,
                                             RenderConfig(**cfg))
    # The JAX fixed-step march runs op by op: jitted, XLA:CPU computes a
    # sample coordinate that lands on an integer (axis-1 ortho views at
    # step 0.7) once with a fused multiply-add and once without, takes the
    # floor of one and the fraction of the other, and samples the wrong
    # voxel layer (up to 1.1e-2 of rgb); op by op it is the package's own
    # arithmetic.
    with jax.disable_jit(march == "fixed_dt"):
        want = jrun(jnp.asarray(grid))
        want_g = jax.grad(lambda g: _loss(*jrun(g)))(jnp.asarray(grid))
    gt = _t(grid).requires_grad_(True)
    got = trun(gt)
    assert float(want[0].max()) > 0.05
    for a, b in zip(got, want):
        _close(a.detach(), b)
    (got_g,) = torch.autograd.grad(_loss(*got), gt)
    assert bool(torch.isfinite(got_g).all())
    assert float(np.abs(want_g).max()) > 0.1
    _close(got_g, want_g)


def test_plane_sweep_parallel_rays_keep_the_gradient_finite():
    """Rays with no component along the sweep axis are masked out; the
    division by their zero component must not reach the gradient."""
    grid = _grid()
    o = np.zeros((4, 3)) + C
    d = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.8, 0.0],
                    [0.0, 0.0, 1.0]])
    o[3, 2] = -2.0
    gt = _t(grid).requires_grad_(True)
    rgb, trans = tmarch.render_plane_sweep(gt, _t(o), _t(d), 2)
    (g,) = torch.autograd.grad(_loss(rgb, trans), gt)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    _close(trans[:3].detach(), np.ones(3), 0.0)
    want = jmarch.render_plane_sweep(jnp.asarray(grid), o, d, 2)
    _close(rgb.detach(), want[0])


PLANS = {
    "ortho": (CAMERAS["ortho"], 2),
    "perspective": (CAMERAS["perspective"], 1),
    "reverse_ortho": (jcam.OrthoCamera(
        center=(C, C, 3.0 * N), forward=(0.1, 0.2, -1.0), up=(0.0, 1.0, 0.0),
        width=1.3 * N, height=1.3 * N, res_x=RES, res_y=RES), 2),
    "fly_through": (jcam.look_at_perspective(
        (C, C + 0.1, C - 0.3 * N), (C + 0.5, C, N + 5.0), res_x=RES,
        res_y=RES), 2),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_intermediate_rays_match_jax(name):
    jc, axis = PLANS[name]
    shape = (N, N + 1, N + 2, 4)
    jplan, _ = jgeo.plan_sweep(jc, shape, axis)
    tplan, _ = tgeo.plan_sweep(_port_cam(jc), shape, axis)
    if name == "fly_through":
        assert tplan.valid != (0, N - 1)
    jo, jd = jgeo.intermediate_rays(jplan, dtype=jnp.float64)
    to, td = tgeo.intermediate_rays(tplan)
    assert to.dtype == torch.float64 and to.shape == jo.shape
    _close(to, jo, 0.0)
    _close(td, jd, 0.0)
    # The port's plane sweep over them equals the JAX oracle's.
    grid = _grid()
    gp = np.transpose(grid, jmarch.GRID_PERM[axis])
    for got, want in zip(tmarch.render_plane_sweep(_t(gp), to, td, 2),
                         jmarch.render_plane_sweep(jnp.asarray(gp), jo, jd,
                                                   2)):
        _close(got, want)


@pytest.mark.parametrize("brick", [3, 8])
@pytest.mark.parametrize("shape", [(10, 13, 7), (17, 9, 11)])
def test_occupancy_matches_jax(brick, shape):
    rng = np.random.default_rng(brick)
    sigma = rng.standard_normal(shape) - 1.5
    sigma[8:] = -1.0  # empty bricks from z = 8 on
    grid = np.concatenate([sigma[..., None],
                           rng.uniform(0.0, 1.0, shape + (3,))], axis=-1)
    for src in (grid, sigma):
        want = jocc.build_occupancy(jnp.asarray(src), brick)
        got = tocc.build_occupancy(_t(src), brick)
        assert tuple(got.shape) == want.shape
        _close(got, want, 0.0)
    frac_j = float(jocc.occupancy_fraction(want))
    assert 0.0 < frac_j < 1.0
    # float32 by definition, in both packages (XLA divides by multiplying
    # with the reciprocal): one f32 rounding apart.
    assert tocc.occupancy_fraction(got).dtype == torch.float32
    assert abs(float(tocc.occupancy_fraction(got)) - frac_j) <= 6e-8
    for reverse in (False, True):
        want_e = jocc.slice_enables_from_occupancy(want, shape[0], brick,
                                                   reverse, jnp.float64)
        got_e = tocc.slice_enables_from_occupancy(got, shape[0], brick,
                                                  reverse, torch.float64)
        _close(got_e, want_e, 0.0)


LIGHTING = {"unlit": (None, None),
            "lightvolume": (JLightingConfig(mode="lightvolume", n_samples=4),
                            LightingConfig(mode="lightvolume", n_samples=4))}


@pytest.mark.parametrize("lit", sorted(LIGHTING))
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_render_view_fixed_dt_matches_jax(lit, cam):
    grid = np.array(smoke_sphere(N))  # float32
    jl, tl = LIGHTING[lit]
    kw = dict(mode="fixed_dt", step_dt=0.5, early_stop_eps=0.0)
    want = jrender_view(jnp.asarray(grid), CAMERAS[cam], JRenderConfig(**kw),
                        lighting=jl, impl="xla")
    got = trender_view(_t(grid), _port_cam(CAMERAS[cam]), RenderConfig(**kw),
                       lighting=tl, device="cpu")
    assert got[0].dtype == torch.float32
    assert float(want[0].max()) > 0.05
    for a, b in zip(got, want):
        _close(a, b, 1e-6)
