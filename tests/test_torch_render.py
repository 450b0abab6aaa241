"""tpuvr_torch's render entry points (``device="cpu"``, the plain
versions) held against the JAX package's ``render_view(impl="xla")`` for
the c1, c2 and c3 shapes and the headline frame at reduced size.

f32 atol 1e-5; f64 atol 1e-12. The 'default' tier cannot be held against
JAX on the CPU (XLA:CPU runs DEFAULT-precision f32 dots in full f32), so
the headline frame is held against JAX within the ~5e-3 bf16 image error
that tier states.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs import common as jcommon
from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.ops.render import grid_to_sweep_layout as jlayout
from tpuvr.ops.render import render_view as jrender_view
from tpuvr.ref import camera as jcam
from tpuvr_torch import configs as tconfigs
from tpuvr_torch.config import LightingConfig, RenderConfig
from tpuvr_torch.convert import camera_from_fields, grid_from_numpy
from tpuvr_torch.ops import render as trender
from tpuvr_torch.ref.camera import camera_rays
from tpuvr_torch.ref.march import render_plane_sweep

N = 16
RES = 24


def _jax_cfgs(name):
    cfg = tconfigs.CONFIGS[name]
    jr = JRenderConfig(**dataclasses.asdict(cfg["render"]))
    jl = (None if cfg["lighting"] is None
          else JLightingConfig(**dataclasses.asdict(cfg["lighting"])))
    return cfg, jr, jl


def _port_cam(jc):
    return camera_from_fields(type(jc).__name__, **dataclasses.asdict(jc))


def _compare(name, dtype, tol, n_samples=None):
    cfg, jr, jl = _jax_cfgs(name)
    lighting = cfg["lighting"]
    if n_samples is not None:
        lighting = dataclasses.replace(lighting, n_samples=n_samples)
        jl = dataclasses.replace(jl, n_samples=n_samples)
    grid = np.array(smoke_sphere(N, dtype=jnp.dtype(dtype)))
    jc = getattr(jcommon, cfg["camera"])(N, RES)
    rgb_j, t_j = jrender_view(jnp.asarray(grid), jc, jr,
                                     lighting=jl, impl="xla")
    tgrid = grid_from_numpy(grid, device="cpu", dtype=getattr(torch, dtype))
    rgb_t, t_t = trender.render_view(tgrid, _port_cam(jc), cfg["render"],
                                     lighting=lighting, device="cpu")
    assert rgb_t.shape == (RES, RES, 3) and t_t.shape == (RES, RES)
    assert np.asarray(rgb_j).max() > 0.05
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("name", ["c1", "c2"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_render_view_matches_jax(name, dtype, tol):
    _compare(name, dtype, tol)


@pytest.mark.parametrize("n_samples", [4, 16])
def test_render_view_lit_c3_matches_jax(n_samples):
    _compare("c3", "float32", 1e-5, n_samples=n_samples)


def test_headline_default_tier_within_bf16_error():
    _compare("headline", "float32", 5e-3)


def test_c2_takes_the_warp_path():
    from tpuvr_torch.ops.geometry import plan_sweep

    cam = tconfigs.camera(tconfigs.CONFIGS["c2"], N, RES)
    plan, uv = plan_sweep(cam, (N, N, N, 4), jcam.dominant_axis(cam))
    assert uv is not None and not plan.separable and plan.reverse


def _cams():
    c = (N - 1) / 2.0
    return [
        jcommon.front_ortho(N, RES),
        jcam.look_at_perspective((c + 3.0 * N, c + 0.2 * N, c - 0.4 * N),
                                 (c, c, c), res_x=RES, res_y=RES),
        jcam.look_at_perspective((c - 0.3 * N, c - 2.5 * N, c + 0.6 * N),
                                 (c, c, c), res_x=RES, res_y=RES),
        # fly-through: the eye inside the slab
        jcam.look_at_perspective((c, c + 0.1, c - 0.3 * N),
                                 (c + 0.5, c, N + 5.0),
                                 res_x=RES, res_y=RES),
    ]


@pytest.mark.parametrize("i", range(4))
def test_cameras_match_jax(i):
    jc = _cams()[i]
    grid = np.array(smoke_sphere(N))
    cfg = RenderConfig(early_stop_eps=1e-4)
    rgb_j, t_j = jrender_view(
        jnp.asarray(grid), jc, JRenderConfig(early_stop_eps=1e-4),
        impl="xla")
    rgb_t, t_t = trender.render_view(torch.as_tensor(grid), _port_cam(jc),
                                     cfg, device="cpu")
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)


@pytest.mark.parametrize("use_occ", [True, False])
def test_prepared_matches_render_view(use_occ):
    grid = torch.as_tensor(np.array(smoke_sphere(N)))
    cfg = RenderConfig(early_stop_eps=1e-4, use_occupancy=use_occ)
    prep = trender.prepare_grid(grid, device="cpu")
    for jc in _cams():
        cam = _port_cam(jc)
        a = trender.render_view(grid, cam, cfg, device="cpu")
        b = trender.render_prepared(prep, cam, cfg, device="cpu")
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_prepared_with_lighting():
    grid = torch.as_tensor(np.array(smoke_sphere(N)))
    lighting = LightingConfig(mode="lightvolume", n_samples=4)
    cam = _port_cam(_cams()[0])
    a, _ = trender.render_view(grid, cam, RenderConfig(), lighting=lighting,
                               device="cpu")
    prep = trender.prepare_grid(grid, axes=(2,), lighting=lighting,
                                device="cpu")
    b, _ = trender.render_prepared(prep, cam, RenderConfig(), device="cpu")
    assert torch.equal(a, b)


def test_prepared_wrong_axis_raises():
    grid = torch.zeros(N, N, N, 4)
    prep = trender.prepare_grid(grid, axes=(0,), device="cpu")
    with pytest.raises(ValueError, match="axes"):
        trender.render_prepared(prep, _port_cam(_cams()[0]), device="cpu")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_layout_matches_and_round_trips(axis):
    grid = np.random.default_rng(axis).standard_normal((5, 6, 7, 4))
    ref = np.asarray(jlayout(jnp.asarray(grid), axis))
    gsc = trender.grid_to_sweep_layout(torch.as_tensor(grid), axis)
    assert gsc.is_contiguous()
    np.testing.assert_array_equal(gsc.numpy(), ref)
    back = trender.sweep_layout_to_grid(gsc, axis)
    np.testing.assert_array_equal(back.numpy(), grid)
    assert trender._grid_shape_from_sweep(axis, gsc.shape) == grid.shape


def test_row_chunked_frame_matches_jax():
    """A frame taller than max_rows_per_call is rendered in row chunks."""
    grid = np.array(smoke_sphere(N))
    jc = _cams()[1]
    kw = dict(early_stop_eps=0.0, max_rows_per_call=7)
    rgb_j, _ = jrender_view(jnp.asarray(grid), jc,
                                   JRenderConfig(**kw), impl="xla")
    rgb_t, _ = trender.render_view(torch.as_tensor(grid), _port_cam(jc),
                                   RenderConfig(**kw), device="cpu")
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)


def test_render_stacks_views():
    grid = torch.as_tensor(np.array(smoke_sphere(N)))
    cams = [_port_cam(c) for c in _cams()[:2]]
    rgb, t = trender.render(grid, cams, RenderConfig(), device="cpu")
    assert rgb.shape == (2, RES, RES, 3) and t.shape == (2, RES, RES)
    one, _ = trender.render_view(grid, cams[1], RenderConfig(),
                                 device="cpu")
    assert torch.equal(rgb[1], one)


@pytest.mark.parametrize("cfg,err", [
    (RenderConfig(mode="bogus"), ValueError),
])
def test_unported_render_options_raise(cfg, err):
    with pytest.raises(err):
        trender.render_view(torch.zeros(4, 4, 4, 4),
                            tconfigs.front_ortho(4, 8), cfg, device="cpu")


@pytest.mark.parametrize("i", [0, 2])
def test_render_view_fixed_dt(i):
    """mode='fixed_dt' marches each pixel's ray: equal to the JAX
    package's fixed-step render, at step 0.05 within the quadrature gap of
    the plane sweep over the same rays, and refused by the prepared path (which has no
    fixed-step form)."""
    jc = _cams()[i]
    grid = np.array(smoke_sphere(N))
    kw = dict(mode="fixed_dt", step_dt=0.05, early_stop_eps=0.0)
    rgb_j, t_j = jrender_view(jnp.asarray(grid), jc, JRenderConfig(**kw),
                              impl="xla")
    tgrid = torch.as_tensor(grid)
    rgb, t = trender.render_view(tgrid, _port_cam(jc), RenderConfig(**kw),
                                 device="cpu")
    assert rgb.shape == (RES, RES, 3) and t.shape == (RES, RES)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-6)
    # The plane sweep over the same pixel rays, within the quadrature gaps
    # of the JAX package's tests/test_march.py: its steps are about one
    # voxel, longer on oblique perspective rays.
    o, d = camera_rays(_port_cam(jc), dtype=torch.float32)
    rgb_ps, t_ps = render_plane_sweep(tgrid, o, d, jcam.dominant_axis(jc))
    gap = 0.06 if i == 0 else 0.1
    assert float((rgb - rgb_ps).abs().max()) < gap
    assert float((t - t_ps).abs().max()) < gap
    with pytest.raises(ValueError, match="fixed_dt"):
        trender.render_prepared(trender.prepare_grid(tgrid, device="cpu"),
                                _port_cam(jc), RenderConfig(**kw),
                                device="cpu")


@pytest.mark.parametrize("max_rows", [5, 7, 12])
def test_row_chunked_render_is_the_whole_frame(max_rows):
    """A frame rendered in row chunks (``max_rows_per_call`` below its 24
    intermediate rows) is the unchunked frame bit for bit at eps 0: each
    chunk sweeps with its first row as the op's ``row0``, so every row
    samples where the whole image's does."""
    grid = torch.as_tensor(np.array(smoke_sphere(N)))
    cam = _port_cam(_cams()[1])
    prep = trender.prepare_grid(grid, device="cpu")
    whole = trender.render_prepared(prep, cam, RenderConfig(
        early_stop_eps=0.0, max_rows_per_call=None), device="cpu")
    chunked = trender.render_prepared(prep, cam, RenderConfig(
        early_stop_eps=0.0, max_rows_per_call=max_rows), device="cpu")
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("softplus", [False, True])
@pytest.mark.parametrize("max_rows", [5, 8, 12])
def test_row_chunked_gradient_is_the_whole_frames(max_rows, softplus):
    """The grid gradient through row chunks at eps 0 is, bit for bit, the
    sum in chunk order of the whole image's gradients with the cotangent
    cut to each chunk's rows: the chunks sample and differentiate exactly
    the whole image's rows (the twins' products over rows add exact zeros
    for the rows outside a chunk)."""
    from tpuvr_torch.ops import vjp as tvjp

    grid = torch.as_tensor(np.array(smoke_sphere(N)))
    cam = _port_cam(_cams()[1])
    axis = jcam.dominant_axis(cam)
    plan, _, (gsc, coeffs, en, dt) = trender.sweep_inputs(
        trender.prepare_grid(grid, axes=(axis,), device="cpu"), cam,
        RenderConfig(), "cpu")
    rng = np.random.default_rng(2)
    d_rgb = torch.as_tensor(rng.standard_normal((3, *dt.shape)), dtype=dt.dtype)
    d_t = torch.as_tensor(rng.standard_normal(tuple(dt.shape)), dtype=dt.dtype)
    op = tvjp.sweep_op(plan.reverse, 1.0, 0.0, "torch", softplus=softplus)
    g = gsc.clone().requires_grad_(True)
    out = tvjp.chunked_sweep(op, g, coeffs, en, dt, max_rows=max_rows)
    (got,) = torch.autograd.grad(out, g, (d_rgb, d_t))
    n_v = dt.shape[0]
    n_chunks = -(-n_v // max_rows)
    while n_v % n_chunks:
        n_chunks += 1
    rows = n_v // n_chunks
    ref = None
    for i in range(n_chunks):
        keep = torch.zeros((n_v, 1), dtype=dt.dtype)
        keep[i * rows:(i + 1) * rows] = 1.0
        g = gsc.clone().requires_grad_(True)
        (part,) = torch.autograd.grad(op(g, coeffs, en, dt), g,
                                      (d_rgb * keep, d_t * keep))
        ref = part if ref is None else ref + part
    assert n_chunks > 1 and torch.equal(got, ref)
