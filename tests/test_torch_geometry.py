"""tpuvr_torch sweep geometry, cameras, scenes and configs held against
the JAX package: plans equal, coefficient/dt/mask arrays equal in f64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import configs.c1
import configs.c2
import configs.c3
from configs import common as jax_common
from tpuvr.io import synth as jsynth
from tpuvr.ops import geometry as jgeo
from tpuvr.ref import camera as jcam
from tpuvr_torch import configs as tconfigs
from tpuvr_torch.convert import camera_from_fields, grid_from_numpy
from tpuvr_torch.io import synth as tsynth
from tpuvr_torch.ops import geometry as tgeo

N = 12
RES = 16
C = (N - 1) / 2.0


def _jax_cams():
    cams = {
        "ortho_z": jcam.OrthoCamera(
            center=(C, C, -2.0 * N), forward=(0.0, 0.0, 1.0),
            up=(0.0, 1.0, 0.0), width=1.4 * N, height=1.4 * N,
            res_x=RES, res_y=RES),
        "ortho_oblique": jcam.OrthoCamera(
            center=(C + 0.2 * N, C, C + 2.0 * N), forward=(0.2, -0.3, -1.0),
            up=(0.0, 1.0, 0.0), width=1.5 * N, height=1.2 * N,
            res_x=RES, res_y=RES + 4),
        "fly_through": jcam.look_at_perspective(
            (C, C + 0.1, C - 0.3 * N), (C + 0.5, C, N + 5.0),
            res_x=RES, res_y=RES),
    }
    for axis in range(3):
        for sign in (1.0, -1.0):
            eye = [C + 0.15 * N, C - 0.1 * N, C + 0.2 * N]
            eye[axis] = C - sign * 2.5 * N
            cams[f"persp_{'xyz'[axis]}{'+' if sign > 0 else '-'}"] = (
                jcam.look_at_perspective(tuple(eye), (C, C, C),
                                         res_x=RES, res_y=RES))
    return cams


JAX_CAMS = _jax_cams()


def _port_cam(jc):
    kind = type(jc).__name__
    return camera_from_fields(kind, **dataclasses.asdict(jc))


def _plans(name):
    jc = JAX_CAMS[name]
    tc = _port_cam(jc)
    axis = jcam.dominant_axis(jc)
    jp, juv = jgeo.plan_sweep(jc, (N, N + 2, N - 1, 4), axis)
    tp, tuv = tgeo.plan_sweep(tc, (N, N + 2, N - 1, 4), axis)
    return jp, juv, tp, tuv


@pytest.mark.parametrize("name", sorted(JAX_CAMS))
def test_plan_fields_equal(name):
    jp, juv, tp, tuv = _plans(name)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    if juv is None:
        assert tuv is None
    else:
        np.testing.assert_array_equal(juv, tuv)


@pytest.mark.parametrize("name", sorted(JAX_CAMS))
def test_plan_arrays_equal_f64(name):
    jp, _, tp, _ = _plans(name)
    for ja, ta in zip(jgeo.slice_coeffs(jp, jnp.float64),
                      tgeo.slice_coeffs(tp, torch.float64)):
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jgeo.ray_dt(jp, jnp.float64)),
                                  tgeo.ray_dt(tp, torch.float64).numpy())
    np.testing.assert_array_equal(
        np.asarray(jgeo.plan_valid_mask(jp, jnp.float64)),
        tgeo.plan_valid_mask(tp, torch.float64).numpy())
    assert jgeo.band_bounds(jp) == tgeo.band_bounds(tp)


def test_fly_through_masks_planes():
    _, _, tp, _ = _plans("fly_through")
    mask = tgeo.plan_valid_mask(tp).numpy()
    assert 0 < mask.sum() < tp.n_planes


@pytest.mark.parametrize("name", ["ortho_oblique", "persp_x-", "persp_y+"])
def test_warp_to_pixels_matches_gather(name, monkeypatch):
    monkeypatch.setenv("TPUVR_WARP", "gather")
    jp, juv, tp, tuv = _plans(name)
    assert tuv is not None
    rng = np.random.default_rng(3)
    inter = rng.standard_normal((tp.n_v, tp.n_u, 4))
    ref = np.asarray(jgeo.warp_to_pixels(jnp.asarray(inter), jp, juv))
    out = tgeo.warp_to_pixels(torch.as_tensor(inter), tp, tuv).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_separable_warp_is_identity():
    jp, juv, tp, tuv = _plans("ortho_z")
    assert tuv is None and tp.separable
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tgeo.warp_to_pixels(x, tp, tuv) is x


def test_perpendicular_axis_raises():
    tc = _port_cam(JAX_CAMS["ortho_z"])
    with pytest.raises(ValueError, match="perpendicular"):
        tgeo.plan_sweep(tc, (N, N, N, 4), 0)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_smoke_sphere_matches(dtype, tol):
    ref = np.asarray(jsynth.smoke_sphere(N, dtype=jnp.dtype(dtype)))
    out = tsynth.smoke_sphere(N, dtype=getattr(torch, dtype),
                              device="cpu").numpy()
    assert out.shape == ref.shape == (N, N, N, 4)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_orbit_cameras_equal():
    for jc, tc in zip(jsynth.orbit_cameras(5, N, res=RES),
                      tsynth.orbit_cameras(5, N, res=RES)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


@pytest.mark.parametrize("name,mod", [("c1", configs.c1),
                                      ("c2", configs.c2),
                                      ("c3", configs.c3)])
def test_configs_match(name, mod):
    jcfg, tcfg = mod.CONFIG, tconfigs.CONFIGS[name]
    for key in ("grid_n", "res", "camera"):
        assert jcfg[key] == tcfg[key]
    assert dataclasses.asdict(jcfg["render"]) == dataclasses.asdict(
        tcfg["render"])
    if jcfg["lighting"] is None:
        assert tcfg["lighting"] is None
    else:
        assert dataclasses.asdict(jcfg["lighting"]) == dataclasses.asdict(
            tcfg["lighting"])
    jc = getattr(jax_common, jcfg["camera"])(N, RES)
    tc = tconfigs.camera(tcfg, N, RES)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_headline_config():
    cfg = tconfigs.CONFIGS["headline"]
    assert (cfg["grid_n"], cfg["res"], cfg["camera"]) == (
        256, 512, "front_ortho")
    assert cfg["render"].precision == "default"
    assert cfg["render"].early_stop_eps == 1e-4


def test_grid_from_numpy():
    arr = np.asarray(jsynth.smoke_sphere(6))
    g = grid_from_numpy(arr, device="cpu")
    assert g.dtype == torch.float32 and g.is_contiguous()
    np.testing.assert_array_equal(g.numpy(), arr.astype(np.float32))
    with pytest.raises(ValueError, match="Z, Y, X, 4"):
        grid_from_numpy(arr[..., :3], device="cpu")


def test_camera_from_fields_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown camera"):
        camera_from_fields("fisheye", eye=(0, 0, 0))
