"""``render_with_geom`` (``tpuvr_torch.ops.render``): the render from
``view_geometry``'s dict, held against the JAX package's
``render_with_geom(mesh=None)`` and the port's ``render_view`` on the CPU,
and on 4 gloo ranks against one process.

Tolerances (f32): images 1e-5 absolute; gradients 1e-5 of max|grad| plus,
on the ranks, the roundoff of the gradient's all-reduce over them
(3 * 2^-24 * sum_r |g_r|, as ``tests/test_torch_dist_grad.py`` bounds
it). On the mesh each rank sweeps its rows at their own positions (the
sweep op's ``row0``), where the JAX package shifts ``by`` by ``r0 * ay``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import orbit_cameras as jorbit_cameras
from tpuvr.ops import geometry as jgeo
from tpuvr.ops.render import render_with_geom as jrender_with_geom
from tpuvr.ref.camera import OrthoCamera
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.dist.init import DataMesh
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.ops.geometry import view_geometry
from tpuvr_torch.ops.render import render_view, render_with_geom

N = 16
RES = 16
WORLD = 4


def _jcams():
    """An ortho view along z, and two orbit views (a forward and a
    reverse sweep)."""
    c = (N - 1) / 2.0
    ortho = OrthoCamera(center=(c, c, -3.0 * N), forward=(0.0, 0.0, 1.0),
                        up=(0.0, 1.0, 0.0), width=1.5 * N, height=1.5 * N,
                        res_x=RES, res_y=RES)
    return [ortho, *jorbit_cameras(8, N, res=RES)[2:4]]


def _tcam(jcam):
    return camera_from_fields(type(jcam).__name__, **dataclasses.asdict(jcam))


CFGS = {
    "eps0": (RenderConfig(early_stop_eps=0.0),
             JRenderConfig(early_stop_eps=0.0)),
    "ert_oversample2": (RenderConfig(oversample=2.0),
                        JRenderConfig(oversample=2.0)),
}


def _grid():
    return smoke_sphere(N, device="cpu")


def _port(cam, cfg, grid, mesh=None):
    axis, reverse, geom, band = view_geometry(cam, (N, N, N, 4),
                                              oversample=cfg.oversample)
    return render_with_geom(grid, geom, axis, reverse, cfg, mesh=mesh,
                            band=band, device="cpu")


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("cam", [0, 1, 2])
def test_render_with_geom_matches_jax(cam, cfg):
    """Image and grid gradient against the JAX package's
    ``render_with_geom`` (``impl="xla"``, no mesh) on the same geometry."""
    tcfg, jcfg = CFGS[cfg]
    jcam = _jcams()[cam]
    grid = _grid()
    jgrid = jnp.asarray(grid.numpy())
    axis, reverse, jgeom, jband = jgeo.view_geometry(
        jcam, (N, N, N, 4), oversample=jcfg.oversample)

    def jrender(g):
        return jrender_with_geom(g, jgeom, axis, reverse, jcfg, impl="xla",
                                 band=jband)

    j_rgb, j_t = jrender(jgrid)
    j_grad = jax.jit(jax.grad(
        lambda g: workers.image_loss(*jrender(g))))(jgrid)
    g = grid.clone().requires_grad_(True)
    rgb, t = _port(_tcam(jcam), tcfg, g)
    (grad,) = torch.autograd.grad(workers.image_loss(rgb, t), g)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(j_rgb),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j_t), rtol=0,
                               atol=1e-5)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=0,
                               atol=1e-5 * np.abs(j_grad).max())


@pytest.mark.parametrize("cam", [0, 1, 2])
def test_render_with_geom_equals_render_view(cam):
    """At oversample 2 the geometry render is ``render_view``'s image."""
    cfg = RenderConfig(oversample=2.0)
    tcam = _tcam(_jcams()[cam])
    grid = _grid()
    for a, b in zip(_port(tcam, cfg, grid),
                    render_view(grid, tcam, cfg, device="cpu")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_render_with_geom_refusals():
    """ValueError before any collective (the mesh here has no process
    group): rows the ranks do not divide, slab-chunked ERT on a mesh, and
    the fixed-step mode."""
    tcam = _tcam(_jcams()[1])
    grid = _grid()
    three = DataMesh(None, 0, 3)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        _port(tcam, RenderConfig(), grid, three)
    with pytest.raises(ValueError, match="ert_chunks"):
        _port(tcam, RenderConfig(ert_chunks=2), grid, DataMesh(None, 0, 2))
    with pytest.raises(ValueError, match="fixed_dt"):
        _port(tcam, RenderConfig(mode="fixed_dt"), grid)


@pytest.fixture(scope="module")
def ranks():
    """Every camera at oversample 2 on 4 gloo ranks, in one spawn."""
    grid = _grid().numpy()
    cfg = CFGS["ert_oversample2"][0]
    cases = [(f"geom_{i}", workers.geomgrad_case,
              dict(grid=grid, cam=_tcam(jcam), cfg=cfg), {})
             for i, jcam in enumerate(_jcams())]
    return launch.spawn(workers.run_suite, WORLD, "gloo", "cpu", (cases,),
                        timeout_s=240)


@pytest.mark.parametrize("cam", [0, 1, 2])
def test_render_with_geom_on_a_mesh_matches_one_process(ranks, cam):
    """Every rank's image and gradient are the one-process
    ``render_with_geom``'s: the gradient's factor is 1.0000, not the
    ranks' count."""
    cfg = CFGS["ert_oversample2"][0]
    g = _grid().requires_grad_(True)
    rgb, t = _port(_tcam(_jcams()[cam]), cfg, g)
    loss = workers.image_loss(rgb, t)
    (ref,) = torch.autograd.grad(loss, g)
    ref = ref.numpy()
    name = f"geom_{cam}"
    parts = np.stack([ranks[r][name]["partial"] for r in range(WORLD)])
    roundoff = 3 * 2.0**-24 * float(np.abs(parts).sum(0).max())
    scale = float(np.abs(ref).max())
    for r in range(WORLD):
        res = ranks[r][name]
        np.testing.assert_allclose(res["rgb"], rgb.detach().numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(res["t"], t.detach().numpy(), rtol=0,
                                   atol=1e-5)
        assert abs(res["loss"] - float(loss.detach())) <= 1e-6 * float(
            loss.detach())
        factor = float((res["grad"] * ref).sum() / (ref * ref).sum())
        assert abs(factor - 1.0) <= 1e-5
        np.testing.assert_allclose(res["grad"], ref, rtol=0,
                                   atol=1e-5 * scale + roundoff)
        counts = res["counts"]
        assert counts["collective_all_reduce"] == 2  # the tiles, the grid
