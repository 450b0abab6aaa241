"""The trainer honours ``RenderConfig.oversample`` and refuses
``mode='fixed_dt'`` (``tpuvr_torch.train.fit``, ``device="cpu"``).

The JAX package's trainer builds each view's geometry at oversample 1 and
sweeps planes whatever the render config says; the port's renders honour
both fields, so its trainer and grouped render must too: the views'
lattices take ``oversample``, and a mode the trainer cannot run raises
ValueError before any work or collective.

Tolerances (f32): geometry against the JAX package's, 1e-6 absolute (the
same f64 plan rounded to f32; the pixel base points are up to 16 in
magnitude); images, 1e-5 absolute (the grouped render warps with the
lattice as f32 tensors, ``render_view`` with the plan's f64 numbers); the
first step's gradient, 1e-5 of max|grad|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuvr.io.synth import orbit_cameras as jorbit_cameras
from tpuvr.ops import geometry as jgeo
from tpuvr_torch.config import RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.io.synth import orbit_cameras, smoke_sphere
from tpuvr_torch.ops import geometry as tgeo
from tpuvr_torch.ops.render import render_view
from tpuvr_torch.train import fit

N = 16
RES = 16
OVERSAMPLE = 2.0
RCFG = RenderConfig(early_stop_eps=0.0, oversample=OVERSAMPLE)
FIXED = RenderConfig(mode="fixed_dt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CaptureGrad:
    """An 'optimizer' that keeps the last step's gradient and moves
    nothing."""

    def init(self, params):
        return None

    def update(self, grads, state):
        self.grad = grads.clone()
        return torch.zeros_like(grads), None


@pytest.mark.parametrize("view", [0, 3, 5])
def test_view_geometry_oversample_matches_jax(view):
    """All five entries of each package's ``view_geometry`` at oversample
    2, for orbit views of three sweep groups."""
    jcam = jorbit_cameras(8, N, res=RES)[view]
    tcam = camera_from_fields(type(jcam).__name__, **dataclasses.asdict(jcam))
    shape = (N, N, N, 4)
    ja, jr, jg, jband = jgeo.view_geometry(jcam, shape,
                                           oversample=OVERSAMPLE)
    ta, tr, tg, tband = tgeo.view_geometry(tcam, shape,
                                           oversample=OVERSAMPLE)
    assert (ta, tr) == (ja, jr)
    assert set(tg) == set(jg) == {"coeffs", "dt", "lattice", "uv", "valid"}
    assert tg["dt"].shape == (RES * OVERSAMPLE, RES * OVERSAMPLE)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tband, jband, rtol=1e-12)
    _, _, g1, _ = tgeo.view_geometry(tcam, shape)
    assert g1["dt"].shape == (RES, RES)


def test_render_views_grouped_honours_oversample():
    """The grouped render (hence ``evaluate_psnr``) equals
    ``render_all_views`` at oversample 2 on orbit cameras of every sweep
    group, and differs from the render at oversample 1."""
    grid = smoke_sphere(N, device="cpu")
    cams = orbit_cameras(8, N, res=RES)
    grouped = fit.render_views_grouped(grid, cams, RCFG, device="cpu")
    views = fit.render_all_views(grid, cams, RCFG, device="cpu")
    np.testing.assert_allclose(grouped.numpy(), views.numpy(), rtol=0,
                               atol=1e-5)
    at_one = fit.render_all_views(
        grid, cams, dataclasses.replace(RCFG, oversample=1.0), device="cpu")
    assert float((views - at_one).abs().max()) > 1e-3
    assert fit.evaluate_psnr(grid, cams, views, RCFG, device="cpu") > 90.0


def test_fit_grid_first_step_at_oversample():
    """``fit_grid``'s first-step gradient at oversample 2 (the two views of
    one sweep group in one minibatch) against autograd of the same loss
    through ``render_view`` at oversample 2, the render that
    ``render_all_views`` runs per view."""
    truth = smoke_sphere(N, device="cpu")
    cams = orbit_cameras(16, N, res=RES)[:2]
    assert len(fit.group_views(cams, (N, N, N, 4))) == 1
    targets = fit.render_all_views(truth, cams, RCFG, device="cpu")
    start = (0.7 * truth).contiguous()
    tcfg = TrainConfig(steps=1, views_per_batch=2, ckpt_every=0,
                       density_softplus=False)
    opt = _CaptureGrad()
    _, _, hist = fit.fit_grid(targets, cams, (N, N, N, 4), tcfg, RCFG,
                              params_init=start, opt=opt, fused=False,
                              device="cpu")
    g = start.clone().requires_grad_(True)
    loss = sum(torch.mean((render_view(g, cam, RCFG, device="cpu")[0]
                           - targets[i]) ** 2)
               for i, cam in enumerate(cams)) / len(cams)
    (ref,) = torch.autograd.grad(loss, g)
    loss = float(loss.detach())
    assert abs(hist["loss"][0] - loss) <= 1e-6 * loss
    scale = float(ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(opt.grad.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.fixture
def no_geometry(monkeypatch):
    """Fails the test if the trainer gets as far as grouping the views."""
    def refuse(*a, **k):
        raise AssertionError("the views were grouped before the refusal")

    monkeypatch.setattr(fit, "group_views", refuse)


@pytest.mark.parametrize("entry", ["fit_grid", "render_views_grouped",
                                   "evaluate_psnr"])
def test_fixed_dt_refused_before_any_work(entry, no_geometry):
    grid = smoke_sphere(8, device="cpu")
    cams = orbit_cameras(2, 8, res=8)
    targets = np.zeros((2, 8, 8, 3), np.float32)
    calls = {
        "fit_grid": lambda: fit.fit_grid(targets, cams, (8, 8, 8, 4),
                                         TrainConfig(steps=1, ckpt_every=0),
                                         FIXED, device="cpu"),
        "render_views_grouped": lambda: fit.render_views_grouped(
            grid, cams, FIXED, device="cpu"),
        "evaluate_psnr": lambda: fit.evaluate_psnr(grid, cams, targets,
                                                   FIXED, device="cpu"),
    }
    with pytest.raises(ValueError, match="fixed_dt"):
        calls[entry]()


def test_fixed_dt_refused_on_a_mesh_before_any_collective():
    """On 2 gloo ranks ``fit_grid(mesh=...)`` raises on every rank, having
    issued no collective."""
    out = launch.spawn(workers.run_suite, 2, "gloo", "cpu",
                       ([("refusal", workers.fit_refusal_case,
                          dict(render_cfg=FIXED), {})],), timeout_s=120)
    for rank in out:
        message, n_collectives = rank["refusal"]
        assert "fixed_dt" in message
        assert n_collectives == 0
