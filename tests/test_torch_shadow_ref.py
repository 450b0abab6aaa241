"""The undetached lit fit (``LightingConfig.detach=False``: the density's
gradient through the sky light's transmittance) against the benchmark's
plain reference of it, ``vrbench/ref/shadow.py``, on the CPU at tiny
sizes: the port's ``fit_grid`` step, the reference's passes against plain
autograd through the whole reference, the reference's 'detached' fault,
and the port's shadow counters and span.

Tolerances (f32, TF32 irrelevant on the CPU):
- the port's step against the reference: the loss to 1e-6 relative, and
  each leaf's gradient to 2e-6 of that leaf's max|grad|. The two sides
  take the same f32 operations in other orders (the port's sweeps sum
  the tent taps in the twins' order, the reference in dense matmuls; the
  port sums the 4 directions' adjoints from the last, the reference from
  the first), a few ulps of the largest terms; measured at most 4.9e-7;
- the reference's passes against autograd through the whole reference:
  1e-6 of max|grad|, the same operations summed in another order;
- the 'detached' fault moves the density gradient by more than 100x the
  first tolerance: it leaves out the shadows' share, which at these
  densities is a tenth or more of the density gradient's largest entry
  (measured 0.11-0.28 in the first test's cases).
"""

import numpy as np
import pytest
import torch

from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.ops import lighting as olight
from tpuvr_torch.train import fit
from tpuvr_torch.utils import trace
from vrbench import fitjob
from vrbench.ref import geometry as G
from vrbench.ref import shadow as RS
from vrbench.ref import sweep as S
from vrbench.ref import train as RT
from vrbench.spec import Spec

CPU = torch.device("cpu")
LOSS_RTOL = 1e-6
GRAD_TOL = 2e-6  # of each leaf's max|grad|
PASS_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shadow_config(n, res, softplus=False, n_dirs=4):
    """The benchmark's c5-shadow configuration (512^3 at 1024^2, 16
    directions, light not detached) cut to n^3 at res^2 and ``n_dirs``
    directions."""
    cfg = Spec().config("c5-shadow")
    assert cfg["lighting"]["detach"] is False
    cfg.update(grid_n=n, res=res, density_softplus=softplus,
               lighting=dict(cfg["lighting"], n_samples=n_dirs))
    return cfg


def random_params(n, softplus, seed):
    """Seeded raw parameters: density in [-0.05, 0.25) (in [-3, -1) raw
    through softplus), emission in [0.1, 1.1)."""
    gen = torch.Generator().manual_seed(seed)
    p = torch.rand((n, n, n, 4), generator=gen) + 0.1
    dens = torch.rand((n, n, n), generator=gen)
    p[..., 0] = 2.0 * dens - 3.0 if softplus else 0.3 * dens - 0.05
    return p


class _Recorder:
    """The port's Adam, keeping the gradient it was given."""

    def __init__(self, adam):
        self.adam, self.grads = adam, None

    def init(self, params):
        return self.adam.init(params)

    def update(self, grads, state):
        self.grads = grads.clone()
        return self.adam.update(grads, state)


def port_step(cfg, inp, p0, tmp_path):
    """One step of the port's ``fit_grid`` from ``p0`` as the benchmark's
    fit job calls it: (loss, gradient)."""
    rcfg, lcfg = fitjob.program_configs(cfg)
    assert lcfg.detach is False
    rec = _Recorder(fit.Adam(cfg["lr"]))
    _, _, hist = fit.fit_grid(
        inp.targets, fitjob.program_cameras(inp.cams), inp.shape,
        fitjob.train_config(cfg, 1, inp.draw.fit_seed), rcfg, lighting=lcfg,
        params_init=p0, opt=rec, run_dir=str(tmp_path), device="cpu",
        **fitjob.fit_options(cfg))
    return hist["loss"][0], rec.grads


@pytest.mark.parametrize("n", [16, 24])
@pytest.mark.parametrize("softplus", [False, True],
                         ids=["raw", "softplus"])
def test_port_step_matches_the_shadow_reference(n, softplus, tmp_path):
    cfg = shadow_config(n, 16, softplus)
    inp = fitjob.Inputs(cfg, {}, 100 + n, CPU)
    p0 = random_params(n, softplus, n)
    loss_p, g_p = port_step(cfg, inp, p0, tmp_path)
    pick = RT.draws(inp.views, cfg, 1, inp.draw.fit_seed)[0]
    loss_r, g_r = RS.loss_and_grad(p0, inp.views, inp.targets, pick, cfg, 5)
    assert abs(loss_p - float(loss_r)) <= LOSS_RTOL * abs(float(loss_r))
    for c in range(4):
        scale = float(g_r[..., c].abs().max())
        assert scale > 0
        err = float((g_p[..., c] - g_r[..., c]).abs().max())
        assert err <= GRAD_TOL * scale, (c, err / scale)


def whole_reference(params, views, targets, pick, cfg):
    """The loss and its gradient by autograd through the whole reference at
    once: softplus, the light volume, the lit grid, the sweep and warp of
    every view of the minibatch."""
    light = cfg["lighting"]
    leaf = params.detach().requires_grad_(True)
    with torch.enable_grad():
        grid = RT.to_grid(leaf, cfg["density_softplus"])
        ell = S.light_volume(grid[..., 0], light["n_samples"],
                             light["sky_intensity"], light["up"])
        lit = torch.cat([grid[..., :1], grid[..., 1:4] * ell[..., None]],
                        dim=-1)
        total = 0.0
        for i in pick:
            v = views[i]
            inter = S.inter_image(G.sweep_layout(lit, v.plan.axis), v,
                                  cfg["early_stop_eps"], cfg["use_occupancy"])
            img = S.warp(inter, v.lattice, v.uv)[..., :3]
            total = total + torch.mean((img - targets[i]) ** 2)
        loss = total / len(pick)
        loss.backward()
    return loss.detach(), leaf.grad


@pytest.mark.parametrize("n,softplus", [(8, False), (12, True)])
def test_the_passes_equal_autograd_through_the_whole_reference(n, softplus):
    cfg = shadow_config(n, 12, softplus)
    cfg.update(n_views=8, views_per_batch=2)  # the passes' sum over views
    inp = fitjob.Inputs(cfg, {}, 7, CPU)
    p0 = random_params(n, softplus, 3)
    pick = RT.draws(inp.views, cfg, 1, inp.draw.fit_seed)[0]
    assert len(pick) == 2
    loss_a, g_a = whole_reference(p0, inp.views, inp.targets, pick, cfg)
    loss_p, g_p = RS.loss_and_grad(p0, inp.views, inp.targets, pick, cfg, 3)
    assert abs(float(loss_p - loss_a)) <= 1e-6 * abs(float(loss_a))
    scale = float(g_a.abs().max())
    assert float((g_p - g_a).abs().max()) <= PASS_TOL * scale


@pytest.mark.parametrize("n", [8, 12])
def test_the_detached_fault_leaves_out_the_shadows(n):
    """'detached' moves the density gradient well past the port's
    tolerance, leaves the emission's alone, and is the detached fit's
    reference (``vrbench/ref/train.py``) to the passes' tolerance."""
    cfg = shadow_config(n, 12)
    inp = fitjob.Inputs(cfg, {}, 5, CPU)
    p0 = random_params(n, False, 9)
    pick = RT.draws(inp.views, cfg, 1, inp.draw.fit_seed)[0]
    args = (p0, inp.views, inp.targets, pick, cfg, 4)
    _, g = RS.loss_and_grad(*args)
    _, g_det = RS.loss_and_grad(*args, shadows=False)
    scale = float(g[..., 0].abs().max())
    assert float((g[..., 0] - g_det[..., 0]).abs().max()) > 100 * (
        GRAD_TOL * scale)
    assert torch.equal(g[..., 1:], g_det[..., 1:])
    _, g_train = RT.loss_and_grad(
        p0, inp.views, inp.targets, pick,
        dict(cfg, lighting=dict(cfg["lighting"], detach=True)), 4)
    assert float((g_det - g_train).abs().max()) <= PASS_TOL * float(
        g_train.abs().max())


def test_follow_reads_the_first_gradient_and_the_change():
    cfg = shadow_config(8, 12)
    inp = fitjob.Inputs(cfg, {}, 4, CPU)
    p0 = RT.initial_params(cfg, CPU)
    losses, g_norms, c_norms, picks = RS.follow(
        p0, inp.views, inp.targets, cfg, 3, inp.draw.fit_seed, 4)
    assert picks == RT.draws(inp.views, cfg, 3, inp.draw.fit_seed)
    assert len(losses) == 3
    loss, g = RS.loss_and_grad(p0, inp.views, inp.targets, picks[0], cfg, 4)
    assert losses[0] == float(loss)
    np.testing.assert_array_equal(g_norms, RT.leaf_norms(g))
    assert (c_norms > 0).all()


@pytest.mark.parametrize("detach", [False, True], ids=["shadows", "detached"])
def test_shadow_counters_and_span(detach, tmp_path):
    """An undetached fit counts one ``light_shadow`` bake and one
    ``light_shadow_adjoint`` a step and records ``tpuvr.light.adjoint``
    once a step; a detached one counts and records neither."""
    from tpuvr_torch.io.synth import orbit_cameras, smoke_sphere

    gt = smoke_sphere(12, device="cpu")
    cams = orbit_cameras(4, 12, res=12, elevation_deg=25.0)
    rcfg = RenderConfig(early_stop_eps=0.0)
    light = LightingConfig(mode="lightvolume", n_samples=4, detach=detach)
    targets = fit.render_all_views(gt, cams, rcfg, lighting=light,
                                   device="cpu")
    cfg = TrainConfig(lr=2e-2, steps=3, views_per_batch=1, ckpt_every=0,
                      seed=3)
    before = trace.launch_counts()
    with trace.recording():
        fit.fit_grid(targets, cams, gt.shape, cfg, rcfg,
                     run_dir=str(tmp_path), lighting=light, device="cpu")
        snap = trace.snapshot()
    counts = trace.launch_counts() - before
    steps = 0 if detach else cfg.steps
    assert counts["light_shadow"] == steps
    assert counts["light_shadow_adjoint"] == steps
    assert snap["launches"].get("light_shadow_adjoint", 0) == steps
    adj = snap["totals"].get("tpuvr.light.adjoint")
    assert (adj["count"] if adj else 0) == steps
    if not detach:  # on the CPU the backward runs on the step's thread
        inside = [r for r in snap["records"] if r["kind"] == "fit.step"
                  and any(p[0] == "tpuvr.light.adjoint" for p in r["phases"])]
        assert len(inside) == steps


def test_a_bake_without_a_gradient_counts_no_shadow():
    cfg = LightingConfig(mode="lightvolume", n_samples=3)
    sigma = torch.rand((6, 7, 8)).requires_grad_(True)
    before = dict(olight.shadow)
    with torch.no_grad():
        olight.light_volume(sigma, cfg, device="cpu")
    olight.light_volume(sigma.detach(), cfg, device="cpu")
    assert dict(olight.shadow) == before
    olight.light_volume(sigma, cfg, device="cpu").sum().backward()
    assert olight.shadow["bake"] == before.get("bake", 0) + 1
    assert olight.shadow["adjoint"] == before.get("adjoint", 0) + 1
