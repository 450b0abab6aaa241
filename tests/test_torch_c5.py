"""c5 (``configs/c5.py``: a 512^3 grid at 1024^2, lit by 16 sky
directions, on a ``'data'`` mesh of every rank) in the port, at a tiny
size on the CPU: its config entry and camera against the JAX package's,
the lit train step of ``tools/c5_train.py`` (raw density, no softplus,
from a faint fog) against the JAX step, and the c5 rank case
(``tpuvr_torch.dist.workers.c5_case``, the code ``chip_smoke.py --phase
c5`` runs on every rank) on 2 gloo ranks.

Tolerances (f32): one step from one state, the loss to 1e-6 relative and
the gradient to 1e-5 of max|grad| (as ``tests/test_torch_train.py``: the
two sides' exp and sums differ by a few ulp); the mesh step against the
one-process step 1e-5 of max|grad| (each rank sweeps its rows where the
whole image's are, so only the order of the sums differs); a mesh fit's
loss trajectory against the one-process fit's rtol 2e-3 (the JAX
package's own bound for a mesh trajectory, tests/test_dist.py: Adam turns
roundoff-sized gradient differences into full-lr steps), the ranks
bit-identical to each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from configs import c5 as jc5
from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import orbit_cameras, smoke_sphere
from tpuvr.train import fit as jfit
from tpuvr_torch import configs
from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.train import fit as tfit

N = 16
RES = 16
WORLD = 2
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)
# tools/c5_train.py's settings, 4 steps.
FIT_CFG = dict(lr=3e-2, steps=4, views_per_batch=1, ckpt_every=0,
               density_softplus=False, steps_per_call=2, seed=0)


def _lights(detach):
    """c5's sky light cut to 4 directions (the JAX package compiles one
    tau sweep a direction on the CPU)."""
    return (LightingConfig(mode="lightvolume", n_samples=4, detach=detach),
            JLightingConfig(mode="lightvolume", n_samples=4, detach=detach))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """c5's four orbit views cut to a 16^3 smoke sphere at 16^2 (four view
    groups of one view, 16 intermediate rows each), their lit targets
    rendered by the JAX package as ``tools/c5_train.py`` renders them."""
    gt = smoke_sphere(N)
    jcams = orbit_cameras(4, N, res=RES)
    targets = np.array(jfit.render_views_grouped(
        gt, jcams, JRCFG, impl="xla", lighting=_lights(True)[1]))
    tcams = [camera_from_fields(type(c).__name__, **dataclasses.asdict(c))
             for c in jcams]
    return (N, N, N, 4), jcams, tcams, targets


def _fog(shape):
    return workers.fog_params(shape, "cpu").numpy()


def test_c5_config_matches_jax():
    """Every field of ``configs/c5.py``, and its camera: the JAX package's
    first orbit camera at 512^3 and 1024^2."""
    jcfg, tcfg = jc5.CONFIG, configs.CONFIGS["c5"]
    assert set(tcfg) == set(jcfg)
    for key, value in jcfg.items():
        if dataclasses.is_dataclass(value):
            assert type(tcfg[key]).__name__ == type(value).__name__
            assert dataclasses.asdict(tcfg[key]) == dataclasses.asdict(value)
        else:
            assert tcfg[key] == value
    assert tcfg["render"].precision == "highest"
    jcam = orbit_cameras(1, 512, res=1024)[0]
    assert dataclasses.asdict(configs.camera(tcfg)) == dataclasses.asdict(
        jcam)


_J_CAPTURE = optax.GradientTransformation(
    lambda p: jnp.zeros_like(p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(scene, params, detach):
    """The JAX package's lit step (raw density) of the first view group's
    view from ``params``, on one device: (loss, gradient)."""
    shape, jcams, _, targets = scene
    groups = jfit.group_views(jcams, shape)
    key = sorted(groups)[0]
    idxs, stacked, band, tiling = groups[key]
    step = jfit.make_train_step(key, 1, _J_CAPTURE, JRCFG, False, "xla",
                                None, band=band, warp_tiling=tiling,
                                prestage=True, lighting=_lights(detach)[1])
    _, grad, loss = step(jnp.asarray(params), jnp.zeros(shape), stacked,
                         jnp.asarray(targets[np.array(idxs)]),
                         jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "shadows"])
def test_lit_raw_density_step_from_the_fog_matches_jax(scene, detach):
    """``tools/c5_train.py``'s step on one process: lighting baked from the
    current density each step, ``density_softplus=False``, from the fog;
    with ``detach=False`` the shadows' gradient (through the tau sweeps'
    adjoint) joins the emission's."""
    shape, _, tcams, targets = scene
    params = _fog(shape)
    j_loss, j_grad = _jax_step(scene, params, detach)
    key, (idxs, stacked, _, _) = sorted(tfit.group_views(
        tcams, shape).items())[0]
    step = tfit.make_train_step(key, 1, workers.CaptureGrad(), RCFG, False,
                                None, lighting=_lights(detach)[0])
    _, grad, loss = step(torch.as_tensor(params), None, stacked,
                         torch.as_tensor(targets[idxs]), np.zeros(1, int),
                         np.zeros(1, np.int32))
    assert abs(float(loss) - j_loss) <= 1e-6 * j_loss
    scale = float(np.abs(j_grad).max())
    assert scale > 1e-4
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=0,
                               atol=1e-5 * scale)
    # The density's gradient is live, and with the shadows it moves.
    assert float(np.abs(j_grad[..., 0]).max()) > 1e-3 * scale


def test_c5_rank_case_on_two_gloo_ranks(scene, tmp_path):
    """``workers.c5_case`` on 2 gloo ranks: its first mesh step against the
    one-process step saved to the scene directory (as the card's parent
    saves it), its fit against the one-process fit with the same settings,
    the ranks bit-identical, and the collectives a step and a fit: one
    all-reduce for the tiles' gather and one a gradient bucket (4) a step,
    and two broadcasts (rank 0's start step and parameters) a fit."""
    shape, _, tcams, targets = scene
    tl, _ = _lights(True)
    np.save(tmp_path / "targets.npy", targets)
    key, (idxs, stacked, _, _) = sorted(tfit.group_views(
        tcams, shape).items())[0]
    step = tfit.make_train_step(key, 1, workers.CaptureGrad(), RCFG, False,
                                None, lighting=tl)
    fog = torch.as_tensor(_fog(shape))
    _, ref, ref_loss = step(fog, None, stacked, torch.as_tensor(
        targets[idxs]), np.zeros(1, int), np.zeros(1, np.int32))
    torch.save(ref, tmp_path / "grad.pt")
    cfg = TrainConfig(**FIT_CFG)
    _, _, one = tfit.fit_grid(targets, tcams, shape, cfg, RCFG,
                              run_dir=str(tmp_path / "one"), lighting=tl,
                              params_init=fog, device="cpu")
    case = dict(scene_dir=str(tmp_path), cams=tcams, grid_shape=shape,
                cfg=cfg, render_cfg=RCFG, lighting=tl, step_cfg=RCFG,
                run_dir=str(tmp_path / "mesh"))
    out = launch.spawn(workers.run_suite, WORLD, "gloo", "cpu",
                       ([("c5", workers.c5_case, case, {})],),
                       timeout_s=120)
    res = [o["c5"] for o in out]
    r0 = res[0]
    assert r0["grad_err_of_max"] <= 1e-5
    assert abs(r0["step_loss"] - float(ref_loss)) <= 1e-6 * float(ref_loss)
    # The CPU's lit step takes the ATen passes, counted once a step.
    assert r0["step_counts"] == {"collective_all_reduce": 5,
                                 "light_apply_fallback": 1}
    assert len(r0["loss"]) == cfg.steps and r0["finite"]
    assert r0["loss"][1] < r0["loss"][0] and r0["loss"][3] < r0["loss"][2]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=2e-3, atol=0)
    assert r0["fit_counts"] == {"collective_all_reduce": 5 * cfg.steps,
                                "collective_broadcast": 2,
                                "light_apply_fallback": cfg.steps}
    assert "peak_gib" not in r0
    for r in res[1:]:
        assert r["loss"] == r0["loss"]
        assert (r["grad_digest"], r["params_digest"]) == (
            r0["grad_digest"], r0["params_digest"])
