"""The 'persample' lighting mode of tpuvr_torch (the exact light volume:
true secondary marches from every voxel centre) held against the JAX
package's ``light_at_points_ref``, ``light_volume_exact`` and
``apply_lighting`` in f64 on the CPU (1e-10 relative; gradients 1e-9 of
the largest), and a lit render in f32 (1e-5), after
``tests/test_lighting.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.ops import lighting as jlight
from tpuvr.ops.render import render_view as jrender_view
from tpuvr.ref.camera import OrthoCamera as JOrthoCamera
from tpuvr_torch.config import LightingConfig, RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.ops import lighting as tlight
from tpuvr_torch.ops import render as trender

N = 8
KW = dict(mode="persample", n_samples=4, secondary_dt=0.5)
CFG = LightingConfig(**KW)
JCFG = JLightingConfig(**KW)
# The gradients march 2 directions: each of the JAX package's costs some
# 2.5 s of compile a direction on the CPU.
GKW = dict(KW, n_samples=2)
GCFG = LightingConfig(**GKW)
JGCFG = JLightingConfig(**GKW)
# The JAX package's points (tests/test_lighting.py), x, y, z.
PTS = [[3.0, 4.0, 2.0], [5.0, 2.0, 6.0]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sigma(dtype="float64", n=N):
    return np.array(smoke_sphere(n, dtype=jnp.dtype(dtype)))[..., 0]


@pytest.fixture(scope="module")
def jax_volume():
    return np.asarray(jlight.light_volume_exact(jnp.asarray(_sigma()), JCFG))


def _rel_close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("which", ["jax_points", "seeded"])
def test_light_at_points_matches_jax(which):
    pts = (np.asarray(PTS) if which == "jax_points" else
           np.random.default_rng(4).uniform(-1.5, N + 0.5, (32, 3)))
    ref = jlight.light_at_points_ref(jnp.asarray(_sigma()), jnp.asarray(pts),
                                     JCFG, dt=0.5)
    got = tlight.light_at_points_ref(torch.as_tensor(_sigma()),
                                     torch.as_tensor(pts), CFG, dt=0.5)
    assert got.shape == pts.shape[:1] and got.dtype == torch.float64
    _rel_close(got.numpy(), ref, 1e-10)


@pytest.mark.parametrize("chunk_planes", [1, 3, 8])
def test_light_volume_exact_matches_jax(chunk_planes, jax_volume):
    """The whole 8^3 volume at 1e-10 of JAX's; the batch of planes does not
    change a bit."""
    sig = torch.as_tensor(_sigma())
    got = tlight.light_volume_exact(sig, CFG, chunk_planes=chunk_planes)
    assert got.shape == (N, N, N)
    _rel_close(got.numpy(), jax_volume, 1e-10)
    assert torch.equal(got, tlight.light_volume_exact(sig, CFG))


def test_light_volume_exact_at_the_jax_points(jax_volume):
    """The voxel-centre volume equals the point marcher at those voxels."""
    sig = torch.as_tensor(_sigma())
    vol = tlight.light_volume_exact(sig, CFG)
    at = tlight.light_at_points_ref(sig, torch.as_tensor(PTS,
                                                         dtype=sig.dtype),
                                    CFG, dt=CFG.secondary_dt)
    for (x, y, z), v in zip(PTS, at):
        np.testing.assert_allclose(float(vol[int(z), int(y), int(x)]),
                                   float(v), rtol=1e-12)


def _weights(shape, seed=6):
    return np.random.default_rng(seed).standard_normal(shape)


def test_light_volume_exact_gradient_matches_jax():
    """The density is exactly zero past the grid's margin, where
    ``max(x, 0)`` ties: both take half the gradient there."""
    w = _weights((N, N, N))
    ref = jax.jit(jax.grad(lambda s: jnp.sum(
        jnp.asarray(w) * jlight.light_volume_exact(s, JGCFG))))(
        jnp.asarray(_sigma()))
    sig = torch.as_tensor(_sigma()).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (torch.as_tensor(w) * tlight.light_volume_exact(sig, GCFG)).sum(), sig)
    assert float(got.abs().max()) > 0.0
    _rel_close(got.numpy(), ref, 1e-9)


@pytest.mark.parametrize("detach", [True, False])
def test_apply_lighting_matches_jax(detach):
    grid = np.array(smoke_sphere(N, dtype=jnp.float64))
    w = _weights(grid.shape, seed=8)

    @jax.jit
    def lit_and_grad(g):
        lit, back = jax.vjp(
            lambda x: jlight.apply_lighting(x, JGCFG, detach=detach), g)
        return lit, back(jnp.asarray(w))[0]

    ref, ref_grad = lit_and_grad(jnp.asarray(grid))
    g = torch.as_tensor(grid).requires_grad_(True)
    lit = tlight.apply_lighting(g, GCFG, detach=detach)
    (grad,) = torch.autograd.grad((torch.as_tensor(w) * lit).sum(), g)
    assert lit.shape == grid.shape
    assert torch.equal(lit[..., 0].detach(), g[..., 0].detach())
    _rel_close(lit.detach().numpy(), ref, 1e-10)
    _rel_close(grad.numpy(), ref_grad, 1e-9)
    # Detached shadows: the density's gradient is its own weight alone
    # (the lit grid's density is the grid's); else the shadows add to it.
    direct = torch.equal(grad[..., 0], torch.as_tensor(w[..., 0]))
    assert direct == detach


def test_render_view_persample_matches_jax():
    """8^3 @ 16^2, 'highest', f32, differentiable shadows: the image and
    the grid gradient within 1e-5 (of the largest, for the gradient)."""
    grid = np.array(smoke_sphere(N, dtype=jnp.float32))
    c = (N - 1) / 2.0
    jc = JOrthoCamera(center=(c, c, -3.0 * N), forward=(0.0, 0.0, 1.0),
                      up=(0.0, 1.0, 0.0), width=1.5 * N, height=1.5 * N,
                      res_x=16, res_y=16)
    cam = camera_from_fields("OrthoCamera", **dataclasses.asdict(jc))
    lkw = dict(GKW, detach=False)
    rkw = dict(early_stop_eps=0.0, precision="highest")

    def jloss(g):
        rgb, t = jrender_view(g, jc, JRenderConfig(**rkw),
                              lighting=JLightingConfig(**lkw), impl="xla")
        return jnp.mean(rgb ** 2) + jnp.mean(t), (rgb, t)

    (_, (rgb_j, t_j)), grad_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(grid))
    g = torch.as_tensor(grid).requires_grad_(True)
    rgb, t = trender.render_view(g, cam, RenderConfig(**rkw),
                                 lighting=LightingConfig(**lkw),
                                 device="cpu")
    (grad,) = torch.autograd.grad(torch.mean(rgb ** 2) + torch.mean(t), g)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(t_j), rtol=0,
                               atol=1e-5)
    assert float(grad[..., 0].abs().max()) > 0.0
    _rel_close(grad.numpy(), grad_j, 1e-5)


def test_bake_within_the_oracle_tolerance():
    """The tau-sweep bake ('lightvolume') against the exact volume at the
    JAX package's three interior voxels of its 12^3 scene, 8 directions,
    within its 0.08 (the sweep re-resamples tau every slice, softening
    oblique shadows)."""
    n = 12
    sig = torch.as_tensor(_sigma(n=n))
    cfg = LightingConfig(mode="persample", n_samples=8, secondary_dt=0.25)
    bake = tlight.light_volume(sig, cfg, device="cpu")
    exact = tlight.light_volume_exact(sig, cfg, chunk_planes=n)
    assert float(bake.max()) <= cfg.sky_intensity + 1e-9
    for x, y, z in ([5, 5, 5], [7, 4, 6], [3, 7, 8]):
        assert abs(float(bake[z, y, x] - exact[z, y, x])) < 0.08
    assert float((bake - exact).abs().max()) < 0.12
