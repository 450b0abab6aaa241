"""tpuvr_torch's light volume and its gradient held against the JAX
package's lighting: the scan path (``impl='xla'``) and its autodiff, and
at a tiny size the Pallas tau-sweep kernel and its adjoint in interpret
mode. Tolerances: f64 1e-12, f32 1e-5 (of the largest value for
gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.kernels import lighting as jklight
from tpuvr.ops import lighting as jlight
from tpuvr_torch.config import LightingConfig
from tpuvr_torch.kernels import lighting as tklight
from tpuvr_torch.ops import lighting as tlight

N = 10
TOL = {"float64": 1e-12, "float32": 1e-5}


def _sigma(dtype, n=N):
    return np.array(smoke_sphere(n, dtype=jnp.dtype(dtype)))[..., 0]


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("up", [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
                                (0.3, -0.5, 0.8)])
def test_hemisphere_dirs_equal(n, up):
    np.testing.assert_array_equal(tlight.hemisphere_dirs(n, up),
                                  jlight.hemisphere_dirs(n, up))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [(0.3, 0.2, 0.93), (-0.6, 0.1, 0.79),
                               (0.8, -0.5, -0.33), (0.2, -0.9, 0.39)])
def test_directional_tau_matches(dtype, w):
    w = np.asarray(w) / np.linalg.norm(w)
    sig = _sigma(dtype)
    ref = np.asarray(jlight._directional_tau(jnp.asarray(sig), w,
                                             impl="xla"))
    out = tlight._directional_tau(torch.as_tensor(sig), w).numpy()
    assert ref.max() > 0.5
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_samples", [4, 16])
def test_light_volume_matches(dtype, n_samples):
    sig = _sigma(dtype)
    ref = np.asarray(jlight.light_volume(
        jnp.asarray(sig), JLightingConfig(mode="lightvolume",
                                          n_samples=n_samples), impl="xla"))
    out = tlight.light_volume(
        torch.as_tensor(sig), LightingConfig(mode="lightvolume",
                                             n_samples=n_samples),
        device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_apply_lighting_matches():
    grid = np.array(smoke_sphere(N))
    ref = np.asarray(jlight.apply_lighting(
        jnp.asarray(grid), JLightingConfig(mode="lightvolume", n_samples=4),
        impl="xla"))
    out = tlight.apply_lighting(
        torch.as_tensor(grid), LightingConfig(mode="lightvolume",
                                              n_samples=4)).numpy()
    np.testing.assert_array_equal(out[..., 0], grid[..., 0])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [(0.45, -0.7), (-1.0, 0.3)])
def test_tau_twin_matches_pallas_interpret(d):
    sig = _sigma("float32", n=8)
    kw = dict(d_y=d[0], d_x=d[1], dt=1.3)
    ref = np.asarray(jklight.tau_sweep(jnp.asarray(sig), interpret=True,
                                       **kw))
    out = tklight.tau_sweep_torch(torch.as_tensor(sig), **kw).numpy()
    assert np.all(out[-1] == 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_tau_wrapper_runs_twin_on_cpu():
    sig = torch.as_tensor(_sigma("float32"))
    before = tklight.launches.copy()
    a = tklight.tau_sweep(sig, d_y=0.2, d_x=-0.4, dt=1.1, precision="high")
    b = tklight.tau_sweep_torch(sig, d_y=0.2, d_x=-0.4, dt=1.1,
                                precision="high")
    assert tklight.launches == before
    assert torch.equal(a, b)


def test_apply_lighting_refuses_unknown_modes():
    with pytest.raises(ValueError, match="unknown lighting mode"):
        tlight.apply_lighting(torch.zeros(4, 4, 4, 4),
                              LightingConfig(mode="bogus"))


@pytest.mark.parametrize("d", [(0.45, -0.7), (-1.0, 0.3)])
def test_tau_adj_twin_matches_pallas_interpret(d):
    g = np.random.default_rng(3).normal(size=(8, 8, 8)).astype(np.float32)
    kw = dict(d_y=d[0], d_x=d[1], dt=1.3)
    ref = np.asarray(jklight.tau_sweep_adj(jnp.asarray(g), interpret=True,
                                           **kw))
    out = tklight.tau_sweep_adj_torch(torch.as_tensor(g), **kw).numpy()
    assert np.all(out[0] == 0)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [(0.3, 0.2, 0.93), (0.8, -0.5, -0.33),
                               (0.2, -0.9, 0.39)])
def test_tau_gradient_matches_jax_autodiff(dtype, w):
    """The tau op's adjoint against JAX autodiff of the scan path."""
    w = np.asarray(w) / np.linalg.norm(w)
    sig = _sigma(dtype) - 0.02  # some voxels below 0: the relu mask
    ct = np.random.default_rng(4).normal(size=sig.shape).astype(dtype)
    _, vjp = jax.vjp(lambda s: jlight._directional_tau(s, w, impl="xla"),
                     jnp.asarray(sig))
    (ref,) = vjp(jnp.asarray(ct))
    s = torch.as_tensor(sig).requires_grad_(True)
    (tlight._directional_tau(s, w) * torch.as_tensor(ct)).sum().backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(s.grad.numpy(), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_apply_lighting_shadow_gradients_match(dtype):
    """``apply_lighting(detach=False)``: gradients through the emission
    product and the shadows, against ``jax.grad`` of the JAX one."""
    grid = np.array(smoke_sphere(N, dtype=jnp.dtype(dtype)))
    wts = np.random.default_rng(5).normal(size=grid.shape).astype(dtype)
    jcfg = JLightingConfig(mode="lightvolume", n_samples=4, detach=False)
    ref = np.asarray(jax.grad(lambda g: jnp.sum(
        jlight.apply_lighting(g, jcfg, impl="xla") * wts))(
            jnp.asarray(grid)))
    g = torch.as_tensor(grid).requires_grad_(True)
    (tlight.apply_lighting(g, LightingConfig(mode="lightvolume", n_samples=4,
                                             detach=False))
     * torch.as_tensor(wts)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())
    # The shadows move the density gradient: detached, it is zero.
    assert np.abs(ref[..., 0]).max() > 1e-3


def test_tau_adj_wrapper_runs_twin_on_cpu():
    g = torch.as_tensor(_sigma("float32"))
    before = tklight.adj_launches.copy()
    a = tklight.tau_sweep_adj(g, d_y=0.2, d_x=-0.4, dt=1.1, precision="high")
    b = tklight.tau_sweep_adj_torch(g, d_y=0.2, d_x=-0.4, dt=1.1,
                                    precision="high")
    assert tklight.adj_launches == before
    assert torch.equal(a, b)
