"""tpuvr_torch's view-batched sweep (a minibatch of views marched in one
call, their planes stacked along V) held against the JAX package: its
Pallas view-batched kernels in interpret mode (the dense route and the
full-128 banded route), its per-view loop twins ``_xla_views_fwd`` /
``_xla_views_bwd``, ``jax.grad`` through its ``sweep_op(views=2)``, and its
trainer with the view batch on.

Tolerances: against the Pallas kernels the JAX tests' own, 5e-6 on images
and 2e-5 on the gradient (absolute; those kernels fold or re-order the
position arithmetic, an ulp in the tap weights). Against the loop twins
and ``jax.grad``: f64 1e-12 and f32 1e-5 of max|grad| (the JAX side's
Cody-Waite exp differs from torch.exp by 2-3 ulp). Trainers: one step's
loss to 1e-6 relative and moved parameters to 1e-6 absolute, as in
tests/test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.config import TrainConfig as JTrainConfig
from tpuvr.io.synth import orbit_cameras, smoke_sphere
from tpuvr.kernels.sweep import sweep_fwd as jsweep_fwd
from tpuvr.kernels.sweep_bwd import sweep_bwd as jsweep_bwd
from tpuvr.ops import vjp as jvjp
from tpuvr.train import fit as jfit
from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.kernels import sweep as tsweep
from tpuvr_torch.kernels import sweep_bwd as tsweep_bwd
from tpuvr_torch.kernels import sweep_torch as st
from tpuvr_torch.ops import vjp as tvjp
from tpuvr_torch.train import fit as tfit

TOL = {"float64": 1e-12, "float32": 1e-5}
VIEWS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one thread per test worker runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype="float32", seed=0, banded=False, raw=False):
    """A view batch as numpy: grid (S, 4, Y, X), four (views, S) coeffs,
    (views, S) enables with a few disabled (view, slice) pairs, stacked dt
    (views * V, U) and cotangents. Dense: tiny, slopes 0.6-2.4 (the c4
    regime, steeper than the banded tiles take). Banded: the shapes of
    tests/test_view_batch.py, slopes 0.5-0.9 in full 128 tiles."""
    rng = np.random.default_rng(seed)
    if banded:
        s, n_y, n_x, v_pv, n_u = 2, 144, 160, 128, 128
        lo, hi, b_lo, b_hi = 0.5, 0.9, -10.0, 20.0
    else:
        s, n_y, n_x, v_pv, n_u = 6, 12, 14, 8, 10
        lo, hi, b_lo, b_hi = 0.6, 2.4, -3.0, 4.0
    grid = rng.random((s, 4, n_y, n_x)) * 0.5
    if raw:
        grid[:, 0] = rng.normal(-0.5, 1.5, (s, n_y, n_x))
    coeffs = (rng.uniform(lo, hi, (VIEWS, s)), rng.uniform(b_lo, b_hi,
                                                           (VIEWS, s)),
              rng.uniform(lo, hi, (VIEWS, s)), rng.uniform(b_lo, b_hi,
                                                           (VIEWS, s)))
    enables = rng.integers(0, 2, (VIEWS, s)).astype(np.float64)
    enables[:, 0] = 1.0
    dt = rng.uniform(0.5, 1.0, (VIEWS * v_pv, n_u))
    d_rgb = rng.random((3, VIEWS * v_pv, n_u))
    d_t = rng.random((VIEWS * v_pv, n_u))
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    return (cast(grid), tuple(map(cast, coeffs)), cast(enables), cast(dt),
            cast(d_rgb), cast(d_t))


def _jax(a):
    return jax.tree.map(jnp.asarray, a)


def _torch(a):
    if isinstance(a, tuple):
        return tuple(map(torch.as_tensor, a))
    return torch.as_tensor(a)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_views_match_jax_pallas(banded, reverse):
    """The port's plain versions, through the wrapper and directly, against
    the JAX package's view-batched Pallas kernels in interpret mode: the
    dense route (band None) and the full-128 banded route."""
    grid, coeffs, en, dt, d_rgb, d_t = _setup(seed=3 + banded,
                                              banded=banded)
    band = (0.9, 0.9, 0.5, 0.5) if banded else None
    kw = dict(reverse=reverse, sigma_scale=1.2, early_stop_eps=0.0,
              precision="highest")
    jrgb, jt = jsweep_fwd(*_jax((grid, coeffs, en, dt)), band=band,
                          views=VIEWS, interpret=True, **kw)
    jg = np.asarray(jsweep_bwd(*_jax((grid, coeffs, en, dt)), jrgb, jt,
                               *_jax((d_rgb, d_t)), band=band, views=VIEWS,
                               interpret=True, **kw))
    args = tuple(map(_torch, (grid, coeffs, en, dt)))
    rgb, t = tsweep.sweep_fwd(*args, views=VIEWS, **kw)
    for a, b in zip(st.sweep_fwd_views_torch(*args, views=VIEWS, **kw),
                    (rgb, t)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=5e-6)
    g = tsweep_bwd.sweep_bwd(*args, rgb, t, *map(_torch, (d_rgb, d_t)),
                             views=VIEWS, **kw)
    assert np.abs(jg).max() > 1e-2
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=2e-5)


def _loss_grads(dtype, softplus, bwd_chunks):
    grid, coeffs, en, dt, d_rgb, d_t = _setup(dtype, seed=5, raw=softplus)
    kw = dict(reverse=True, sigma_scale=1.3, early_stop_eps=0.0,
              softplus=softplus)

    def jloss(g):
        op = jvjp.sweep_op(impl="xla", views=VIEWS, **kw)
        rgb, t = op(g, _jax(coeffs), jnp.asarray(en), jnp.asarray(dt))
        return jnp.sum(rgb * d_rgb) + jnp.sum(t * d_t)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(grid)))
    g = torch.as_tensor(grid).requires_grad_(True)
    op = tvjp.sweep_op(impl="torch", views=VIEWS, bwd_chunks=bwd_chunks,
                       **kw)
    rgb, t = op(g, _torch(coeffs), torch.as_tensor(en), torch.as_tensor(dt))
    ((rgb * torch.as_tensor(d_rgb)).sum()
     + (t * torch.as_tensor(d_t)).sum()).backward()
    return g.grad.numpy(), ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("softplus", [False, True])
@pytest.mark.parametrize("bwd_chunks", [1, 2])
def test_views_op_grad_matches_jax_grad(dtype, softplus, bwd_chunks):
    """``sweep_op(views=2)``'s gradient, in one call and in two slabs
    threading the carry, against ``jax.grad`` through the JAX package's
    ``sweep_op(impl='xla', views=2)``."""
    out, ref = _loss_grads(dtype, softplus, bwd_chunks)
    scale = np.abs(ref).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("softplus", [False, True])
def test_views_twin_carry_matches_jax_loop(softplus):
    """The backward twin with a carry: two slabs equal one call, and each
    slab equals the JAX package's per-view loop ``_xla_views_bwd`` given
    the same carry (f64)."""
    grid, coeffs, en, dt, d_rgb, d_t = _setup("float64", seed=7,
                                              raw=softplus)
    kw = dict(reverse=False, sigma_scale=0.9, early_stop_eps=0.0,
              precision="highest", softplus=softplus)
    args = tuple(map(_torch, (grid, coeffs, en, dt)))
    cot = tuple(map(_torch, (d_rgb, d_t)))
    rgb, t = st.sweep_fwd_views_torch(*args, views=VIEWS, **kw)
    one = st.sweep_bwd_views_torch(*args, rgb, t, *cot, views=VIEWS, **kw)
    two = tvjp._chunked_bwd(st.sweep_bwd_views_torch, 2, *args, rgb, t,
                            *cot, dict(kw, views=VIEWS))
    torch.testing.assert_close(two, one, rtol=0,
                               atol=1e-12 * float(one.abs().max()))
    j_rgb, j_t = jnp.asarray(rgb.numpy()), jnp.asarray(t.numpy())
    n_v, n_u = dt.shape
    rng = np.random.default_rng(9)
    carry = (rng.uniform(0.2, 1.0, (n_v, n_u)), rng.normal(0, 0.1, (n_v, n_u)))
    half = tuple(c[:, :3] for c in coeffs)
    jg, (jtf, jqf) = jvjp._xla_views_bwd(
        VIEWS, jnp.asarray(grid[:3]), _jax(half), jnp.asarray(en[:, :3]),
        jnp.asarray(dt), j_rgb, j_t, *_jax((d_rgb, d_t)),
        carry=_jax(carry), **kw)
    tg, (ttf, tqf) = st.sweep_bwd_views_torch(
        torch.as_tensor(grid[:3]), _torch(half), torch.as_tensor(en[:, :3]),
        args[3], rgb, t, *cot, views=VIEWS, carry=_torch(carry), **kw)
    for a, b in ((tg, jg), (ttf, jtf), (tqf, jqf)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())


def test_views_ert_matches_jax_loop():
    """Early ray termination (eps > 0) on the dense route: the twins stop
    a view's rays at that view's global max T, as the JAX package's
    per-view loop twins do; one view terminates fast, the other late."""
    grid, coeffs, en, dt, d_rgb, d_t = _setup(seed=11)
    rng = np.random.default_rng(12)
    # Every ray inside the grid planes (12 x 14 for 8 x 10 rays), so that
    # a view's max T can fall below eps.
    coeffs = tuple(np.float32(rng.uniform(*r, (VIEWS, grid.shape[0])))
                   for r in ((0.6, 1.1), (0.0, 1.0), (0.6, 1.1), (0.0, 1.0)))
    en = np.ones_like(en)
    dt[:dt.shape[0] // 2] *= 40.0
    eps = 1e-2
    kw = dict(reverse=False, sigma_scale=3.0, early_stop_eps=eps,
              precision="highest")
    j_rgb, j_t = jvjp._xla_views_fwd(VIEWS, *_jax((grid, coeffs, en, dt)),
                                     **kw)
    args = tuple(map(_torch, (grid, coeffs, en, dt)))
    rgb, t = st.sweep_fwd_views_torch(*args, views=VIEWS, **kw)
    assert float(t[:t.shape[0] // 2].max()) < eps  # view 0 terminated
    assert float(t[t.shape[0] // 2:].max()) > eps  # view 1 did not
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), rtol=0, atol=1e-5)
    jg = np.asarray(jvjp._xla_views_bwd(
        VIEWS, *_jax((grid, coeffs, en, dt)), j_rgb, j_t,
        *_jax((d_rgb, d_t)), **kw))
    g = st.sweep_bwd_views_torch(*args, rgb, t, *map(_torch, (d_rgb, d_t)),
                                 views=VIEWS, **kw)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_views_wrappers_on_cpu_count_no_launch():
    """On CPU tensors the wrappers run the twins (no launch counted) and
    refuse a stacked plane that is not ``views`` equal planes."""
    grid, coeffs, en, dt, d_rgb, d_t = map(_torch, _setup())
    before = (tsweep.launches.copy(), tsweep_bwd.launches.copy())
    rgb, t = tsweep.sweep_fwd(grid, coeffs, en, dt, views=VIEWS)
    g = tsweep_bwd.sweep_bwd(grid, coeffs, en, dt, rgb, t, d_rgb, d_t,
                             views=VIEWS)
    assert (tsweep.launches, tsweep_bwd.launches) == before
    assert torch.equal(g, st.sweep_bwd_views_torch(
        grid, coeffs, en, dt, rgb, t, d_rgb, d_t, views=VIEWS))
    with pytest.raises(ValueError, match="equal views"):
        tsweep.sweep_fwd(grid, coeffs, en, dt[:-1], views=VIEWS)
    with pytest.raises(ValueError, match="equal views"):
        tsweep_bwd.sweep_bwd(grid, coeffs, en, dt[:-1], rgb, t, d_rgb, d_t,
                             views=VIEWS)


def test_view_batch_eligible(monkeypatch):
    monkeypatch.delenv("TPUVR_VIEW_BATCH", raising=False)
    assert not tfit.view_batch_eligible(1)
    assert tfit.view_batch_eligible(2)
    monkeypatch.setenv("TPUVR_VIEW_BATCH", "0")
    assert not tfit.view_batch_eligible(8)
    for k in (1, 2, 8):
        assert tfit.view_batch_eligible(k) == jfit.view_batch_eligible(
            k, None, (4, 4, 4, 4), 0, 8, 8)


N = 12
RES = 16
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)


@pytest.fixture(scope="module")
def scene():
    """16 orbit views (4 per sweep group) of the smoke sphere, rendered by
    the JAX package; the same cameras as the port's."""
    gt = smoke_sphere(N)
    jcams = orbit_cameras(16, N, res=RES, elevation_deg=25.0)
    targets = np.array(jfit.render_all_views(gt, jcams, JRCFG))
    tcams = [camera_from_fields(type(c).__name__, **dataclasses.asdict(c))
             for c in jcams]
    return gt.shape, jcams, tcams, targets


def _params(shape, seed):
    rng = np.random.default_rng(seed)
    return (np.array(jfit.init_params(shape, True))
            + rng.normal(0.0, 0.3, shape).astype(np.float32))


def test_fit_grid_batched_fused_matches_jax(scene, tmp_path, monkeypatch):
    """Both trainers with the view batch on, in the fused mode (blocks of
    two steps, state in sweep layout): the same first step."""
    monkeypatch.delenv("TPUVR_VIEW_BATCH", raising=False)
    shape, jcams, tcams, targets = scene
    params = _params(shape, 12)
    kw = dict(lr=5e-2, steps=2, views_per_batch=3, ckpt_every=0, seed=2,
              steps_per_call=2)
    _, jp, jh = jfit.fit_grid(targets, jcams, shape, JTrainConfig(**kw),
                              JRCFG, run_dir=str(tmp_path / "j"),
                              params_init=params)
    _, tp, th = tfit.fit_grid(targets, tcams, shape, TrainConfig(**kw), RCFG,
                              run_dir=str(tmp_path / "t"),
                              params_init=params, device="cpu")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-6, atol=0)
    moved = np.abs(np.asarray(jp) - params) > 0.9 * 5e-2
    assert moved.mean() > 0.05
    np.testing.assert_allclose(tp.numpy()[moved], np.asarray(jp)[moved],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["configured", "fused", "rays_per_view",
                                  "lit"])
def test_fit_grid_batched_matches_view_loop(scene, tmp_path, monkeypatch,
                                            mode):
    """The port's trainer with the view batch against its view-by-view
    loop (``TPUVR_VIEW_BATCH=0``): the same losses and parameters, to f32
    roundoff of the gradient's summation order."""
    shape, _, tcams, targets = scene
    params = _params(shape, 13)
    cfg = TrainConfig(lr=2e-2, steps=3, views_per_batch=3, ckpt_every=0,
                      seed=5, rays_per_view=8 * RES
                      if mode == "rays_per_view" else None)
    lighting = (LightingConfig(mode="lightvolume", n_samples=3, detach=False)
                if mode == "lit" else None)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("TPUVR_VIEW_BATCH", flag)
        _, p, h = tfit.fit_grid(targets, tcams, shape, cfg, RCFG,
                                run_dir=str(tmp_path / flag),
                                params_init=params, fused=mode == "fused",
                                lighting=lighting, device="cpu")
        runs[flag] = (p.numpy(), h["loss"])
    np.testing.assert_allclose(runs["1"][1], runs["0"][1], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(runs["1"][0], runs["0"][0], rtol=0,
                               atol=1e-6)
