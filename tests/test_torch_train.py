"""tpuvr_torch's trainer (``fit_grid`` and its parts, ``device="cpu"``,
the plain twins) held against the JAX package's trainer on a tiny scene.

Tolerances: one step from one state carried across by ``convert``: the
loss to 1e-6 relative and the gradient to 1e-5 of its max (f32 roundoff:
the two sides' exp and sums differ by a few ulp). Adam's m / sqrt(v)
turns roundoff-sized gradients into full-lr steps, so updated parameters
are compared only where |g| > 1e-6, well above the gradient's roundoff
(about 1e-10 here), to 1e-6 absolute (a few ulp of parameters near 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.config import TrainConfig as JTrainConfig
from tpuvr.io.synth import orbit_cameras, smoke_sphere
from tpuvr.ops import geometry as jgeo
from tpuvr.ref.camera import look_at_perspective
from tpuvr.train import fit as jfit
from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields, train_state_from_numpy
from tpuvr_torch.dist.init import DataMesh, GridMesh
from tpuvr_torch.ops import geometry as tgeo
from tpuvr_torch.train import fit as tfit

N = 12
RES = 16
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The steps are hundreds of tiny ops: one thread per test worker runs
    them about 20x faster than oversubscribed pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _state(shape, seed=5):
    """Raw parameters near the init and a mid-run Adam state, as numpy."""
    rng = np.random.default_rng(seed)
    params = (np.array(jfit.init_params(shape, True))
              + rng.normal(0.0, 0.3, shape).astype(np.float32))
    mu = rng.normal(0.0, 1e-3, shape).astype(np.float32)
    nu = rng.uniform(1e-7, 1e-6, shape).astype(np.float32)
    return params, mu, nu, 3


class _CaptureGrad:
    """An 'optimizer' whose state after a step is the step's gradient."""

    def init(self, params):
        return None

    def update(self, grads, state):
        return torch.zeros_like(grads), grads


_J_CAPTURE = optax.GradientTransformation(
    lambda p: jnp.zeros_like(p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))

LIGHTS = {
    "unlit": (None, None),
    "lit_detached": (LightingConfig(mode="lightvolume", n_samples=3),
                     JLightingConfig(mode="lightvolume", n_samples=3)),
    "lit_shadows": (
        LightingConfig(mode="lightvolume", n_samples=3, detach=False),
        JLightingConfig(mode="lightvolume", n_samples=3, detach=False)),
}


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_train_step_matches_jax(scene, light):
    """One step of each trainer's step function from one state: the loss,
    the gradient (through a capturing optimizer), and Adam's update."""
    shape, jcams, tcams, targets = scene
    tl, jl = LIGHTS[light]
    params, mu, nu, count = _state(shape)
    jkey = sorted(jfit.group_views(jcams, shape))[1]
    idxs, stacked, band, tiling = jfit.group_views(jcams, shape)[jkey]
    tidx, tstacked, _, _ = tfit.group_views(tcams, shape)[jkey]
    assert tidx == idxs
    pick, r0s = np.array([0, 2, 1]), np.zeros(3, np.int32)
    out = {}
    for name, jopt, topt in (("grad", _J_CAPTURE, _CaptureGrad()),
                             ("adam", optax.adam(5e-2), tfit.Adam(5e-2))):
        jstep = jfit.make_train_step(jkey, 3, jopt, JRCFG, True, "xla", None,
                                     band=band, warp_tiling=tiling,
                                     prestage=True, lighting=jl)
        jstate = (jnp.zeros(shape, jnp.float32) if name == "grad" else (
            optax.ScaleByAdamState(count=jnp.int32(count),
                                   mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
            optax.EmptyState()))
        jp, js, jloss = jstep(jnp.asarray(params), jstate, stacked,
                              jnp.asarray(targets[np.array(idxs)]),
                              jnp.asarray(pick), jnp.asarray(r0s))
        tparams, tstate = train_state_from_numpy(params, mu, nu, count,
                                                 device="cpu")
        tstep = tfit.make_train_step(jkey, 3, topt, RCFG, True, None,
                                     lighting=tl)
        tp, ts, tloss = tstep(tparams, None if name == "grad" else tstate,
                              tstacked, torch.as_tensor(targets[tidx]),
                              pick, r0s)
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * float(jloss)
        out[name] = (np.asarray(jp), js, tp.numpy(), ts)
    g_j, g_t = np.asarray(out["grad"][1]), out["grad"][3].numpy()
    assert np.abs(g_j).max() > 1e-5
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    live = np.abs(g_j) > 1e-6
    assert live.mean() > 0.2
    jp, js, tp, ts = out["adam"]
    np.testing.assert_allclose(tp[live], jp[live], rtol=0, atol=1e-6)
    assert ts[2] == int(js[0].count) == count + 1


@pytest.mark.parametrize("rays_per_view", [None, 8 * RES])
def test_fit_grid_first_step_matches_jax(scene, tmp_path, rays_per_view):
    """Whole ``fit_grid`` calls, one step from the same warm start: the
    same group, views and row band are drawn, and the step agrees."""
    shape, jcams, tcams, targets = scene
    params, _, _, _ = _state(shape, seed=6)
    kw = dict(lr=5e-2, steps=1, views_per_batch=3, ckpt_every=0, seed=4,
              rays_per_view=rays_per_view)
    _, jp, jh = jfit.fit_grid(targets, jcams, shape, JTrainConfig(**kw),
                              JRCFG, run_dir=str(tmp_path / "j"),
                              params_init=params)
    _, tp, th = tfit.fit_grid(targets, tcams, shape, TrainConfig(**kw), RCFG,
                              run_dir=str(tmp_path / "t"),
                              params_init=params, device="cpu")
    assert abs(th["loss"][0] - jh["loss"][0]) <= 1e-6 * jh["loss"][0]
    moved = np.abs(np.asarray(jp) - params) > 0.9 * 5e-2  # |g| >> eps
    assert moved.mean() > 0.05
    np.testing.assert_allclose(tp.numpy()[moved], np.asarray(jp)[moved],
                               rtol=0, atol=1e-6)
    assert len(th["step_ms"]) == 1


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5, 6)).astype(np.float32)
    opt = optax.adam(3e-2)
    jp, js = jnp.asarray(p), opt.init(jnp.asarray(p))
    tp = torch.as_tensor(p)
    ts = tfit.adam_init(tp)
    for _ in range(3):
        g = rng.normal(size=p.shape).astype(np.float32) * 1e-2
        ju, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tfit.Adam(3e-2).update(torch.as_tensor(g), ts)
        tp = tp + tu
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0].mu),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[0].nu),
                               rtol=1e-6, atol=0)
    assert ts[2] == int(js[0].count) == 3


@pytest.mark.parametrize("softplus", [False, True])
def test_params_to_grid_and_init_params_match(softplus):
    shape = (3, 4, 5, 4)
    ref = np.asarray(jfit.init_params(shape, softplus))
    out = tfit.init_params(shape, softplus, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)
    raw = np.random.default_rng(1).normal(0, 4, shape).astype(np.float32)
    np.testing.assert_allclose(
        tfit.params_to_grid(torch.as_tensor(raw), softplus).numpy(),
        np.asarray(jfit.params_to_grid(jnp.asarray(raw), softplus)),
        rtol=1e-6, atol=1e-7)


def test_group_views_keys_match(scene):
    """The port's groups are the JAX package's: the same keys (axis,
    reverse, tile class) and the same views in each."""
    shape, jcams, tcams, _ = scene
    jg = jfit.group_views(jcams, shape)
    tg = tfit.group_views(tcams, shape)
    assert sorted(tg) == sorted(jg)
    assert {k: v[0] for k, v in tg.items()} == {k: v[0] for k, v in jg.items()}
    for key, (idxs, stacked, band, warp) in tg.items():
        assert warp is None
        assert stacked["coeffs"].shape == (len(idxs), 4, N)
        assert stacked["uv"].shape == (len(idxs), RES, RES, 2)


@pytest.fixture(scope="module")
def two_classes():
    """Four views of one sweep signature (axis z, forward) over 128-wide
    grid planes: two near-axial cameras whose slopes (about 0.9) take the
    JAX package's 128 tiles and two oblique ones (slopes about 2.2) that
    take its dense kernels, so its groups split the signature in two."""
    rng = np.random.default_rng(5)
    shape = (8, 128, 128, 4)
    gt = rng.random(shape, dtype=np.float32) * 0.4
    c = (3.5, 63.5, 63.5)  # (z, y, x) grid center
    eyes = [(c[2] + dx, c[1], -150.0) for dx in (-6.0, 6.0)] + [
        (c[2] + dx, c[1], -300.0) for dx in (130.0, 145.0)]
    jcams = [look_at_perspective(e, (c[2], c[1], c[0]), res_x=128,
                                 res_y=128) for e in eyes]
    tcams = [camera_from_fields(type(j).__name__, **dataclasses.asdict(j))
             for j in jcams]
    targets = np.array(jfit.render_all_views(gt, jcams, JRCFG))
    return shape, jcams, tcams, targets


def test_group_views_splits_tile_classes(two_classes):
    shape, jcams, tcams, _ = two_classes
    jg = jfit.group_views(jcams, shape)
    tg = tfit.group_views(tcams, shape)
    assert sorted(tg) == sorted(jg) == [(2, False, ()),
                                        (2, False, (128, 128))]
    assert {k: v[0] for k, v in tg.items()} == {
        (2, False, ()): [2, 3], (2, False, (128, 128)): [0, 1]}
    assert {k: v[0] for k, v in jg.items()} == {k: v[0] for k, v in tg.items()}


def test_fit_grid_two_tile_classes_matches_jax(two_classes, tmp_path):
    """``fit_grid`` on an orbit whose views span two tile classes draws the
    same groups and views as the JAX trainer: two steps (one per group),
    losses to 1e-6 relative."""
    shape, jcams, tcams, targets = two_classes
    params, _, _, _ = _state(shape, seed=8)
    kw = dict(lr=2e-2, steps=2, views_per_batch=2, ckpt_every=0, seed=3)
    _, _, jh = jfit.fit_grid(targets, jcams, shape, JTrainConfig(**kw),
                             JRCFG, run_dir=str(tmp_path / "j"),
                             params_init=params)
    _, _, th = tfit.fit_grid(targets, tcams, shape, TrainConfig(**kw), RCFG,
                             run_dir=str(tmp_path / "t"),
                             params_init=params, device="cpu")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-6, atol=0)


def test_band_warp_matches(scene):
    shape, jcams, tcams, _ = scene
    _, _, jgeom, _ = jgeo.view_geometry(jcams[3], shape)
    _, _, tgeom, _ = tgeo.view_geometry(tcams[3], shape)
    band = np.random.default_rng(2).random((8, RES, 4)).astype(np.float32)
    for r0 in (0, 5, 8):
        ji, jm = jgeo.warp_to_pixels_band(jnp.asarray(band), jgeom["lattice"],
                                          jgeom["uv"], jnp.int32(r0))
        ti, tm = tgeo.warp_to_pixels_band(torch.as_tensor(band),
                                          tgeom["lattice"], tgeom["uv"], r0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        m = np.asarray(jm)
        assert m.any()
        np.testing.assert_allclose(ti.numpy()[m], np.asarray(ji)[m],
                                   rtol=0, atol=1e-6)


def test_fit_recovers_scene(scene, tmp_path):
    shape, _, tcams, targets = scene
    cfg = TrainConfig(lr=5e-2, steps=150, views_per_batch=4, ckpt_every=0,
                      seed=0)
    grid, _, hist = tfit.fit_grid(targets, tcams, shape, cfg, RCFG,
                                  run_dir=str(tmp_path), device="cpu")
    first = np.mean(hist["loss"][:5])
    last = np.mean(hist["loss"][-5:])
    assert last < first * 0.05, (first, last)
    assert tfit.evaluate_psnr(grid, tcams, targets, RCFG, device="cpu") > 30
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 150


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoint_resume_continuity(scene, tmp_path, bf16):
    shape, _, tcams, targets = scene
    kw = dict(lr=5e-2, views_per_batch=4, ckpt_every=10, seed=0,
              ckpt_bf16=bf16)
    _, p1, h1 = tfit.fit_grid(targets, tcams, shape,
                              TrainConfig(steps=30, **kw), RCFG,
                              run_dir=str(tmp_path), device="cpu")
    saved = torch.load(tmp_path / "ckpt" / "step_29.pt", weights_only=True)
    assert saved["state"]["params"].dtype == (
        torch.bfloat16 if bf16 else torch.float32)
    _, p2, h2 = tfit.fit_grid(targets, tcams, shape,
                              TrainConfig(steps=60, **kw), RCFG,
                              run_dir=str(tmp_path), resume=True,
                              device="cpu")
    assert p2.dtype == torch.float32 and len(h2["loss"]) == 30
    # The resumed run continues from step 30, far below a cold start...
    assert h2["loss"][0] < h1["loss"][0] * 0.5
    # ...and keeps improving.
    assert np.mean(h2["loss"][-5:]) <= np.mean(h1["loss"][-5:])
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_39.pt", "step_49.pt", "step_59.pt"]


def test_steps_per_call_blocks_match_per_step(tmp_path):
    """One view group: blocks of 2 steps and per-step calls draw the same
    views and give the same trajectory (both run the fused mode)."""
    n = 16
    gt = np.array(smoke_sphere(n))
    c = (n - 1) / 2.0
    jcams = [look_at_perspective((c + dx, c - 3.0 * n, c + 0.4 * n),
                                 (c, c, c), res_x=16, res_y=16)
             for dx in (-2.0, 0.0, 2.0)]
    tcams = [camera_from_fields(type(j).__name__, **dataclasses.asdict(j))
             for j in jcams]
    targets = np.array(jfit.render_all_views(gt, jcams, JRCFG))
    runs = {}
    for k in (1, 2):
        cfg = TrainConfig(lr=3e-2, steps=4, views_per_batch=2, ckpt_every=0,
                          seed=11, steps_per_call=k)
        _, params, hist = tfit.fit_grid(targets, tcams, gt.shape, cfg, RCFG,
                                        run_dir=str(tmp_path / f"k{k}"),
                                        device="cpu")
        runs[k] = (params.numpy(), hist["loss"])
    np.testing.assert_allclose(runs[2][1], runs[1][1], rtol=1e-6)
    np.testing.assert_allclose(runs[2][0], runs[1][0], atol=1e-6)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fused_matches_materialized(scene, tmp_path, steps_per_call):
    """The fused mode (state in sweep layout, softplus in the sweeps)
    against the materialized mode, across group switches: the two
    softplus forms (the kernels' max(x,0) + log(1 + e^-|x|) and
    torch.nn.functional.softplus) differ in roundoff only, so losses agree
    to 1e-5 relative and parameters to 1e-4 (Adam's sign-like first steps
    carry a roundoff-sized gradient difference to a full lr step only
    where |g| is near roundoff; lr 2e-2)."""
    shape, _, tcams, targets = scene
    cfg = TrainConfig(lr=2e-2, steps=4, views_per_batch=2, ckpt_every=0,
                      seed=3, steps_per_call=steps_per_call)
    runs = {}
    for fused in (True, False):
        _, params, hist = tfit.fit_grid(targets, tcams, shape, cfg, RCFG,
                                        run_dir=str(tmp_path / str(fused)),
                                        fused=fused, device="cpu")
        runs[fused] = (params.numpy(), hist["loss"])
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-5)
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=0,
                               atol=1e-4)


def test_fit_grid_refuses_unported_options(scene, tmp_path):
    shape, _, tcams, targets = scene
    # A ('data', 'z') mesh made by hand (no process group): its refusals
    # come before any collective; the replicated step is not for it.
    z_mesh = GridMesh(2, 2, 0, data=DataMesh(None, 0, 2),
                      z=DataMesh(None, 0, 2), flat=DataMesh(None, 0, 4))
    with pytest.raises(ValueError, match="grad_ring"):
        tfit.fit_grid(targets, tcams, shape, mesh=z_mesh, device="cpu",
                      grad_ring=True)
    with pytest.raises(ValueError, match="make_train_step_zsharded"):
        tfit.make_train_step((2, False), 2, tfit.Adam(0.1), RCFG, True, None,
                             mesh=z_mesh, grad_ring=True)
    for kw in (dict(grad_ring=True), dict(bwd_chunks=2)):
        with pytest.raises(ValueError, match="mesh"):
            tfit.fit_grid(targets, tcams, shape, device="cpu", **kw)
    with pytest.raises(ValueError, match="fused"):
        tfit.make_train_step((2, False), 2, tfit.Adam(0.1), RCFG, False,
                             None, kernel_softplus=True)
    with pytest.raises(ValueError, match="fused"):
        tfit.fit_grid(targets, tcams, shape,
                      lighting=LightingConfig(mode="lightvolume"),
                      fused=True, run_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("switch", [None, "0"])
def test_fit_grid_honours_fused_softplus_switch(scene, tmp_path, monkeypatch,
                                                switch):
    """``fused=None`` chooses as the JAX trainer does: blocks of two steps
    with softplus density build fused steps, unless TPUVR_FUSED_SOFTPLUS=0
    (that package's switch) asks for the configured mode."""
    if switch is None:
        monkeypatch.delenv("TPUVR_FUSED_SOFTPLUS", raising=False)
    else:
        monkeypatch.setenv("TPUVR_FUSED_SOFTPLUS", switch)
    shape, _, tcams, targets = scene
    built = []
    make = tfit.make_train_step

    def spy(*args, **kw):
        built.append(kw["kernel_softplus"])
        return make(*args, **kw)

    monkeypatch.setattr(tfit, "make_train_step", spy)
    cfg = TrainConfig(lr=2e-2, steps=2, views_per_batch=2, ckpt_every=0,
                      seed=3, steps_per_call=2)
    tfit.fit_grid(targets, tcams, shape, cfg, RCFG, run_dir=str(tmp_path),
                  device="cpu")
    assert len(built) == 4
    assert set(built) == {switch is None}
