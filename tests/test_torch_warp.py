"""tpuvr_torch's row-block pixel warp (``TPUVR_WARP=rows``) held against
the JAX package's on the CPU: the plan bit for bit, the plain twins
against its jnp twin and its Pallas kernels in interpret mode, and the
trainer and the grouped render under rows against the JAX trainer's.

Tolerances: the warp takes the same two taps each way with the same f32
weights as the JAX forms, which differ only in multiply order and in
summing the taps with or without a fused multiply-add: 1e-6 absolute on
values in [0, 1) (3e-7 against the plain numpy gather, the JAX file's own
bound), 3e-6 on gradients of order 1 (the JAX file's bound). The trainer:
the loss to 1e-6 relative and the gradient to 1e-5 of its max, as in
``tests/test_torch_train.py``; images to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.config import TrainConfig as JTrainConfig
from tpuvr.io.synth import orbit_cameras, smoke_sphere
from tpuvr.ops import warp as jwarp
from tpuvr.ref.camera import look_at_perspective
from tpuvr.train import fit as jfit
from tpuvr_torch.config import RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.kernels.warp_torch import (
    warp_rows_bwd_torch,
    warp_rows_fwd_torch,
)
from tpuvr_torch.ops import warp as twarp
from tpuvr_torch.train import fit as tfit

RCFG = RenderConfig(early_stop_eps=0.0, precision="highest")
JRCFG = JRenderConfig(early_stop_eps=0.0, precision="highest")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positions(seed, n_v, n_u, res, diagonal=False):
    """The JAX file's position maps (``tests/test_row_warp.py``): lattice
    rows tracking pixel rows, or (diagonal) both pixel axes, with jitter."""
    rng = np.random.default_rng(seed)
    if diagonal:
        base = (np.linspace(0, n_v - 1.01, res)[:, None] * 0.5
                + np.linspace(0, n_v - 1.01, res)[None, :] * 0.5)
        y = (base + rng.uniform(-1, 1, (res, res))).clip(0, n_v - 1)
    else:
        y = (np.linspace(0, n_v - 1.01, res)[:, None]
             + rng.uniform(-1, 1, (res, res))).clip(0, n_v - 1)
    x = (np.linspace(0, n_u - 1.01, res)[None, :]
         + rng.uniform(-1, 1, (res, res))).clip(0, n_u - 1)
    return y.astype(np.float32), x.astype(np.float32)


def _gather_ref(inter, y, x):
    n_c, n_v, n_u = inter.shape
    iv0 = np.floor(y).astype(int)
    iu0 = np.floor(x).astype(int)
    fv, fx = y - iv0, x - iu0
    iv1 = np.minimum(iv0 + 1, n_v - 1)
    iu1 = np.minimum(iu0 + 1, n_u - 1)
    return (((1 - fv) * (1 - fx))[None] * inter[:, iv0, iu0]
            + ((1 - fv) * fx)[None] * inter[:, iv0, iu1]
            + (fv * (1 - fx))[None] * inter[:, iv1, iu0]
            + (fv * fx)[None] * inter[:, iv1, iu1])


def _assert_plans_equal(tp, jp):
    assert (tp is None) == (jp is None)
    if tp is None:
        return
    assert tuple(tp[0]) == tuple(jp[0])
    for t, j in zip(tp[1:], jp[1:]):
        assert t.dtype == j.dtype and np.array_equal(t, j)


@pytest.mark.parametrize("override", [None, "8x0", "16x16", "8x8"])
@pytest.mark.parametrize("diagonal", [False, True])
def test_plan_row_warp_matches_jax(monkeypatch, diagonal, override):
    """The plan (tile, window height, origins) and the tiled positions, bit
    for bit, for two views of a group; ``TPUVR_WARP_ROWS`` forces a tile."""
    if override:
        monkeypatch.setenv("TPUVR_WARP_ROWS", override)
    else:
        monkeypatch.delenv("TPUVR_WARP_ROWS", raising=False)
    n_v, n_u, res = 48, 128, 32
    pos = [_positions(s, n_v, n_u, res, diagonal) for s in (3, 4)]
    tp = twarp.plan_row_warp(pos, n_v, n_u)
    assert tp is not None
    if override:
        ty, tx = (int(s) for s in override.split("x"))
        assert (tp[0].ty, tp[0].tx) == (ty, tx or res)
    _assert_plans_equal(tp, jwarp.plan_row_warp(pos, n_v, n_u))


@pytest.mark.parametrize("case", ["v_not_8", "full_extent"])
def test_plan_row_warp_none_cases_match_jax(monkeypatch, case):
    monkeypatch.delenv("TPUVR_WARP_ROWS", raising=False)
    if case == "v_not_8":
        n_v, n_u = 50, 64
        pos = [_positions(1, n_v, n_u, 32)]
    else:
        # Every tile's rows span the whole lattice: no window is shorter.
        n_v, n_u = 16, 64
        y = np.tile(np.array([0.0, 15.0], np.float32), (32, 16))
        pos = [(y, _positions(1, n_v, n_u, 32)[1])]
    assert twarp.plan_row_warp(pos, n_v, n_u) is None
    assert jwarp.plan_row_warp(pos, n_v, n_u) is None


def test_lattice_positions_and_image_match_jax():
    rng = np.random.default_rng(2)
    uv = rng.uniform(-3.0, 40.0, (16, 24, 2)).astype(np.float32)
    lattice = tuple(np.array([1.5, 0.75, -2.0, 1.25], np.float32))
    for t, j in zip(twarp.lattice_positions(lattice, uv, 32, 48),
                    jwarp.lattice_positions(lattice, uv, 32, 48)):
        assert t.dtype == j.dtype == np.float32 and np.array_equal(t, j)
    plan = twarp.RowWarpPlan(8, 12, 16, 16, 24)
    out = rng.random((3, 4, 96), dtype=np.float32)
    np.testing.assert_array_equal(
        twarp.row_warp_image(torch.as_tensor(out), plan).numpy(),
        np.asarray(jwarp.row_warp_image(jnp.asarray(out),
                                        jwarp.RowWarpPlan(*plan))))


def _warp_case(seed, diagonal):
    n_v, n_u, res = 48, 128, 32
    y, x = _positions(seed, n_v, n_u, res, diagonal)
    plan, vb, yf, xf = twarp.plan_row_warp([(y, x)], n_v, n_u)
    rng = np.random.default_rng(seed + 2)
    inter = rng.random((4, n_v, n_u), dtype=np.float32)
    return plan, inter, (yf[0], xf[0], vb[0]), (y, x)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("diagonal", [False, True])
def test_warp_rows_fwd_twin_matches_jax(diagonal, impl):
    plan, inter, args, (y, x) = _warp_case(3, diagonal)
    op = jwarp.row_warp_op(plan.f_v, impl,
                           interpret=True if impl == "pallas" else None)
    ref = np.asarray(op(jnp.asarray(inter), *map(jnp.asarray, args)))
    out = warp_rows_fwd_torch(torch.as_tensor(inter),
                              *map(torch.as_tensor, args), f_v=plan.f_v)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    img = twarp.row_warp_image(out, plan).numpy()
    np.testing.assert_allclose(img, _gather_ref(inter, y, x), rtol=0,
                               atol=3e-7)


@pytest.mark.parametrize("diagonal", [False, True])
def test_row_warp_op_grad_matches_jax_pallas(diagonal):
    """``row_warp_op('torch')``'s autograd gradient of sum(out^2) against
    ``jax.grad`` through the interpret-mode Pallas pair."""
    plan, inter, args, _ = _warp_case(7, diagonal)
    jop = jwarp.row_warp_op(plan.f_v, "pallas", interpret=True)
    jargs = tuple(map(jnp.asarray, args))
    g_j = np.asarray(jax.grad(
        lambda g: jnp.sum(jop(g, *jargs) ** 2))(jnp.asarray(inter)))
    g = torch.as_tensor(inter).requires_grad_(True)
    out = twarp.row_warp_op(plan.f_v, "torch")(
        g, *map(torch.as_tensor, args))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), g_j, rtol=0, atol=3e-6)
    assert np.abs(g_j).max() > 0.5


def test_warp_rows_bwd_twin_is_the_transpose():
    """<fwd(L), d> == <L, bwd(d)> in float64 arithmetic on the twins."""
    plan, inter, args, _ = _warp_case(4, True)
    rng = np.random.default_rng(9)
    t_args = [torch.as_tensor(a) for a in args]
    d = rng.standard_normal((4, *args[0].shape)).astype(np.float32)
    lhs = (warp_rows_fwd_torch(torch.as_tensor(inter), *t_args, f_v=plan.f_v)
           .double() * torch.as_tensor(d).double()).sum()
    rhs = (torch.as_tensor(inter).double()
           * warp_rows_bwd_torch(torch.as_tensor(d), *t_args, 48, 128,
                                 f_v=plan.f_v).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))


def test_row_warp_op_routes_to_the_kernels(monkeypatch):
    """``row_warp_op('cuda')`` is an autograd Function whose forward and
    backward call the warp kernels' wrappers (stand-ins here record the
    calls); 'torch' runs the twins; any other impl raises."""
    calls = []

    def stand_in(name, fn):
        return lambda *a, **kw: calls.append(name) or fn(*a, **kw)

    monkeypatch.setattr(twarp, "warp_rows_fwd",
                        stand_in("fwd", warp_rows_fwd_torch))
    monkeypatch.setattr(twarp, "warp_rows_bwd",
                        stand_in("bwd", warp_rows_bwd_torch))
    gen = torch.Generator().manual_seed(0)
    inter = torch.rand((4, 16, 12), generator=gen).requires_grad_(True)
    y = torch.rand((3, 8), generator=gen) * 15
    x = torch.rand((3, 8), generator=gen) * 11
    vb = torch.tensor([0, 8, 4], dtype=torch.int32)
    out = twarp.row_warp_op(8, "cuda")(inter, y, x, vb)
    assert type(out.grad_fn).__name__ == "_RowWarpBackward"
    out.square().sum().backward()
    assert calls == ["fwd", "bwd"] and float(inter.grad.abs().max()) > 0
    plain = twarp.row_warp_op(8, "torch")(inter.detach(), y, x, vb)
    assert torch.equal(plain, out.detach()) and calls == ["fwd", "bwd"]
    with pytest.raises(ValueError, match="impl"):
        twarp.row_warp_op(8, "pallas")


# ---------------------------------------------------------------------------
# The trainer and the grouped render under TPUVR_WARP=rows.


def _scene(n):
    """A 16 x n x n grid seen by two perspective cameras at n^2, one view
    group that gets a row plan: at n = 128 the JAX row-warp file's scene
    (``tests/test_row_warp.py``)."""
    rng = np.random.default_rng(11)
    gshape = (16, n, n, 4)
    gt = rng.random(gshape, dtype=np.float32) * 0.4
    c = (7.5, (n - 1) / 2, (n - 1) / 2)
    s = n / 128
    jcams = [look_at_perspective((c[2] + dx * s, c[1], -300.0 * s),
                                 (c[2], c[1], c[0]), res_x=n, res_y=n)
             for dx in (-12.0, 15.0)]
    tcams = [camera_from_fields(type(j).__name__, **dataclasses.asdict(j))
             for j in jcams]
    targets = np.asarray(jfit.render_all_views(jnp.asarray(gt), jcams, JRCFG,
                                               impl="xla"))
    return gshape, gt, jcams, tcams, targets


@pytest.fixture(scope="module")
def rows_scene():
    return _scene(128)


@pytest.fixture(scope="module")
def half_scene():
    """The same scene at half the width. One step's gradient is compared
    here: at 128^2 the two trainers' gradients differ by 1.1-1.8e-5 of
    their max whichever warp runs (the port's 4-tap gather against the
    JAX tiled warp gives the same figure), the sweep's f32 sums over 4x
    the rays; at 64^2 by 6e-6."""
    return _scene(64)


@pytest.fixture
def rows(monkeypatch):
    monkeypatch.setenv("TPUVR_WARP", "rows")
    monkeypatch.delenv("TPUVR_WARP_ROWS", raising=False)


def test_group_views_rows_matches_jax(rows_scene, rows):
    """Under rows the port's groups carry the JAX package's keys, plans and
    stacked ``rwvb``/``rwy``/``rwx``, bit for bit."""
    gshape, _, jcams, tcams, _ = rows_scene
    jg = jfit.group_views(jcams, gshape)
    tg = tfit.group_views(tcams, gshape)
    assert sorted(tg) == sorted(jg)
    for key, (idxs, stacked, _, plan) in tg.items():
        j_idxs, j_stacked, _, j_plan = jg[key]
        assert idxs == j_idxs
        assert isinstance(plan, twarp.RowWarpPlan)
        assert tuple(plan) == tuple(j_plan)
        for name in ("rwvb", "rwy", "rwx"):
            ref = np.asarray(j_stacked[name])
            assert stacked[name].numpy().dtype == ref.dtype
            np.testing.assert_array_equal(stacked[name].numpy(), ref)


def test_group_views_without_rows_has_no_plan(rows_scene, monkeypatch):
    monkeypatch.delenv("TPUVR_WARP", raising=False)
    gshape, _, _, tcams, _ = rows_scene
    for _, stacked, _, plan in tfit.group_views(tcams, gshape).values():
        assert plan is None and "rwvb" not in stacked


class _CaptureGrad:
    def init(self, params):
        return None

    def update(self, grads, state):
        return torch.zeros_like(grads), grads


_J_CAPTURE = optax.GradientTransformation(
    lambda p: jnp.zeros_like(p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _raw_params(shape, seed):
    rng = np.random.default_rng(seed)
    return (np.array(jfit.init_params(shape, True))
            + rng.normal(0.0, 0.3, shape).astype(np.float32))


@pytest.mark.parametrize("view_batch", [False, True])
def test_rows_train_step_matches_jax(half_scene, rows, view_batch):
    """One step of each trainer under rows, from one state, both views of
    the group: the loss and the gradient (captured by the optimizer)."""
    gshape, _, jcams, tcams, targets = half_scene
    params = _raw_params(gshape, 5)
    (key, (idxs, stacked, band, plan)), = jfit.group_views(
        jcams, gshape).items()
    _, tstacked, _, tplan = tfit.group_views(tcams, gshape)[key]
    assert isinstance(plan, jwarp.RowWarpPlan)
    pick, r0s = np.array([1, 0]), np.zeros(2, np.int32)
    jstep = jfit.make_train_step(key, 2, _J_CAPTURE, JRCFG, True, "xla",
                                 None, band=band, warp_tiling=plan,
                                 view_batch=view_batch, prestage=True)
    _, g_j, loss_j = jstep(jnp.asarray(params), jnp.zeros(gshape),
                           stacked, jnp.asarray(targets[np.array(idxs)]),
                           jnp.asarray(pick), jnp.asarray(r0s))
    tstep = tfit.make_train_step(key, 2, _CaptureGrad(), RCFG, True, None,
                                 view_batch=view_batch, warp_tiling=tplan)
    _, g_t, loss_t = tstep(torch.as_tensor(params), None, tstacked,
                           torch.as_tensor(targets[idxs]), pick, r0s)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6 * float(loss_j)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 1e-7
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_rows_train_step_matches_gather(half_scene, rows):
    """The port's step with the row warp against the same step with the
    4-tap gather: the same taps and weights."""
    gshape, _, _, tcams, targets = half_scene
    params = torch.as_tensor(_raw_params(gshape, 6))
    (key, (idxs, stacked, _, plan)), = tfit.group_views(
        tcams, gshape).items()
    res = {}
    for tiling in (plan, None):
        step = tfit.make_train_step(key, 2, _CaptureGrad(), RCFG, True, None,
                                    view_batch=True, warp_tiling=tiling)
        _, g, loss = step(params, None, stacked,
                          torch.as_tensor(targets[idxs]), np.array([0, 1]),
                          np.zeros(2, np.int32))
        res[tiling is None] = (float(loss), g.numpy())
    assert abs(res[True][0] - res[False][0]) <= 1e-6 * res[True][0]
    np.testing.assert_allclose(res[False][1], res[True][1], rtol=0,
                               atol=1e-5 * np.abs(res[True][1]).max())


def test_rows_fit_grid_first_step_matches_jax(rows_scene, rows, tmp_path):
    """Whole ``fit_grid`` calls under rows, one step from one warm start."""
    gshape, _, jcams, tcams, targets = rows_scene
    params = _raw_params(gshape, 8)
    kw = dict(lr=2e-2, steps=1, views_per_batch=2, ckpt_every=0, seed=3)
    _, jp, jh = jfit.fit_grid(targets, jcams, gshape, JTrainConfig(**kw),
                              JRCFG, run_dir=str(tmp_path / "j"),
                              params_init=params)
    _, tp, th = tfit.fit_grid(targets, tcams, gshape, TrainConfig(**kw),
                              RCFG, run_dir=str(tmp_path / "t"),
                              params_init=params, device="cpu")
    assert abs(th["loss"][0] - jh["loss"][0]) <= 1e-6 * jh["loss"][0]
    # Adam's first step is lr * g / (|g| + 1e-8): the gradients here are
    # 1e-9 to 1e-7, so compare where |g| > 3e-8 (a step of 0.75 lr), where
    # a roundoff-sized gradient difference moves the step by < 1e-6.
    moved = np.abs(np.asarray(jp) - params) > 0.75 * 2e-2
    assert moved.mean() > 0.05
    np.testing.assert_allclose(tp.numpy()[moved], np.asarray(jp)[moved],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("warp", ["rows", "default"])
def test_render_views_grouped_matches_jax(rows_scene, monkeypatch, warp):
    """The grouped render (and evaluate_psnr through it) under rows and
    under the default warp (the JAX package's tiled warp against the
    port's 4-tap gather) against the JAX package's."""
    if warp == "rows":
        monkeypatch.setenv("TPUVR_WARP", "rows")
    else:
        monkeypatch.delenv("TPUVR_WARP", raising=False)
    gshape, gt, jcams, tcams, targets = rows_scene
    grid = gt * 0.8 + 0.05
    ref = np.asarray(jfit.render_views_grouped(jnp.asarray(grid), jcams,
                                               JRCFG, impl="xla"))
    out = tfit.render_views_grouped(grid, tcams, RCFG, device="cpu")
    assert out.shape == ref.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    p_j = jfit.evaluate_psnr(jnp.asarray(grid), jcams, targets, JRCFG,
                             impl="xla")
    p_t = tfit.evaluate_psnr(grid, tcams, targets, RCFG, device="cpu")
    assert abs(p_t - p_j) <= 1e-5 * abs(p_j)


def test_render_views_grouped_orbit_matches_render_all_views():
    """On an orbit of four view groups, the grouped render equals the
    per-camera render of ``render_all_views``."""
    gt = np.asarray(smoke_sphere(12))
    cams = [camera_from_fields(type(c).__name__, **dataclasses.asdict(c))
            for c in orbit_cameras(8, 12, res=16, elevation_deg=25.0)]
    a = tfit.render_views_grouped(gt, cams, RCFG, device="cpu")
    b = tfit.render_all_views(gt, cams, RCFG, device="cpu")
    assert len(tfit.group_views(cams, gt.shape)) == 4
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case,match", [
    ("ok", None), ("x_shape", "shape"), ("y_double", "float32"),
    ("vb_long", "int32"), ("f_v", "f_v"), ("smem", "shared memory"),
    ("transposed", "contiguous"), ("vb_shape", "vbase has shape")])
def test_row_warp_wrapper_checks_name_each_fault(case, match):
    """The kernel wrappers' one chained check passes good tiles and, for a
    bad one, raises the ValueError that names the fault (the checks run
    before any launch, so they are held here on CPU tensors)."""
    from tpuvr_torch.kernels import warp as kwarp

    y, x = torch.zeros(4, 8), torch.zeros(4, 8)
    vb = torch.zeros(4, dtype=torch.int32)
    lattice, f_v = (4, 16, 16), 8
    if case == "x_shape":
        x = x[:, :-1].contiguous()
    elif case == "y_double":
        y = y.double()
    elif case == "vb_long":
        vb = vb.long()
    elif case == "f_v":
        f_v = 24
    elif case == "smem":
        lattice, f_v = (4, 512, 8), 512
    elif case == "transposed":
        y, x = y.t(), x.t()
    elif case == "vb_shape":
        vb = vb[:3]
    if match is None:
        assert tuple(kwarp._check(lattice, y, x, vb, f_v, y.device)) == (4, 8)
        return
    with pytest.raises(ValueError, match=match):
        kwarp._check(lattice, y, x, vb, f_v, y.device)
