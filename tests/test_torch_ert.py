"""Slab-chunked early ray termination (``RenderConfig.ert_chunks``) in
tpuvr_torch, held against the JAX package's ``render_view(impl="xla")``
with the same config, after ``tests/test_ert_chunked.py``.

The port keeps the liveness gate on the device: a dead slab runs with its
steps disabled and leaves the carry unchanged, where the JAX package's
``lax.cond`` skips it. Tolerances: the port against JAX 1e-6 (the same f32
arithmetic in another order); chunked against unchunked 2e-6 on a scene
where no slab dies, and the ERT bound (rgb 5 eps, T eps) where slabs die.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.ops.render import render_view as jrender_view
from tpuvr.ops.vjp import _future_coverage_masks as jmasks
from tpuvr.ref.camera import OrthoCamera as JOrthoCamera
from tpuvr.ref.camera import look_at_perspective
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.kernels.sweep_torch import _interp_matrices
from tpuvr_torch.ops import render as trender
from tpuvr_torch.ops import vjp as tvjp
from tpuvr_torch.ref.camera import dominant_axis

N = 16
RES = 16
EPS_OPAQUE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcams():
    c = (N - 1) / 2.0
    return [
        JOrthoCamera(center=(c, c, -2.0 * N), forward=(0.0, 0.0, 1.0),
                     up=(0.0, 1.0, 0.0), width=1.4 * N, height=1.4 * N,
                     res_x=RES, res_y=RES),
        # reversed traversal (axis-0 dominant)
        look_at_perspective((c + 3.0 * N, c + 0.2 * N, c - 0.4 * N),
                            (c, c, c), res_x=RES, res_y=RES),
    ]


def _cam(i):
    jc = _jcams()[i]
    return camera_from_fields(type(jc).__name__, **dataclasses.asdict(jc))


def _sphere():
    return np.array(smoke_sphere(N, dtype=jnp.float32))


def _fog():
    return np.full((N, N, N, 4), 0.5, np.float32)


def _both(grid, i, **kw):
    """(port, JAX) images of ``grid`` through camera ``i`` with ``kw``."""
    rgb_j, t_j = jrender_view(jnp.asarray(grid), _jcams()[i],
                              JRenderConfig(**kw), impl="xla")
    rgb, t = trender.render_view(torch.as_tensor(grid), _cam(i),
                                 RenderConfig(**kw), device="cpu")
    return (rgb.numpy(), t.numpy()), (np.asarray(rgb_j), np.asarray(t_j))


def _close(a, b, tol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=tol)


def _within_ert_bound(a, b, eps):
    assert float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()) < 5 * eps
    assert float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()) < eps


@pytest.mark.parametrize("cam_i", [0, 1])
def test_transparent_matches_jax_and_unchunked(cam_i):
    kw = dict(early_stop_eps=1e-4, precision="highest")
    port, jax_img = _both(_sphere(), cam_i, ert_chunks=4, **kw)
    _close(port, jax_img, 1e-6)
    whole, _ = _both(_sphere(), cam_i, **kw)
    _close(port, whole, 2e-6)
    assert port[0].max() > 0.05


def test_opaque_matches_jax_and_the_ert_bound():
    kw = dict(precision="highest", sigma_scale=8.0)
    port, jax_img = _both(_fog(), 0, early_stop_eps=EPS_OPAQUE,
                          ert_chunks=4, **kw)
    _close(port, jax_img, 1e-6)
    exact, _ = _both(_fog(), 0, early_stop_eps=0.0, **kw)
    _within_ert_bound(port, exact, EPS_OPAQUE)


def _port_grad(cfg, cam_i=1):
    g = torch.as_tensor(_sphere()).requires_grad_(True)
    rgb, _ = trender.render_view(g, _cam(cam_i), cfg, device="cpu")
    (grad,) = torch.autograd.grad(torch.mean((rgb - 0.25) ** 2), g)
    return grad.numpy()


def test_gradient_matches_jax_and_unchunked():
    kw = dict(early_stop_eps=1e-4, precision="highest")

    def loss(g):
        rgb, _ = jrender_view(g, _jcams()[1], JRenderConfig(ert_chunks=4,
                                                            **kw),
                              impl="xla")
        return jnp.mean((rgb - 0.25) ** 2)

    ref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(_sphere())))
    got = _port_grad(RenderConfig(ert_chunks=4, **kw))
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, _port_grad(RenderConfig(**kw)), rtol=0,
                               atol=2e-6)


def test_ert_chunks_must_divide():
    with pytest.raises(ValueError, match="ert_chunks"):
        trender.render_view(torch.as_tensor(_sphere()), _cam(0),
                            RenderConfig(early_stop_eps=1e-4, ert_chunks=5),
                            device="cpu")


def _sweep_args(grid, i, cfg):
    cam = _cam(i)
    prep = trender.prepare_grid(torch.as_tensor(grid),
                                axes=(dominant_axis(cam),), device="cpu")
    return trender.sweep_inputs(prep, cam, cfg, "cpu")


@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_row_chunks_times_slab_chunks(eps):
    """Row chunks (``max_rows_per_call`` 4 of the reverse camera's 16
    intermediate rows) under slab chunks give the frame and gradient of
    one row chunk: bit for bit with the gate open (eps 0: every slab runs,
    and each row is swept exactly as in the whole frame), within the ERT
    bound with it live. Each row chunk builds its coverage mask from its
    own rows (``row0``)."""
    plan, _, (gsc, coeffs, en, dt) = _sweep_args(_sphere(), 1,
                                                 RenderConfig())
    assert dt.shape[0] == 16 and plan.reverse
    rng = np.random.default_rng(5)
    cot = (torch.as_tensor(rng.standard_normal((3, *dt.shape)),
                           dtype=dt.dtype),
           torch.as_tensor(rng.standard_normal(tuple(dt.shape)),
                           dtype=dt.dtype))
    op = tvjp.sweep_op(plan.reverse, 1.0, eps, "torch")

    def run(max_rows):
        g = gsc.clone().requires_grad_(True)
        if eps == 0.0:  # chunked_sweep routes eps 0 around the slabs
            n = dt.shape[0] if max_rows is None else max_rows
            outs = [tvjp.ert_chunked_sweep(op, g, coeffs, en, dt[r:r + n],
                                           4, plan.reverse, 0.0, row0=r)
                    for r in range(0, dt.shape[0], n)]
            out = (torch.cat([o[0] for o in outs], 1),
                   torch.cat([o[1] for o in outs], 0))
        else:
            out = tvjp.chunked_sweep(op, g, coeffs, en, dt,
                                     max_rows=max_rows, ert_chunks=4,
                                     reverse=plan.reverse, eps=eps)
        (grad,) = torch.autograd.grad(out, g, cot)
        return [t.detach() for t in out], grad

    (img_r, grad_r), (img, grad) = run(4), run(None)
    if eps == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(img_r, img))
        assert torch.equal(grad_r, grad)
    else:
        _within_ert_bound(img_r, img, eps)
        np.testing.assert_allclose(grad_r.numpy(), grad.numpy(), rtol=0,
                                   atol=1e-5 * float(grad.abs().max()))


def test_row_chunk_mask_is_the_whole_frames_rows():
    """The mask of rows [r0, r0 + 4) built with ``row0`` is those rows of
    the whole frame's mask, on the reverse camera's geometry."""
    _, _, (gsc, coeffs, en, dt) = _sweep_args(_sphere(), 1, RenderConfig())
    n_v, n_u = dt.shape
    args = (gsc.shape[2], gsc.shape[3], gsc.shape[0] // 4, 4)
    whole = tvjp._future_coverage_masks(coeffs, en, n_v, n_u, *args)
    assert bool(whole.any()) and not bool(whole.all())
    for r0 in range(0, n_v, 4):
        part = tvjp._future_coverage_masks(coeffs, en, 4, n_u, *args,
                                           row0=r0)
        assert torch.equal(part, whole[:, r0:r0 + 4])


def _draw(rng, n, s):
    return [rng.uniform(-1.5, 1.5, s).astype(np.float32),
            rng.uniform(-2 * n, 2 * n, s).astype(np.float32),
            rng.uniform(-1.5, 1.5, s).astype(np.float32),
            rng.uniform(-2 * n, 2 * n, s).astype(np.float32)]


def test_mask_matches_jax():
    """Equal booleans on 50 seeded draws of coefficients at n 384, with
    and without enables."""
    rng = np.random.default_rng(7)
    n, s, n_chunks = 384, 8, 4
    for d in range(50):
        coeffs = _draw(rng, n, s)
        en = (rng.uniform(size=s) > 0.3).astype(np.float32)
        use_en = d % 2 == 0
        ref = jmasks(tuple(jnp.asarray(c) for c in coeffs),
                     jnp.asarray(en) if use_en else None, n, n, n, n,
                     s // n_chunks, n_chunks)
        got = tvjp._future_coverage_masks(
            tuple(torch.as_tensor(c) for c in coeffs),
            torch.as_tensor(en) if use_en else None, n, n, n, n,
            s // n_chunks, n_chunks)
        assert got.shape == (n_chunks - 1, n, n) and got.dtype == torch.bool
        for g in range(n_chunks - 1):
            np.testing.assert_array_equal(got[g].numpy(), np.asarray(ref[g]))


@pytest.mark.parametrize("row0", [0, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_covers_every_twin_tent(row0, dtype):
    """A ray outside the mask takes exactly zero weight from every
    remaining step's tents as the twin builds them (positions in f32,
    weights cast to the dtype), rows from ``row0``."""
    rng = np.random.default_rng(11 + row0)
    n = 384
    s, n_chunks = 8, 4
    sc = s // n_chunks
    for _ in range(20):
        coeffs = [torch.as_tensor(c) for c in _draw(rng, n, s)]
        masks = tvjp._future_coverage_masks(coeffs, None, n, n, n, n, sc,
                                            n_chunks, row0=row0)
        for g in range(1, n_chunks):
            out = ~masks[g - 1]
            for k in range(g * sc, s):
                mat_a, mat_b = _interp_matrices(
                    *(c[k] for c in coeffs), n, n, n, n, dtype, row0)
                w_v = mat_a.float().amax(dim=1)
                w_u = mat_b.float().amax(dim=0)
                w = w_v[:, None] * w_u[None, :]
                if bool(out.any()):
                    assert float(w[out].max()) == 0.0, (g, k)


def test_mask_refuses_a_view_batch():
    c2 = torch.ones((2, 8))
    with pytest.raises(ValueError, match="single-view"):
        tvjp._future_coverage_masks((c2, c2, c2, c2), None, 16, 16, 16, 16,
                                    2, 4)
    en2 = torch.ones((2, 8))
    c1 = torch.ones(8)
    with pytest.raises(ValueError, match="single-view"):
        tvjp._future_coverage_masks((c1, c1, c1, c1), en2, 16, 16, 16, 16,
                                    2, 4)


def test_gate_fires_with_background_rays():
    """On the opaque fog seen by the wide ortho camera, corner rays miss
    the volume and keep T = 1: the unmasked max(T) stays >= eps after the
    first slab, the masked gate goes dead, and every gated slab's sweep
    gives C = 0 and T = 1 exactly, so the carry is left as it was."""
    cfg = RenderConfig(early_stop_eps=EPS_OPAQUE, sigma_scale=8.0)
    plan, _, (gsc, coeffs, en, dt) = _sweep_args(_fog(), 0, cfg)
    n_chunks = 4
    sc = gsc.shape[0] // n_chunks
    masks = tvjp._future_coverage_masks(coeffs, en, *dt.shape,
                                        gsc.shape[2], gsc.shape[3], sc,
                                        n_chunks)
    assert not bool(masks[0].all())
    op = tvjp.sweep_op(plan.reverse, 8.0, EPS_OPAQUE, "torch")
    trans = None
    for g in range(n_chunks):
        tr = slice(g * sc, (g + 1) * sc)
        lo = gsc.shape[0] - (g + 1) * sc if plan.reverse else g * sc
        en_g = en[tr]
        if g:
            live = torch.amax(torch.where(masks[g - 1], trans, 0.0))
            assert float(torch.max(trans)) >= EPS_OPAQUE
            assert float(live) < EPS_OPAQUE
            en_g = en_g * (live >= EPS_OPAQUE).to(en_g.dtype)
        rgb_g, t_g = op(gsc[lo:lo + sc], tuple(c[tr] for c in coeffs),
                        en_g, dt)
        if g:
            assert bool((rgb_g == 0.0).all()) and bool((t_g == 1.0).all())
        else:
            trans = t_g
    port, jax_img = _both(_fog(), 0, early_stop_eps=EPS_OPAQUE,
                          sigma_scale=8.0, ert_chunks=n_chunks)
    exact, _ = _both(_fog(), 0, early_stop_eps=0.0, sigma_scale=8.0)
    _within_ert_bound(port, exact, EPS_OPAQUE)


@pytest.mark.parametrize("kw", [dict(ert_chunks=1, early_stop_eps=1e-4),
                                dict(ert_chunks=4, early_stop_eps=0.0)])
def test_gate_off_is_todays_route(kw):
    """ert_chunks 1, or eps 0, sweep in one call: bit for bit the op's own
    frame and gradient."""
    plan, _, (gsc, coeffs, en, dt) = _sweep_args(_sphere(), 1,
                                                 RenderConfig(**kw))
    op = tvjp.sweep_op(plan.reverse, 1.0, kw["early_stop_eps"], "torch")
    cot = (torch.ones((3, *dt.shape)), torch.ones(tuple(dt.shape)))

    def run(fn):
        g = gsc.clone().requires_grad_(True)
        out = fn(g)
        return [t.detach() for t in out], torch.autograd.grad(out, g, cot)[0]

    a = run(lambda g: tvjp.chunked_sweep(
        op, g, coeffs, en, dt, max_rows=None, ert_chunks=kw["ert_chunks"],
        reverse=plan.reverse, eps=kw["early_stop_eps"]))
    b = run(lambda g: op(g, coeffs, en, dt))
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])


def test_fixed_dt_ignores_ert_chunks():
    kw = dict(mode="fixed_dt", step_dt=0.5, early_stop_eps=1e-4)
    grid = torch.as_tensor(_sphere())
    a = trender.render_view(grid, _cam(1), RenderConfig(**kw), device="cpu")
    b = trender.render_view(grid, _cam(1), RenderConfig(ert_chunks=4, **kw),
                            device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_render_view_dp_refuses_slab_chunks_before_any_collective():
    """A hand-built 2-rank mesh with no process group: a collective would
    raise "Default process group has not been initialized" (a ValueError
    too), so the match holds the refusal's own message."""
    from tpuvr_torch.dist.init import DataMesh
    from tpuvr_torch.dist.replicated import render_view_dp

    with pytest.raises(ValueError, match="ert_chunks 4 needs render_view"):
        render_view_dp(torch.as_tensor(_sphere()), _cam(0),
                       DataMesh(None, 0, 2),
                       RenderConfig(early_stop_eps=1e-4, ert_chunks=4),
                       device="cpu")


def test_zsharded_render_ignores_slab_chunks(tmp_path):
    """The z folds sweep with eps 0, so ``ert_chunks`` has nothing to gate:
    on a one-rank ('data', 'z') mesh the frame is that of ert_chunks 1."""
    import torch.distributed as dist

    from tpuvr_torch.dist.init import grid_mesh
    from tpuvr_torch.dist.sharded_grid import render_view_zsharded

    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        mesh = grid_mesh(1, 1)
        grid = torch.as_tensor(_sphere())
        out = [render_view_zsharded(grid, _cam(1), mesh, RenderConfig(
            early_stop_eps=1e-4, ert_chunks=k), device="cpu")
            for k in (1, 4)]
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(x, y) for x, y in zip(*out))


def test_evaluate_psnr_honours_slab_chunks():
    from tpuvr_torch.train.fit import evaluate_psnr, render_views_grouped

    cams = [_cam(0), _cam(1)]
    grid = torch.as_tensor(_fog())
    kw = dict(early_stop_eps=EPS_OPAQUE, sigma_scale=8.0)
    whole = render_views_grouped(grid, cams, RenderConfig(**kw),
                                 device="cpu")
    chunked = render_views_grouped(grid, cams, RenderConfig(ert_chunks=4,
                                                            **kw),
                                   device="cpu")
    assert float((chunked - whole).abs().max()) < 5 * EPS_OPAQUE
    one, _ = trender.render_view(grid, cams[0], RenderConfig(ert_chunks=4,
                                                             **kw),
                                 device="cpu")
    np.testing.assert_allclose(chunked[0].numpy(), one.numpy(), rtol=0,
                               atol=1e-6)
    targets = torch.full_like(whole, 0.25)
    p4 = evaluate_psnr(grid, cams, targets, RenderConfig(ert_chunks=4, **kw),
                       device="cpu")
    p1 = evaluate_psnr(grid, cams, targets, RenderConfig(**kw),
                       device="cpu")
    assert np.isfinite(p4) and abs(p4 - p1) < 1e-2
