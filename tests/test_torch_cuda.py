"""tpuvr_torch's CUDA kernels against their plain PyTorch versions, on
the card, at small sizes. Every test needs an NVIDIA card (sm_90a for the
built kernels) and skips without one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: 1e-5 absolute at early_stop_eps = 0 (f32 roundoff); with
eps > 0 the kernel stops each ray at its own T < eps and the plain
version at the global maximum, so they differ by at most eps * max|c|.
Gradients: 1e-5 of max|grad| at 'highest' and 'high' (f32 sums in another
order); at 'default' 4e-3 of max|grad|, one bf16 rounding (2^-8) of a
row-stage partial that the two sum orders may round to neighbouring bf16
values. With eps > 0 the backward kernel is held against autograd of a
per-ray-terminating plain forward, the function it differentiates.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, per_ray_sweep_fwd
from tpuvr_torch import configs
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.kernels import lighting as klight
from tpuvr_torch.kernels import sweep as ksweep
from tpuvr_torch.kernels import sweep_bwd as kbwd
from tpuvr_torch.kernels.sweep_torch import (
    sweep_bwd_torch,
    sweep_bwd_views_torch,
    sweep_fwd_torch,
    sweep_fwd_views_torch,
)
from tpuvr_torch.ops import render, vjp
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.train import fit

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sweep_args(card, name, n, res):
    cfg = configs.CONFIGS[name]
    cam = configs.camera(cfg, n, res)
    prep = render.prepare_grid(smoke_sphere(n, device=card),
                               axes=(dominant_axis(cam),), device=card)
    plan, _, args = render.sweep_inputs(prep, cam, cfg["render"], card)
    return plan, args


@pytest.mark.parametrize("name", ["c1", "c2", "headline"])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_sweep_kernel_matches_plain(card, name, precision, eps):
    plan, args = _sweep_args(card, name, 24, 40)
    kw = dict(reverse=plan.reverse, early_stop_eps=eps, precision=precision,
              sigma_scale=1.7)
    before = ksweep.launches.copy()
    k = ksweep.sweep_fwd(*args, **kw)
    p = sweep_fwd_torch(*args, **kw)
    assert ksweep.launches - before == {1: 1}
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 + eps)


@pytest.mark.parametrize("d", [(0.37, -0.81), (-1.0, 0.25), (0.0, 0.0)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tau_kernel_matches_plain(card, d, precision):
    sig = smoke_sphere(20, device=card)[..., 0].contiguous()
    kw = dict(d_y=d[0], d_x=d[1], dt=1.3, precision=precision)
    before = klight.launches.copy()
    k = klight.tau_sweep(sig, **kw)
    p = klight.tau_sweep_torch(sig, **kw)
    assert klight.launches - before == {16: 1}
    assert bool((k[-1] == 0).all())
    torch.testing.assert_close(k, p, rtol=0,
                               atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("name", ["c1", "c2", "c3"])
def test_render_view_card_matches_cpu(card, name):
    cfg = configs.CONFIGS[name]
    cam = configs.camera(cfg, 24, 40)
    lighting = cfg["lighting"]
    if lighting is not None:
        lighting = type(lighting)(mode=lighting.mode, n_samples=4)
    g = smoke_sphere(24, device="cpu")
    ref = render.render_view(g, cam, cfg["render"], lighting=lighting,
                             device="cpu")
    out = render.render_view(g.to(card), cam, cfg["render"],
                             lighting=lighting)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 + cfg["render"].early_stop_eps)


@pytest.mark.parametrize("name", ["c1", "c2"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_sweep_kernel_softplus_matches_plain(card, name, precision):
    plan, (grid_sc, *rest) = _sweep_args(card, name, 24, 40)
    raw = grid_sc.clone()
    raw[:, 0] = torch.randn_like(raw[:, 0]) * 2.0 - 1.0
    kw = dict(reverse=plan.reverse, precision=precision, softplus=True)
    k = ksweep.sweep_fwd(raw, *rest, **kw)
    p = sweep_fwd_torch(raw, *rest, **kw)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _cotangents(card, args, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    n_v, n_u = args[3].shape
    return (torch.randn((3, n_v, n_u), generator=gen, device=card),
            torch.randn((n_v, n_u), generator=gen, device=card))


@pytest.mark.parametrize("name", ["c1", "c2", "headline"])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_bwd_kernel_matches_plain(card, name, precision, softplus):
    plan, args = _sweep_args(card, name, 24, 40)
    kw = dict(reverse=plan.reverse, precision=precision, sigma_scale=1.3,
              softplus=softplus)
    rgb, t = sweep_fwd_torch(*args, **kw)
    d_rgb, d_t = _cotangents(card, args, 3)
    before = kbwd.launches.copy()
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    p = sweep_bwd_torch(*args, rgb, t, d_rgb, d_t, **kw)
    assert kbwd.launches - before == {1: 1}
    scale = float(p.abs().max())
    assert scale > 0
    torch.testing.assert_close(k, p, rtol=0, atol=GRAD_TOL[precision] * scale)


@pytest.mark.parametrize("reverse", [False, True])
def test_sweep_bwd_kernel_carry_matches_one_call(card, reverse):
    _, args = _sweep_args(card, "c2", 24, 40)
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest", softplus=False)
    rgb, t = ksweep.sweep_fwd(*args, **{k: v for k, v in kw.items()})
    d_rgb, d_t = _cotangents(card, args, 4)
    one = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    two = vjp._chunked_bwd(kbwd.sweep_bwd, 2, *args, rgb, t, d_rgb, d_t, kw)
    torch.testing.assert_close(two, one, rtol=0,
                               atol=1e-5 * float(one.abs().max()))


@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_bwd_kernel_ert_matches_per_ray_autograd(card, softplus):
    """eps > 0 on a scene whose rays terminate: the kernels against
    autograd of the per-ray-terminating plain forward."""
    _, (grid_sc, *rest) = _sweep_args(card, "c1", 24, 40)
    grid_sc = grid_sc.clone()
    grid_sc[:, 0] += 0.6
    eps = 1e-2
    kw = dict(reverse=False, sigma_scale=1.0, early_stop_eps=eps,
              precision="highest", softplus=softplus)
    rgb, t = ksweep.sweep_fwd(grid_sc, *rest, **kw)
    assert int((t < eps).sum()) > 0
    g = grid_sc.clone().requires_grad_(True)
    ref_rgb, ref_t = per_ray_sweep_fwd(g, *rest, **kw)
    torch.testing.assert_close(rgb, ref_rgb.detach(), rtol=0, atol=1e-5)
    d_rgb, d_t = _cotangents(card, (grid_sc, *rest), 5)
    ((ref_rgb * d_rgb).sum() + (ref_t * d_t).sum()).backward()
    k = kbwd.sweep_bwd(grid_sc, *rest, rgb, t, d_rgb, d_t, **kw)
    torch.testing.assert_close(k, g.grad, rtol=0,
                               atol=1e-5 * float(g.grad.abs().max()))


@pytest.mark.parametrize("d", [(0.37, -0.81), (-1.0, 0.25), (0.0, 0.0)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tau_adj_kernel_matches_plain(card, d, precision):
    g = torch.randn((20, 20, 20), device=card)
    kw = dict(d_y=d[0], d_x=d[1], dt=1.3, precision=precision)
    before = klight.adj_launches.copy()
    k = klight.tau_sweep_adj(g, **kw)
    p = klight.tau_sweep_adj_torch(g, **kw)
    assert klight.adj_launches - before == {16: 1}
    assert bool((k[0] == 0).all())
    torch.testing.assert_close(k, p, rtol=0,
                               atol=1e-5 * float(p.abs().max()))


def _light_rows(card, planes=(20, 20, 20), n_dirs=16, seed=0):
    """Rows (field, flip, d_y, d_x, dt) of an n_dirs-direction bake over a
    seeded density of shape ``planes``: the c3 table's shifts, each
    direction on the field's own layout or its (X, Y)-transposed copy."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.ops import lighting as olight

    gen = torch.Generator(device=card).manual_seed(seed)
    sig = torch.rand(planes, generator=gen, device=card) - 0.2
    fields = (sig, sig.transpose(1, 2).contiguous())
    table = olight.direction_table(LightingConfig(mode="lightvolume",
                                                  n_samples=n_dirs))
    return [(fields[i % 2], flip, d_y, d_x, dt)
            for i, (_, flip, d_y, d_x, dt) in enumerate(table)]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("planes", [(20, 20, 20), (9, 37, 23)])
def test_batched_tau_kernels_match_plain(card, precision, planes):
    """K2 and K4 over a 16-direction table, one launch each: against their
    twins (1e-5 of the largest value), and each direction bit for bit the
    same kernel called for that direction alone."""
    rows = _light_rows(card, planes)
    grows = [(torch.randn(r[0].shape, device=card), *r[1:]) for r in rows]
    before = (klight.launches.copy(), klight.adj_launches.copy())
    taus = klight.tau_sweep_dirs(rows, precision)
    ds = klight.tau_sweep_adj_dirs(grows, precision)
    launched = (klight.launches - before[0], klight.adj_launches - before[1])
    assert [sum(c.values()) for c in launched] == [1, 1]
    assert 0 not in launched[0] and 0 not in launched[1]
    for kernel, twin, inputs, outs in (
            (klight.tau_sweep_dirs, klight.tau_sweep_dirs_torch, rows, taus),
            (klight.tau_sweep_adj_dirs, klight.tau_sweep_adj_dirs_torch,
             grows, ds)):
        ref = twin(inputs, precision)
        scale = max(float(r.abs().max()) for r in ref)
        for i, (o, r) in enumerate(zip(outs, ref)):
            torch.testing.assert_close(o, r, rtol=0, atol=1e-5 * scale)
            one = kernel([inputs[i]], precision)[0]
            assert torch.equal(one, o)


@pytest.mark.parametrize("adjoint", [False, True])
def test_tau_plane_too_wide_for_clusters_takes_the_plane_loop(card,
                                                               adjoint):
    """A plane wider than a block's threads: the plane loop (S-1 plane
    launches a direction, counted under 0), matching the twin; asking for
    a cluster size on it raises."""
    rows = [(torch.rand((5, 8, 1100), device=card), flip, 0.3, -0.7, 1.2)
            for flip in (False, True)]
    kernel, twin, counts = (
        (klight.tau_sweep_adj_dirs, klight.tau_sweep_adj_dirs_torch,
         klight.adj_launches) if adjoint else
        (klight.tau_sweep_dirs, klight.tau_sweep_dirs_torch, klight.launches))
    before = counts.copy()
    outs = kernel(rows)
    assert counts - before == {0: 2 * 4}
    for o, r in zip(outs, twin(rows)):
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        kernel(rows, _cluster=16)  # cudaErrorInvalidValue


def test_tau_cluster_route_at_512_planes(card):
    """c5's 512^2 planes (a few of them) take clusters of 16, bit for bit
    the plane loop and within 1e-5 of the twin."""
    rows = _light_rows(card, (6, 512, 512), n_dirs=4)
    rows = [(rows[0][0], *r[1:]) for r in rows]
    before = klight.launches.copy()
    taus = klight.tau_sweep_dirs(rows)
    assert klight.launches - before == {16: 1}
    loop = klight.tau_sweep_dirs(rows, _cluster=0)
    ref = klight.tau_sweep_dirs_torch(rows)
    for t, l, r in zip(taus, loop, ref):
        assert torch.equal(t, l)
        torch.testing.assert_close(t, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("planes,n_dirs,size", [
    ((4, 256, 256), 16, 4), ((4, 128, 128), 16, 4), ((4, 256, 256), 1, 16),
    ((4, 256, 256), 8, 8), ((4, 512, 512), 16, 16)])
def test_tau_route_chosen_by_the_c_entry(card, planes, n_dirs, size):
    """The cluster size the C entry chooses on the H100, each way: the
    largest whose clusters for every direction are resident at once (30 of
    4, 15 of 8, 7 of 16 at 1024 threads a CTA), else the smallest that
    holds the planes: c3's and the lit fit's 16 directions 4, one
    direction 16, eight 8, 16 directions of 512^2 planes 16."""
    rows = _light_rows(card, planes, n_dirs=n_dirs)
    for kernel, counts in ((klight.tau_sweep_dirs, klight.launches),
                           (klight.tau_sweep_adj_dirs, klight.adj_launches)):
        before = counts.copy()
        kernel(rows)
        assert counts - before == {size: 1}


def test_tau_more_directions_than_a_launch_takes(card):
    """A table longer than the kernel's parameter table (64 rows) takes
    one launch per 64 directions, each direction as in a short table."""
    rows = _light_rows(card, (6, 12, 12), n_dirs=70)
    before = klight.launches.copy()
    taus = klight.tau_sweep_dirs(rows)
    assert sum((klight.launches - before).values()) == 2
    for i in (0, 63, 64, 69):
        assert torch.equal(taus[i], klight.tau_sweep_dirs([rows[i]])[0])


def test_light_volume_is_one_launch_each_way(card):
    """The bake's 16 directions in one K2 launch, and its gradient in one
    K4 launch, matching the CPU route (1e-5)."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.ops import lighting as olight

    cfg = LightingConfig(mode="lightvolume", n_samples=16)
    sig_cpu = smoke_sphere(16, device="cpu")[..., 0] - 0.02
    wts = torch.rand(sig_cpu.shape)
    out = {}
    for dev in ("cpu", card):
        s = sig_cpu.to(dev, copy=True).requires_grad_(True)
        before = (klight.launches.copy(), klight.adj_launches.copy(),
                  klight.directions.copy())
        ell = olight.light_volume(s, cfg, device=dev)
        (ell * wts.to(dev)).sum().backward()
        counts = [sum((c - b).values()) for c, b in zip(
            (klight.launches, klight.adj_launches, klight.directions),
            before)]
        assert counts == ([0, 0, 0] if dev == "cpu" else [1, 1, 16])
        out[str(dev)] = (ell.detach().cpu(), s.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_gradients_flow_through_the_kernels(card):
    """A CUDA grid's gradient goes through the backward kernels, with no
    guard and no fallback, and matches the same gradient on the CPU."""
    g_cpu = smoke_sphere(12, device="cpu")
    cam = configs.orbit_persp(12, 16)
    lit = type(configs.CONFIGS["c3"]["lighting"])(
        mode="lightvolume", n_samples=3, detach=False)
    grads = {}
    for dev in ("cpu", card):
        g = g_cpu.to(dev, copy=True).requires_grad_(True)
        before = (kbwd.launches.copy(), klight.adj_launches.copy(),
                  klight.adj_directions.copy())
        rgb, t = render.render_view(g, cam, RenderConfig(early_stop_eps=0.0),
                                    lighting=lit, device=dev)
        (rgb.square().sum() + t.sum()).backward()
        grads[str(dev)] = g.grad.cpu()
        launched = (dict(kbwd.launches - before[0]),
                    dict(klight.adj_launches - before[1]),
                    dict(klight.adj_directions - before[2]))
        # On the card: one adjoint launch for the three directions, in
        # clusters of 8 (12-row planes: strips of one row at 16).
        assert launched == (({}, {}, {}) if dev == "cpu"
                            else ({1: 1}, {8: 1}, {8: 3}))
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=0,
                               atol=1e-5 * float(grads["cpu"].abs().max()))


def test_wrappers_reject_bad_inputs(card):
    plan, (grid_sc, coeffs, en, dt) = _sweep_args(card, "c1", 8, 8)
    with pytest.raises(TypeError, match="float32"):
        ksweep.sweep_fwd(grid_sc.double(), coeffs, en, dt)
    with pytest.raises(ValueError, match="contiguous"):
        ksweep.sweep_fwd(grid_sc.transpose(2, 3), coeffs, en, dt)
    with pytest.raises(ValueError, match="shape"):
        ksweep.sweep_fwd(grid_sc, coeffs, en[:-1], dt)
    with pytest.raises(ValueError, match="precision"):
        ksweep.sweep_fwd(grid_sc, coeffs, en, dt, precision="low")
    with pytest.raises(ValueError, match="empty"):
        ksweep.sweep_fwd(grid_sc, coeffs, en, dt[:0])
    with pytest.raises(ValueError, match="contiguous"):
        klight.tau_sweep(grid_sc[:, 0], d_y=0.0, d_x=0.0, dt=1.0)


def _views_args(card, group, views=4, n=24, res=20):
    """A c4-like view batch on the card: ``views`` views of one orbit
    group (its own cameras at a reduced size), the grid in that group's
    sweep layout, per-(view, slice) enables with one extra pair disabled,
    and the views' dt planes stacked along V."""
    cams = configs.cameras(configs.CONFIGS["c4"], n=n, res=res, n_views=16)
    groups = fit.group_views(cams, (n, n, n, 4))
    key = sorted(groups)[group]
    _, stacked, _, _ = groups[key]
    grid = smoke_sphere(n, device=card) + torch.tensor(
        [0.3, 0.0, 0.0, 0.0], device=card)
    grid_sc = render.grid_to_sweep_layout(grid, key[0]).contiguous()
    c = stacked["coeffs"][:views].to(card)
    en = (render.slice_enables(grid_sc, key[1], True)[None]
          * stacked["valid"][:views].to(card)).contiguous()
    en[1, en.shape[1] // 2] = 0.0
    dt = stacked["dt"][:views].to(card).reshape(-1, res).contiguous()
    return key[1], (grid_sc, tuple(c[:, i].contiguous() for i in range(4)),
                    en, dt)


def _raw(args):
    raw = args[0].clone()
    raw[:, 0] = torch.randn_like(raw[:, 0]) * 2.0 - 1.0
    return (raw, *args[1:])


def _per_view(args, views, w):
    grid_sc, coeffs, en, dt = args
    v_pv = dt.shape[0] // views
    return (grid_sc, tuple(c[w] for c in coeffs), en[w],
            dt[w * v_pv:(w + 1) * v_pv])


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("softplus", [False, True])
@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_sweep_views_kernel_matches_plain_and_k1(card, group, precision,
                                                 softplus, eps):
    """The forward kernel over a batch of 4 views against its plain
    version (eps * max|c| apart at eps > 0), and bit for bit against the
    kernel run view by view."""
    reverse, args = _views_args(card, group)
    if softplus:
        args = _raw(args)
    kw = dict(reverse=reverse, precision=precision, sigma_scale=1.3,
              early_stop_eps=eps, softplus=softplus)
    before = ksweep.launches.copy()
    k = ksweep.sweep_fwd(*args, views=4, **kw)
    assert ksweep.launches - before == {4: 1}
    p = sweep_fwd_views_torch(*args, views=4, **kw)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 + eps)
    loop = [ksweep.sweep_fwd(*_per_view(args, 4, w), **kw) for w in range(4)]
    assert torch.equal(k[0], torch.cat([r for r, _ in loop], dim=1))
    assert torch.equal(k[1], torch.cat([t for _, t in loop], dim=0))


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_bwd_views_kernel_matches_plain_and_k3(card, group, precision,
                                                     softplus):
    """The backward kernel over a batch of 4 views against its plain
    version (GRAD_TOL of max|grad|) and against the kernel's per-view
    gradients summed in view order (1e-6 of max|grad|)."""
    reverse, args = _views_args(card, group)
    if softplus:
        args = _raw(args)
    kw = dict(reverse=reverse, precision=precision, sigma_scale=1.3,
              softplus=softplus)
    rgb, t = ksweep.sweep_fwd(*args, views=4, **kw)
    d_rgb, d_t = _cotangents(card, args, 6)
    before = kbwd.launches.copy()
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, views=4, **kw)
    assert kbwd.launches - before == {4: 1}
    p = sweep_bwd_views_torch(*args, rgb, t, d_rgb, d_t, views=4, **kw)
    scale = float(p.abs().max())
    assert scale > 0
    torch.testing.assert_close(k, p, rtol=0, atol=GRAD_TOL[precision] * scale)
    v_pv = t.shape[0] // 4
    total = None
    for w in range(4):
        sl = slice(w * v_pv, (w + 1) * v_pv)
        g = kbwd.sweep_bwd(*_per_view(args, 4, w), rgb[:, sl], t[sl],
                           d_rgb[:, sl], d_t[sl], **kw)
        total = g if total is None else total + g
    torch.testing.assert_close(k, total, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_bwd_views_kernel_carry_matches_one_call(card, reverse,
                                                       softplus):
    _, args = _views_args(card, 0)
    if softplus:
        args = _raw(args)
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest", softplus=softplus, views=4)
    rgb, t = ksweep.sweep_fwd(*args, **kw)
    d_rgb, d_t = _cotangents(card, args, 7)
    one = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    two = vjp._chunked_bwd(kbwd.sweep_bwd, 2, *args, rgb, t, d_rgb, d_t, kw)
    torch.testing.assert_close(two, one, rtol=0,
                               atol=1e-5 * float(one.abs().max()))


@pytest.mark.parametrize("group", [0, 1])
def test_sweep_views_kernels_row_tiles_match_whole_batch(card, group):
    """Two row tiles of a 4-view batch (a rank's share of each view),
    swept with ``row0``: K5 bit for bit the whole batch's rows, and the
    tiles' K6 gradients summed within 1e-5 of max|grad| of the whole
    batch's (each tile's rows are summed apart)."""
    reverse, args = _views_args(card, group)
    grid_sc, coeffs, en, dt = args
    views, n_tiles = 4, 2
    v_pv = dt.shape[0] // views
    v_l = v_pv // n_tiles
    kw = dict(reverse=reverse, precision="highest", sigma_scale=1.3,
              views=views)
    rgb, t = ksweep.sweep_fwd(*args, **kw)
    d_rgb, d_t = _cotangents(card, args, 9)
    whole = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    total = torch.zeros_like(whole)
    for r in range(n_tiles):
        def rows(x, r=r):
            return x.unflatten(-2, (views, v_pv))[
                ..., r * v_l:(r + 1) * v_l, :].flatten(-3, -2).contiguous()

        tile = (grid_sc, coeffs, en, rows(dt))
        k = ksweep.sweep_fwd(*tile, row0=r * v_l, **kw)
        assert torch.equal(k[0], rows(rgb)) and torch.equal(k[1], rows(t))
        total += kbwd.sweep_bwd(*tile, *k, rows(d_rgb), rows(d_t),
                                row0=r * v_l, **kw)
    torch.testing.assert_close(total, whole, rtol=0,
                               atol=1e-5 * float(whole.abs().max()))


def test_sweep_bwd_ring_matches_k6_and_one_all_reduce(card):
    """The ring backward (B11's port) on a gloo group of 2 ranks sharing
    the card: K6 per slab, each slab all-reduced as it comes out, against
    K6 in one call then one all-reduce, 1e-5 of max|grad| (the slabs thread
    the carry as one call does, and two ranks' sum is the same in either
    order); every rank gets the same gradient."""
    from tpuvr_torch.dist import launch, workers

    reverse, args = _views_args(card, 1)
    grid_sc, coeffs, en, dt = args
    case = dict(grid_sc=grid_sc.cpu().numpy(),
                coeffs=tuple(c.cpu().numpy() for c in coeffs),
                enables=en.cpu().numpy(), dt=dt.cpu().numpy(), views=4,
                reverse=reverse, ring_chunks=2, seed=8)
    out = launch.spawn(workers.run_suite, 2, "gloo", "cuda",
                       ([("ring", workers.ring_case, case, {})], "cuda"),
                       timeout_s=300)
    for rank in range(2):
        got, ref, counts = out[rank]["ring"]
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
        assert counts == {"k6": 2, "ring": 1, "all_reduce": 2}
    np.testing.assert_array_equal(out[1]["ring"][0], out[0]["ring"][0])


def test_sweep_bwd_ring_with_ert_and_softplus_matches_k6(card):
    """The ring backward at early_stop_eps 1e-2 (on a denser grid, where
    rays stop), with softplus, and with both, on 2 gloo ranks sharing the
    card: against K6 in one call then one all-reduce, 1e-5 of max|grad|.
    K6 stops each ray on its own, and the slabs thread each ray's (T, q)
    carry, so early termination changes nothing between the two."""
    from tpuvr_torch.dist import launch, workers

    reverse, args = _views_args(card, 1)
    grid_sc, coeffs, en, dt = args
    grid_sc = grid_sc.clone()
    grid_sc[:, 0] += 0.6
    base = dict(grid_sc=grid_sc.cpu().numpy(),
                coeffs=tuple(c.cpu().numpy() for c in coeffs),
                enables=en.cpu().numpy(), dt=dt.cpu().numpy(), views=4,
                reverse=reverse, ring_chunks=2, seed=8)
    kws = {"ert": dict(eps=1e-2), "softplus": dict(softplus=True),
           "ert_softplus": dict(eps=1e-2, softplus=True)}
    out = launch.spawn(workers.run_suite, 2, "gloo", "cuda", ([
        (tag, workers.ring_case, dict(base, **kw), {})
        for tag, kw in kws.items()], "cuda"), timeout_s=300)
    rgb, t = ksweep.sweep_fwd(grid_sc, coeffs, en, dt, reverse=reverse,
                              views=4)
    assert int((t < 1e-2).sum()) > 0
    for tag in kws:
        for rank in range(2):
            got, ref, counts = out[rank][tag]
            scale = float(np.abs(ref).max())
            assert scale > 0
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
            assert counts == {"k6": 2, "ring": 1, "all_reduce": 2}
        np.testing.assert_array_equal(out[1][tag][0], out[0][tag][0])


@pytest.mark.parametrize("detach", [True, False], ids=["detached", "shadows"])
def test_lit_mesh_step_on_two_gloo_ranks_matches_one_card(card, detach):
    """c5's lit step (raw density from a perturbed fog, one view, the
    light baked by K2 on every rank; with ``detach=False`` the shadows'
    gradient through K4 joins the grid gradient before its all-reduce) on 2
    gloo ranks sharing the card, at 32^3 and 32^2, against the one-card
    step from the same state: the loss within 1e-6 relative and the
    gradient within 1e-5 of max|grad| (each rank sweeps its rows where the
    whole image's are, so only the order of the sums differs); the ranks
    bit-identical."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.dist import launch, workers
    from tpuvr_torch.io.synth import orbit_cameras

    n = 32
    shape = (n, n, n, 4)
    cams = orbit_cameras(4, n, res=n)
    lcfg = LightingConfig(mode="lightvolume", n_samples=16, detach=detach)
    run = RenderConfig(early_stop_eps=0.0)
    targets = fit.render_views_grouped(smoke_sphere(n, device=card), cams,
                                       run, lighting=lcfg)
    key, (idxs, stacked, _, _) = sorted(fit.group_views(
        cams, shape, n_shards=2).items())[0]
    params = (workers.fog_params(shape, "cpu").numpy()
              + np.random.default_rng(7).normal(0.0, 0.02, shape).astype(
                  np.float32))
    pick, r0s = np.zeros(1, np.int64), np.zeros(1, np.int32)
    case = dict(key=key, n_views=1, render_cfg=run, params=params,
                stacked={k: v.numpy() for k, v in stacked.items()},
                targets=targets[idxs].cpu().numpy(), pick=pick, r0s=r0s,
                density_softplus=False, lighting=lcfg)
    out = launch.spawn(workers.run_suite, 2, "gloo", "cuda",
                       ([("lit", workers.step_case, case, {})], "cuda"),
                       timeout_s=300)
    step = fit.make_train_step(key, 1, workers.CaptureGrad(), run, False,
                               "cuda", lighting=lcfg)
    _, ref, ref_loss = step(torch.as_tensor(params, device=card), None,
                            {k: v.to(card) for k, v in stacked.items()},
                            targets[idxs], pick, r0s)
    ref = ref.cpu().numpy()
    scale = float(np.abs(ref).max())
    assert scale > 0
    for rank in range(2):
        loss, grad = out[rank]["lit"]
        assert abs(loss - float(ref_loss)) <= 1e-6 * float(ref_loss)
        np.testing.assert_allclose(grad, ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(out[1]["lit"][1], out[0]["lit"][1])


def test_sweep_views_kernel_ert_matches_k1_loop(card):
    """eps > 0 where rays terminate: over a view batch the kernels stop
    each ray where they stop it view by view, so the batch equals the
    per-view loop."""
    reverse, (grid_sc, *rest) = _views_args(card, 0)
    grid_sc = grid_sc.clone()
    grid_sc[:, 0] += 0.6
    args = (grid_sc, *rest)
    kw = dict(reverse=reverse, sigma_scale=1.0, early_stop_eps=1e-2,
              precision="highest")
    rgb, t = ksweep.sweep_fwd(*args, views=4, **kw)
    assert int((t < 1e-2).sum()) > 0
    d_rgb, d_t = _cotangents(card, args, 8)
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, views=4, **kw)
    v_pv = t.shape[0] // 4
    total = None
    for w in range(4):
        sl = slice(w * v_pv, (w + 1) * v_pv)
        a = _per_view(args, 4, w)
        r1, t1 = ksweep.sweep_fwd(*a, **kw)
        assert torch.equal(r1, rgb[:, sl]) and torch.equal(t1, t[sl])
        g = kbwd.sweep_bwd(*a, r1, t1, d_rgb[:, sl], d_t[sl], **kw)
        total = g if total is None else total + g
    assert torch.equal(k, total)


def test_views_wrappers_reject_beyond_capacity(card):
    _, (grid_sc, coeffs, en, dt) = _views_args(card, 0)
    with pytest.raises(ValueError, match="equal views"):
        ksweep.sweep_fwd(grid_sc, coeffs, en, dt[:-1], views=4)
    with pytest.raises(ValueError, match="shape"):
        ksweep.sweep_fwd(grid_sc, tuple(c[:3] for c in coeffs), en[:3], dt,
                         views=4)
    one = torch.zeros((1, 1), device=card)
    with pytest.raises(ValueError, match="views"):
        ksweep.sweep_fwd(torch.zeros((1, 4, 1, 1), device=card),
                         (one.expand(65536, 1),) * 4, one.expand(65536, 1),
                         torch.zeros((65536, 1), device=card), views=65536)
    s = 2049  # (5, S) scalars per block past the kernel's shared memory
    big = torch.zeros((s, 4, 1, 1), device=card)
    row = torch.zeros((2, s), device=card)
    for fn, extra in ((ksweep.sweep_fwd, ()),
                      (kbwd.sweep_bwd, (torch.zeros((3, 2, 1), device=card),
                                        torch.zeros((2, 1), device=card)) * 2)):
        with pytest.raises(ValueError, match="slices"):
            fn(big, (row,) * 4, row, torch.ones((2, 1), device=card), *extra,
               views=2)


def _row_positions(n_v, n_u, res, seed=3):
    """Lattice rows tracking pixel rows, with jitter (as the JAX row-warp
    tests make them), clipped into the lattice."""
    rng = np.random.default_rng(seed)
    y = (np.linspace(0, n_v - 1.01, res)[:, None]
         + rng.uniform(-1, 1, (res, res))).clip(0, n_v - 1)
    x = (np.linspace(0, n_u - 1.01, res)[None, :]
         + rng.uniform(-1, 1, (res, res))).clip(0, n_u - 1)
    return y.astype(np.float32), x.astype(np.float32)


@pytest.fixture(scope="module")
def row_cases(card):
    """The c4 row plans (the first view of the first group of each sweep
    axis: 64x16 tiles with f_v 64, 32x32 tiles with f_v 88) and a
    full-width row block at 512^2 (8 rows, P = 4096 pixels a tile), as
    (f_v, y_t, x_t, vb, V, U) on the card."""
    import os

    from chip_smoke import c4_row_groups
    from tpuvr_torch.ops.warp import plan_row_warp

    cases = {}
    for key, (_, stacked, _, plan) in sorted(c4_row_groups().items()):
        name = f"c4_axis{key[0]}"
        if name not in cases:
            cases[name] = (plan.f_v, *(stacked[k][0].to(card) for k in (
                "rwy", "rwx", "rwvb")), *stacked["dt"].shape[1:])
    os.environ["TPUVR_WARP_ROWS"] = "8x0"
    try:
        plan, vb, y, x = plan_row_warp([_row_positions(256, 256, 512)],
                                       256, 256)
    finally:
        del os.environ["TPUVR_WARP_ROWS"]
    assert y.shape[-1] == 4096
    cases["rows_p4096"] = (plan.f_v, *(torch.as_tensor(a[0]).to(card)
                                       for a in (y, x, vb)), 256, 256)
    return cases


@pytest.mark.parametrize("case", ["c4_axis0", "c4_axis1", "rows_p4096"])
def test_warp_rows_kernels_match_plain(card, row_cases, case):
    """K7 against its plain version (1e-6 absolute on a lattice in [0, 1))
    and K8 against its plain version (1e-5 of max|grad|), bit for bit over
    two calls."""
    from tpuvr_torch.kernels import warp as kwarp
    from tpuvr_torch.kernels.warp_torch import (
        warp_rows_bwd_torch,
        warp_rows_fwd_torch,
    )

    f_v, y, x, vb, n_v, n_u = row_cases[case]
    gen = torch.Generator(device=card).manual_seed(4)
    inter = torch.rand((4, n_v, n_u), generator=gen, device=card)
    d_out = torch.randn((4, *y.shape), generator=gen, device=card)
    before = kwarp.launches.copy()
    k7 = kwarp.warp_rows_fwd(inter, y, x, vb, f_v=f_v)
    k8 = kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u, f_v=f_v)
    assert kwarp.launches - before == {"warp_rows_fwd": 1, "warp_rows_bwd": 1}
    torch.testing.assert_close(
        k7, warp_rows_fwd_torch(inter, y, x, vb, f_v=f_v), rtol=0, atol=1e-6)
    p8 = warp_rows_bwd_torch(d_out, y, x, vb, n_v, n_u, f_v=f_v)
    torch.testing.assert_close(k8, p8, rtol=0,
                               atol=1e-5 * float(p8.abs().max()))
    assert torch.equal(k8, kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u,
                                               f_v=f_v))


def test_warp_rows_wrappers_reject_bad_inputs(card, row_cases):
    from tpuvr_torch.kernels import warp as kwarp

    f_v, y, x, vb, n_v, n_u = row_cases["c4_axis1"]
    inter = torch.zeros((4, n_v, n_u), device=card)
    d_out = torch.zeros((4, *y.shape), device=card)
    with pytest.raises(ValueError, match="float32"):
        kwarp.warp_rows_fwd(inter.double(), y, x, vb, f_v=f_v)
    with pytest.raises(ValueError, match="float32"):
        kwarp.warp_rows_bwd(d_out, y.double(), x, vb, n_v, n_u, f_v=f_v)
    with pytest.raises(ValueError, match="int32"):
        kwarp.warp_rows_fwd(inter, y, x, vb.long(), f_v=f_v)
    with pytest.raises(ValueError, match="shape"):
        kwarp.warp_rows_fwd(inter, y, x[:, :-1].contiguous(), vb, f_v=f_v)
    with pytest.raises(ValueError, match="shape"):
        kwarp.warp_rows_bwd(d_out[:, :-1].contiguous(), y, x, vb, n_v, n_u,
                            f_v=f_v)
    with pytest.raises(ValueError, match="f_v"):
        kwarp.warp_rows_fwd(inter, y, x, vb, f_v=n_v + 8)
    with pytest.raises(ValueError, match="contiguous"):
        kwarp.warp_rows_fwd(inter.transpose(1, 2), y, x, vb, f_v=f_v)
    with pytest.raises(ValueError, match="is on"):
        kwarp.warp_rows_fwd(inter, y.cpu(), x, vb, f_v=f_v)
    with pytest.raises(ValueError, match="shared memory"):
        kwarp.warp_rows_fwd(torch.zeros((4, 512, 8), device=card), y, x, vb,
                            f_v=512)


def test_gradients_flow_through_the_row_warp(card, row_cases):
    """``row_warp_op('cuda')`` runs K7 forward and K8 backward, with no
    guard and no fallback, and its gradient matches the CPU twins'."""
    from tpuvr_torch.kernels import warp as kwarp
    from tpuvr_torch.ops.warp import row_warp_op

    f_v, y, x, vb, n_v, n_u = row_cases["c4_axis0"]
    gen = torch.Generator().manual_seed(5)
    base = torch.rand((4, n_v, n_u), generator=gen)
    grads = {}
    for dev, impl in (("cpu", "torch"), (card, "cuda")):
        g = base.to(dev, copy=True).requires_grad_(True)
        before = kwarp.launches.copy()
        out = row_warp_op(f_v, impl)(g, y.to(dev), x.to(dev), vb.to(dev))
        (out ** 2).sum().backward()
        grads[impl] = g.grad.cpu()
        launched = dict(kwarp.launches - before)
        assert launched == ({} if impl == "torch" else
                            {"warp_rows_fwd": 1, "warp_rows_bwd": 1})
    torch.testing.assert_close(grads["cuda"], grads["torch"], rtol=0,
                               atol=1e-5 * float(grads["torch"].abs().max()))


def _k8_edge_case(name):
    """(f_v, y_t, x_t, vb, V, U) of one of the transpose's edge cases, as
    numpy: lattice points (the last row and column included), every pixel
    of a tile in one cell (the fullest cell), P not a multiple of the
    kernel's 1024-pixel staging batch, a window as tall as the lattice,
    and tiles whose columns span exactly one 32-column slab boundary."""
    rng = np.random.default_rng(12)
    n_v, n_u, n_tiles, p, f_v = 40, 70, 5, 1100, 24
    vb = np.array([0, 8, 16, 13, 3])
    if name == "lattice_points":
        y = rng.integers(0, n_v, (n_tiles, p)).astype(np.float64)
        x = rng.integers(0, n_u, (n_tiles, p)).astype(np.float64)
        y[:, :5], x[:, :5] = n_v - 1, n_u - 1
        f_v, vb = n_v, np.zeros(n_tiles)
    elif name == "one_cell":
        y, x = np.full((2, 777), 17.25), np.full((2, 777), 33.5)
        vb = np.array([8, 8])
    elif name == "ragged_batch":
        y = np.clip(vb[:, None] + rng.uniform(0, 20, (n_tiles, p)), 0,
                    n_v - 1)
        x = np.clip(rng.uniform(0, 40, (n_tiles, 1))
                    + rng.uniform(0, 28, (n_tiles, p)), 0, n_u - 1)
    elif name == "window_is_lattice":
        n_v, n_u, f_v = 16, 64, 16
        y = rng.uniform(0, 15, (3, 200))
        x = rng.uniform(0, 63, (3, 200))
        vb = np.zeros(3)
    else:  # "slab_boundary"
        n_u = 96
        y = rng.uniform(5, 20, (3, 1030))
        x = rng.uniform(30.0, 33.99, (3, 1030))
        vb = np.zeros(3)
    return (f_v, y.astype(np.float32), x.astype(np.float32),
            vb.astype(np.int32), n_v, n_u)


@pytest.mark.parametrize("name", ["lattice_points", "one_cell",
                                  "ragged_batch", "window_is_lattice",
                                  "slab_boundary"])
def test_warp_rows_bwd_kernel_edge_cases(card, name):
    """K8 against its plain version (1e-5 of max|grad|: f32 sums of one
    cell's terms in another order) and bit for bit over two calls, and K7
    against its plain version (1e-6), on the transpose's edge cases."""
    from tpuvr_torch.kernels import warp as kwarp
    from tpuvr_torch.kernels.warp_torch import (
        warp_rows_bwd_torch,
        warp_rows_fwd_torch,
    )

    f_v, *arrays, n_v, n_u = _k8_edge_case(name)
    y, x, vb = (torch.as_tensor(a).to(card) for a in arrays)
    gen = torch.Generator(device=card).manual_seed(13)
    d_out = torch.randn((4, *y.shape), generator=gen, device=card)
    inter = torch.rand((4, n_v, n_u), generator=gen, device=card)
    k8 = kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u, f_v=f_v)
    p8 = warp_rows_bwd_torch(d_out, y, x, vb, n_v, n_u, f_v=f_v)
    scale = float(p8.abs().max())
    assert scale > 0
    torch.testing.assert_close(k8, p8, rtol=0, atol=1e-5 * scale)
    assert torch.equal(k8, kwarp.warp_rows_bwd(d_out, y, x, vb, n_v, n_u,
                                               f_v=f_v))
    torch.testing.assert_close(
        kwarp.warp_rows_fwd(inter, y, x, vb, f_v=f_v),
        warp_rows_fwd_torch(inter, y, x, vb, f_v=f_v), rtol=0, atol=1e-6)


def _single_view_args(card, n, res, name="c1"):
    """A front-ortho (c1) or orbit (c2) sweep of the smoke sphere at n^3
    from res^2 rays, with a little density everywhere so every slice
    carries gradient."""
    cfg = configs.CONFIGS[name]
    cam = configs.camera(cfg, n, res)
    prep = render.prepare_grid(
        smoke_sphere(n, device=card) + torch.tensor([0.2, 0.0, 0.0, 0.0],
                                                    device=card),
        axes=(dominant_axis(cam),), device=card)
    plan, _, args = render.sweep_inputs(prep, cam, RenderConfig(), card)
    return plan.reverse, args


@pytest.mark.parametrize("n,res,name", [
    (64, 256, "c1"),   # |a| ~ 0.35: windows streamed in pieces
    (16, 256, "c1"),   # |a| ~ 0.09: pieces, weights computed in place
    (16, 256, "c2"),   # the same under a reverse perspective sweep
    (64, 16, "c1"),    # |a| ~ 5.6: voxels no ray reaches
], ids=["c1_64_at_256", "grid16_at_256", "c2_grid16_at_256", "grid64_at_16"])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sweep_bwd_kernel_footprints_beyond_the_buffers(card, n, res, name,
                                                        precision):
    """The voxel stage where a tile's ray footprint outgrows its shared
    buffers (streamed in column pieces, windows read in place, weights
    computed where used) and where rays are sparser than voxels: K3
    against its plain version (GRAD_TOL of max|grad|) and bit for bit over
    two calls."""
    reverse, args = _single_view_args(card, n, res, name)
    kw = dict(reverse=reverse, precision=precision, sigma_scale=1.3)
    rgb, t = sweep_fwd_torch(*args, **kw)
    d_rgb, d_t = _cotangents(card, args, 10)
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    p = sweep_bwd_torch(*args, rgb, t, d_rgb, d_t, **kw)
    scale = float(p.abs().max())
    assert scale > 0
    torch.testing.assert_close(k, p, rtol=0, atol=GRAD_TOL[precision] * scale)
    assert torch.equal(k, kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw))


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("r", [0, 1, 3])
def test_sweep_bwd_views_row_tile_zero_where_unreached(card, group, r):
    """One rank's row tile (a quarter of each view's rows, swept with
    row0) of a 4-view batch: every voxel row that no view's tile rays
    reach (tent.cuh's rays_reaching, mirrored in kernels/sweep_bwd.py) is
    exactly 0.0; the tile's gradient matches its plain version; two calls
    are bit-identical."""
    reverse, (grid_sc, coeffs, en, dt) = _views_args(card, group)
    views = 4
    v_pv = dt.shape[0] // views
    v_l = v_pv // 4

    def rows(x):
        return x.unflatten(-2, (views, v_pv))[
            ..., r * v_l:(r + 1) * v_l, :].flatten(-3, -2).contiguous()

    tile = (grid_sc, coeffs, en, rows(dt))
    kw = dict(reverse=reverse, precision="highest", sigma_scale=1.3,
              views=views, row0=r * v_l)
    rgb, t = ksweep.sweep_fwd(*tile, **kw)
    d_rgb, d_t = _cotangents(card, tile, 11)
    k = kbwd.sweep_bwd(*tile, rgb, t, d_rgb, d_t, **kw)
    assert torch.equal(k, kbwd.sweep_bwd(*tile, rgb, t, d_rgb, d_t, **kw))
    p = sweep_bwd_views_torch(*tile, rgb, t, d_rgb, d_t, **kw)
    scale = float(p.abs().max())
    assert scale > 0
    torch.testing.assert_close(k, p, rtol=0, atol=1e-5 * scale)
    s, _, n_y, _ = grid_sc.shape
    ay, by = (c.cpu().numpy() for c in coeffs[:2])
    on = en.cpu().numpy()
    reached = np.zeros((s, n_y), dtype=bool)
    for step in range(s):
        at = s - 1 - step if reverse else step
        for w in range(views):
            if on[w, step] != 0.0:
                lo, hi = kbwd.rays_reaching(np.arange(n_y), ay[w, step],
                                            by[w, step], r * v_l + v_l)
                reached[at] |= np.maximum(lo, r * v_l) <= hi
    assert (~reached).any()
    kr = k.abs().amax(dim=(1, 3)).cpu().numpy()
    assert (kr[~reached] == 0.0).all()


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_sweep_bwd_views_kernel_is_k3_summed_bit_for_bit(card, precision,
                                                          eps):
    """Over a 4-view batch the backward kernel's gradient is the per-view
    gradients summed in view order, bit for bit, in every tier, at eps 0
    and where rays terminate; two calls are bit-identical."""
    reverse, (grid_sc, *rest) = _views_args(card, 1)
    grid_sc = grid_sc.clone()
    if eps:
        grid_sc[:, 0] += 0.6
    args = (grid_sc, *rest)
    kw = dict(reverse=reverse, sigma_scale=1.3, early_stop_eps=eps,
              precision=precision)
    rgb, t = ksweep.sweep_fwd(*args, views=4, **kw)
    assert eps == 0.0 or int((t < eps).sum()) > 0
    d_rgb, d_t = _cotangents(card, args, 12)
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, views=4, **kw)
    assert torch.equal(k, kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, views=4,
                                         **kw))
    v_pv = t.shape[0] // 4
    total = None
    for w in range(4):
        sl = slice(w * v_pv, (w + 1) * v_pv)
        g = kbwd.sweep_bwd(*_per_view(args, 4, w), rgb[:, sl], t[sl],
                           d_rgb[:, sl], d_t[sl], **kw)
        total = g if total is None else total + g
    assert torch.equal(k + 0.0, total + 0.0)


# The forward kernel's two regimes (csrc/sweep_fwd.cu): a tile whose slice
# window fits the staging box stages it by TMA and shares the row stage
# ("dense"); a wider one gathers ray by ray with the next slice's loads in
# flight ("sparse"). Each case is held against the plain version (1e-5, or
# eps * max|c| at eps > 0) and bit for bit over two calls; which regimes it
# takes is read from kernels.sweep.tile_windows, the kernel's numpy twin.


def _fwd_hold(args, views=1, **kw):
    k = ksweep.sweep_fwd(*args, views=views, **kw)
    again = ksweep.sweep_fwd(*args, views=views, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, again):
        assert torch.equal(a, b)
    p = (sweep_fwd_torch(*args, **kw) if views == 1
         else sweep_fwd_views_torch(*args, views=views, **kw))
    eps = kw.get("early_stop_eps", 0.0)
    tol = 1e-5 + eps * max(float(args[0][:, 1:].abs().max()), 1.0)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    return k


def _regimes(args, views=1, row0=0):
    grid_sc, coeffs, en, dt = args
    return ksweep.tile_windows(coeffs, en, grid_sc.shape[2],
                               grid_sc.shape[3], dt.shape[0] // views,
                               dt.shape[1], row0)


def _synthetic(card, a, n=40, v=24, u=72, s=None, shift=(0.37, -0.21),
               disabled=7, seed=5):
    """A random (S, 4, n, n) grid swept by rays whose slope per slice is
    ``a`` (voxels a ray; x at 0.9 a), centred on the grid, every
    ``disabled``-th slice off."""
    a = np.asarray(a, np.float64)
    s = a.shape[0] if s is None else s
    gen = torch.Generator().manual_seed(seed)
    grid = torch.rand((s, 4, n, n), generator=gen)
    coeffs = (a, n / 2 - a * v / 2 + shift[0], a * 0.9,
              n / 2 - a * 0.9 * u / 2 + shift[1])
    en = (np.arange(s) % disabled != disabled // 2).astype(np.float32)
    dt = 1.0 + torch.rand((v, u), generator=gen)
    return (grid.to(card),
            tuple(torch.tensor(c, dtype=torch.float32, device=card)
                  for c in coeffs),
            torch.tensor(en, device=card), dt.to(card))


@pytest.mark.parametrize("name", ["c1", "c2", "headline"])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_sweep_fwd_dense_regime_only(card, name, precision, eps):
    plan, args = _sweep_args(card, name, 32, 48)
    reg = _regimes(args)["regime"]
    assert (reg == ksweep.DENSE).any() and not (reg == ksweep.SPARSE).any()
    _fwd_hold(args, reverse=plan.reverse, precision=precision,
              early_stop_eps=eps, sigma_scale=1.7)


@pytest.mark.parametrize("n", [160, 18])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sweep_fwd_sparse_regime_only(card, n, precision):
    """Rays 1.6-2.2 voxels apart inside a 160-wide grid (windows wider
    than the box), and an 18-wide grid (no multiple of 4: no TMA rows)."""
    args = _synthetic(card, np.linspace(1.6, 2.2, 24), n=n, v=40, u=64)
    reg = _regimes(args)["regime"]
    assert (reg == ksweep.SPARSE).any() and not (reg == ksweep.DENSE).any()
    _fwd_hold(args, precision=precision)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sweep_fwd_view_crossing_the_box(card, precision, reverse):
    """One view whose slopes rise from 0.3 to 2.0 voxels a ray: its tiles
    take the dense regime, then the sparse one, then both."""
    args = _synthetic(card, np.linspace(0.3, 2.0, 40))
    reg = _regimes(args)["regime"][0]
    assert set(np.unique(reg[0])) - {ksweep.SKIP} == {ksweep.DENSE}
    assert ksweep.SPARSE in set(np.unique(reg[-1]))
    _fwd_hold(args, reverse=reverse, precision=precision)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_sweep_fwd_softplus_windows_overhang_every_edge(card, precision):
    """Raw densities of both signs; the image covers more than the grid on
    every side, so dense windows take border cells (which must stay 0, not
    softplus(0)) above, below, left and right of the grid."""
    args = _raw(_synthetic(card, np.full(16, 0.6), n=40, v=96, u=96,
                           disabled=100))
    tw = _regimes(args)
    dense = (tw["regime"][0] == ksweep.DENSE).any(0)  # (tiles_v, tiles_u)
    y_lo, y_hi = tw["y_lo"][0], tw["y_lo"][0] + tw["rows"][0] - 1
    x_lo, x_hi = tw["x_lo"][0], tw["x_lo"][0] + tw["cols"][0] - 1
    assert (dense.any(1) & (y_lo == -1).any(0)).any()
    assert (dense.any(1) & (y_hi == 40).any(0)).any()
    assert (dense.any(0) & (x_lo == -1).any(0)).any()
    assert (dense.any(0) & (x_hi == 40).any(0)).any()
    _fwd_hold(args, precision=precision, softplus=True)


@pytest.mark.parametrize("slope,n", [(0.5, 40), (1.8, 160)],
                         ids=["dense", "sparse"])
@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_fwd_blocks_stop_with_copies_issued(card, slope, n, softplus):
    """ERT at a large eps over a dense grid that holds every ray: whole
    blocks stop after a few slices (in the dense regime with copies of
    later slices in flight) and must still write their rays; the card must
    come back clean."""
    args = _synthetic(card, np.full(20, slope), n=n, v=40, u=64)
    args = (args[0] + torch.tensor([2.0, 0.0, 0.0, 0.0], device=card)[
        None, :, None, None], *args[1:])
    if softplus:
        args = _raw(args)
    _, t = _fwd_hold(args, early_stop_eps=0.3, softplus=softplus)
    torch.cuda.synchronize()
    assert bool((t < 0.3).all())
    _fwd_hold(args, softplus=softplus)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_sweep_fwd_row_tiles_and_views_match_k1(card, precision):
    """A batch of 3 views crossing the box (reverse) equals K1 view by
    view, and each quarter of its rows (row0) equals those rows of the
    whole batch."""
    views = 3
    parts = [_synthetic(card, np.linspace(0.3 + 0.2 * w, 2.0, 40), seed=w)
             for w in range(views)]
    grid = parts[0][0]
    coeffs = tuple(torch.stack([p[1][i] for p in parts]) for i in range(4))
    en = torch.stack([p[2] for p in parts])
    dt = torch.cat([p[3] for p in parts])
    args = (grid, coeffs, en, dt)
    kw = dict(reverse=True, precision=precision)
    rgb, t = _fwd_hold(args, views=views, **kw)
    v_pv = dt.shape[0] // views
    for w in range(views):
        one = (grid, tuple(c[w] for c in coeffs), en[w],
               dt[w * v_pv:(w + 1) * v_pv])
        r1, t1 = ksweep.sweep_fwd(*one, **kw)
        assert torch.equal(r1, rgb[:, w * v_pv:(w + 1) * v_pv])
        assert torch.equal(t1, t[w * v_pv:(w + 1) * v_pv])
    q = v_pv // 4
    for r in range(4):
        rows = dt.unflatten(0, (views, v_pv))[:, r * q:(r + 1) * q]
        tile = (grid, coeffs, en, rows.flatten(0, 1).contiguous())
        rt, tt = _fwd_hold(tile, views=views, row0=r * q, **kw)
        whole = (rgb.unflatten(1, (views, v_pv))[:, :, r * q:(r + 1) * q],
                 t.unflatten(0, (views, v_pv))[:, r * q:(r + 1) * q])
        assert torch.equal(rt, whole[0].flatten(1, 2))
        assert torch.equal(tt, whole[1].flatten(0, 1))


@pytest.mark.parametrize("b", [(7.3, -0.6), (-0.5, 39.5), (50.0, 3.0)])
def test_sweep_fwd_degenerate_coefficients(card, b):
    """a = 0: every ray of a slice on one line (inside, on the border, or
    outside the grid)."""
    s, n = 12, 40
    gen = torch.Generator().manual_seed(1)
    grid = torch.rand((s, 4, n, n), generator=gen).to(card)
    zeros = torch.zeros(s, device=card)
    coeffs = (zeros, torch.full((s,), b[0], device=card), zeros,
              torch.full((s,), b[1], device=card))
    dt = (1.0 + torch.rand((24, 72), generator=gen)).to(card)
    _fwd_hold((grid, coeffs, torch.ones(s, device=card), dt))


def test_warp_to_pixels_owned_on_the_card_matches_cpu(card):
    """The z trainer's owned-row warp on CUDA tensors: the CPU's masks, and
    its images within 1e-6, for each of 4 row blocks of a top-down
    perspective view."""
    from tpuvr_torch.io.synth import orbit_cameras
    from tpuvr_torch.ops.geometry import view_geometry, warp_to_pixels_owned

    cam = orbit_cameras(8, 24, res=40, elevation_deg=75.0)[0]
    _, _, geom, _ = view_geometry(cam, (24, 24, 24, 4))
    n_v, n_u = geom["dt"].shape
    inter = torch.rand((n_v + 1, n_u, 4),
                       generator=torch.Generator().manual_seed(2))
    rows = n_v // 4
    for b in range(4):
        block = inter[b * rows:(b + 1) * rows + 1]
        args = (geom["lattice"], geom["uv"], b * rows, rows, n_v)
        img, mask = warp_to_pixels_owned(block, *args)
        k_img, k_mask = warp_to_pixels_owned(
            block.to(card), *(a.to(card) for a in args[:2]), *args[2:])
        assert torch.equal(k_mask.cpu(), mask) and bool(mask.any())
        torch.testing.assert_close(k_img.cpu(), img, rtol=0, atol=1e-6)


def test_retile_fold_on_one_rank_matches_the_render(card):
    """A (1, 1) z mesh on one gloo rank on the card: the gathered, ring and
    retiled folds of a single slab are the single-card render (1e-5)."""
    from tpuvr_torch.dist import launch, workers
    from tpuvr_torch.io.synth import orbit_cameras

    cam = orbit_cameras(8, 24, res=40, elevation_deg=75.0)[0]
    grid = smoke_sphere(24, device="cpu")
    cfg = RenderConfig(early_stop_eps=0.0)
    folds = ("all_gather", "ring", "retile")
    out = launch.spawn(workers.run_suite, 1, "gloo", "cuda", ([
        (fold, workers.zrender_case, dict(layout=(1, 1), grid=grid.numpy(),
                                          cam=cam, cfg=cfg, fold=fold), {})
        for fold in folds], "cuda"), timeout_s=300)
    rgb, t = render.render_view(grid.to(card), cam, cfg)
    for fold in folds:
        got_rgb, got_t = out[0][fold]
        np.testing.assert_allclose(got_rgb, rgb.cpu().numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got_t, t.cpu().numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", [(1, 2), (2, 1)], ids=str)
def test_z_mesh_exchanges_over_gloo_on_the_card(card, layout):
    """The z mesh's exchanges on CUDA tensors over gloo, 2 ranks sharing the
    card: the halo ``exchange`` and the ``all_to_all`` (both one
    ``all_to_all_single``, the route gloo runs for CUDA tensors where it
    refuses point-to-point sends and list ``all_to_all``) and
    ``all_gather``, each counted once."""
    from tpuvr_torch.dist import launch, workers

    out = launch.spawn(workers.run_suite, 2, "gloo", "cuda", ([
        ("x", workers.zcollectives_case, dict(layout=layout), {})],
        "cuda"), timeout_s=300)
    n_data, n_z = layout
    x = np.arange(6.0).reshape(2, 3)
    for r in range(2):
        halo, a2a, gz, gd, counts = out[r]["x"]
        np.testing.assert_array_equal(halo, x + 10 if r == 0 else 0 * x)
        i, d = divmod(r, n_z)
        z_ranks = [i * n_z + k for k in range(n_z)]
        np.testing.assert_array_equal(
            a2a, [[2.0 * d + 100 * s, 2.0 * d + 1 + 100 * s]
                  for s in z_ranks])
        np.testing.assert_array_equal(gz, [x + 10 * s for s in z_ranks])
        np.testing.assert_array_equal(
            gd, [x + 10 * (k * n_z + d) for k in range(n_data)])
        assert counts == {"exchange": 1, "all_to_all": 1, "all_gather": 2}


@pytest.mark.parametrize("i", [0, 1], ids=["front_ortho", "orbit_persp"])
def test_fixed_dt_render_on_the_card_matches_the_cpu(card, i):
    """``render_view(mode="fixed_dt")`` runs the plain marcher on the
    card's tensors: within 1e-5 of max|rgb| of the CPU's."""
    name = ("c1", "c2")[i]
    cam = configs.camera(configs.CONFIGS[name], 16, 24)
    grid = smoke_sphere(16, device="cpu")
    cfg = RenderConfig(mode="fixed_dt", early_stop_eps=0.0)
    ref = render.render_view(grid, cam, cfg, device="cpu")
    out = render.render_view(grid.to(card), cam, cfg)
    scale = float(ref[0].abs().max())
    for got, want in zip(out, ref):
        assert got.is_cuda
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def test_pixel_grad_error_of_the_kernels(card):
    """K1/K3's grid gradient on the 24^3 @ 32^2 fixture against the f64
    oracle: within twice the plain version's error plus 1e-7."""
    from tpuvr_torch.bench import judged

    fixture = judged.grad_fixture()
    before = (ksweep.launches[1], kbwd.launches[1])
    err = judged.grad_accuracy(fixture, card)
    assert (ksweep.launches[1], kbwd.launches[1]) == (before[0] + 1,
                                                      before[1] + 1)
    assert 0.0 < err <= 2.0 * judged.grad_accuracy(fixture, "cpu") + 1e-7
    own = (judged.pixel_grad(fixture, card)
           - judged.pixel_grad(fixture, "cpu")).abs().max()
    assert float(own) <= 1e-5 * float(fixture[1].abs().max())


def _ert_frame(card, precision, chunks):
    """A 24^3 @ 40^2 c2 frame (reverse sweep) at eps 1e-4 in ``chunks``
    slabs, and its grid gradient: (render, fwd_bwd) closures."""
    cam = configs.camera(configs.CONFIGS["c2"], 24, 40)
    axis = dominant_axis(cam)
    prep = render.prepare_grid(smoke_sphere(24, device=card), axes=(axis,),
                               device=card)
    cfg = RenderConfig(early_stop_eps=1e-4, precision=precision,
                       ert_chunks=chunks)
    gsc, smax = prep[axis]

    def fwd_bwd():
        g = gsc.detach().requires_grad_(True)
        rgb, t = render.render_prepared({axis: (g, smax)}, cam, cfg)
        (grad,) = torch.autograd.grad(torch.mean((rgb - 0.25) ** 2), g)
        return rgb.detach(), t.detach(), grad

    return (lambda: render.render_prepared(prep, cam, cfg)), fwd_bwd


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_ert_chunked_frame_matches_plain(card, precision, monkeypatch):
    """A frame and its gradient in 4 slabs: K1 once and K3 once a slab,
    against the same frame through the plain versions (eps * max|c| for
    the image, GRAD_TOL of max|grad|), and within 2e-6 and GRAD_TOL of
    the frame in one slab."""
    _, fwd_bwd = _ert_frame(card, precision, 4)
    before = (ksweep.launches[1], kbwd.launches[1])
    rgb, t, grad = fwd_bwd()
    assert (ksweep.launches[1] - before[0], kbwd.launches[1] - before[1]) \
        == (4, 4)
    one = _ert_frame(card, precision, 1)[1]()
    monkeypatch.setattr(render, "resolve_impl", lambda impl, t: "torch")
    plain = fwd_bwd()
    for a, b in zip((rgb, t), plain[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 + 1e-4)
    for a, b in zip((rgb, t), one[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    tol = GRAD_TOL[precision] * float(plain[2].abs().max())
    torch.testing.assert_close(grad, plain[2], rtol=0, atol=tol)
    torch.testing.assert_close(grad, one[2], rtol=0, atol=tol)


def test_ert_chunked_frame_makes_no_host_sync(card):
    """The liveness gate stays on the device: a chunked frame and its
    gradient run under sync debug mode "error"."""
    frame, fwd_bwd = _ert_frame(card, "default", 4)
    frame()
    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame()
        fwd_bwd()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_light_volume_exact_on_the_card_matches_the_cpu(card):
    """'persample' at 16^3 (16 directions, step 1) on the card's tensors:
    the volume within 1e-5 of its maximum, the gradient of a seeded
    weighted sum within GRAD_TOL of max|grad|, against the CPU."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.ops import lighting as olight

    cfg = LightingConfig(mode="persample")
    sig = smoke_sphere(16, device="cpu")[..., 0].contiguous()
    w = torch.randn(sig.shape, generator=torch.Generator().manual_seed(2))

    def run(dev):
        s = sig.to(dev).requires_grad_(True)
        vol = olight.light_volume_exact(s, cfg)
        (grad,) = torch.autograd.grad((w.to(dev) * vol).sum(), s)
        return vol.detach().cpu(), grad.cpu()

    (v_c, g_c), (v, g) = run(card), run("cpu")
    torch.testing.assert_close(v_c, v, rtol=0,
                               atol=1e-5 * float(v.abs().max()))
    torch.testing.assert_close(g_c, g, rtol=0, atol=GRAD_TOL["highest"]
                               * float(g.abs().max()))


@pytest.mark.parametrize("oversample", [1.0, 2.0])
def test_render_with_geom_on_the_card_matches_the_cpu(card, oversample):
    """``render_with_geom`` from a c2 orbit view's geometry at 32^3 @ 48^2:
    K1 on the card against the plain version on the CPU (eps 0: 1e-5), with
    the grid gradient of sum(rgb^2) + sum(T) within GRAD_TOL of max|grad|,
    one K1 and one K3 launch."""
    from tpuvr_torch.ops.geometry import view_geometry

    cfg = RenderConfig(early_stop_eps=0.0, oversample=oversample)
    cam = configs.camera(configs.CONFIGS["c2"], 32, 48)
    axis, reverse, geom, band = view_geometry(cam, (32, 32, 32, 4),
                                              oversample=oversample)
    grid = smoke_sphere(32, device="cpu")

    def run(dev):
        g = grid.to(dev).requires_grad_(True)
        rgb, t = render.render_with_geom(g, geom, axis, reverse, cfg,
                                         band=band, device=dev)
        (grad,) = torch.autograd.grad((rgb * rgb).sum() + t.sum(), g)
        return rgb.detach().cpu(), t.detach().cpu(), grad.cpu()

    before = (ksweep.launches[1], kbwd.launches[1])
    on_card = run(card)
    assert (ksweep.launches[1] - before[0], kbwd.launches[1] - before[1]) \
        == (1, 1)
    rgb, t, grad = run("cpu")
    torch.testing.assert_close(on_card[0], rgb, rtol=0, atol=1e-5)
    torch.testing.assert_close(on_card[1], t, rtol=0, atol=1e-5)
    torch.testing.assert_close(on_card[2], grad, rtol=0, atol=GRAD_TOL[
        "highest"] * float(grad.abs().max()))


def test_cli_render_on_the_card(card, tmp_path):
    """``python -m tpuvr_torch.cli render`` at 32^3 (c1 at scale 0.5, 128^2)
    runs on the card by default, with one K1 launch, and equals its
    ``--device cpu`` run within 1e-5."""
    from tpuvr_torch import cli

    argv = ["render", "--config", "c1", "--scale", "0.5",
            "--out", str(tmp_path / "c1.png")]
    before = ksweep.launches[1]
    on_card = cli.main(argv)
    assert ksweep.launches[1] - before == 1
    plain = cli.main(argv + ["--device", "cpu"])
    assert on_card.shape == (128, 128, 3)
    np.testing.assert_allclose(on_card, plain, rtol=0, atol=1e-5)
    assert (tmp_path / "c1.png").stat().st_size > 0


def test_device_ms_counts_no_span(card, tmp_path, monkeypatch):
    """``chip_smoke.device_ms`` over a small lit fit: the spans that the
    profiler turns on add no ``tpuvr.*`` entry, and the device total is
    the one with the spans taken out, to the card's spread from profile
    to profile (a span's device range counted would about double it)."""
    import contextlib

    from chip_smoke import device_ms
    from tpuvr_torch.config import LightingConfig, TrainConfig
    from tpuvr_torch.io.synth import orbit_cameras
    from tpuvr_torch.utils import trace

    gt = smoke_sphere(32, device=card)
    cams = orbit_cameras(8, 32, res=32, elevation_deg=25.0)
    rcfg = RenderConfig(early_stop_eps=0.0)
    light = LightingConfig(mode="lightvolume", n_samples=3)
    targets = fit.render_all_views(gt, cams, rcfg, device=card)
    cfg = TrainConfig(lr=2e-2, steps=4, views_per_batch=2, ckpt_every=0,
                      seed=3)

    def run():
        fit.fit_grid(targets, cams, gt.shape, cfg, rcfg,
                     run_dir=str(tmp_path), lighting=light, device=card)

    on, top_on, _ = device_ms(run, 3, n_top=1000)
    for name in ("span", "request"):
        monkeypatch.setattr(trace, name,
                            lambda *a, **k: contextlib.nullcontext())
    off, top_off, _ = device_ms(run, 3, n_top=1000)
    assert not [k for k, _ in top_on if k.startswith("tpuvr.")]
    assert {k for k, _ in top_on} == {k for k, _ in top_off}
    assert on == pytest.approx(off, rel=0.25)


# The lit grid's one-pass assembly, K9 and K10 (csrc/light_apply.cu),
# against the ATen passes they replace (kernels.light_apply's twins, which
# ops.lighting runs on every other route): the same bits, since both do
# the same f32 operations in the same order.

LIGHT_UPS = [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0.3, -0.5, 0.8),
             (-0.9, 0.1, 0.3)]


def _ulps(a, b):
    """Largest distance in f32 units in the last place between two
    float32 tensors (signed zeros equal)."""
    def key(t):
        i = (t + 0.0).contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


def _lit_case(card, shape, n_samples, up, seed=0):
    """A seeded (Z, Y, X, 4) grid (some density below 0), its lighting
    config, direction axes and the batched sweep's taus."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.ops import lighting as olight

    gen = torch.Generator(device=card).manual_seed(seed)
    grid = torch.rand((*shape, 4), generator=gen, device=card)
    grid[..., 0] -= 0.2
    cfg = LightingConfig(mode="lightvolume", n_samples=n_samples, up=up)
    table = olight.direction_table(cfg)
    taus = olight._TauDirs.apply(grid[..., 0], table, "highest")
    return grid, cfg, [row[0] for row in table], taus


@pytest.mark.parametrize("shape", [(20, 33, 47), (17, 40, 9)])
@pytest.mark.parametrize("n_samples", [4, 16, 100])
@pytest.mark.parametrize("up", LIGHT_UPS)
def test_light_apply_kernels_match_plain(card, shape, n_samples, up):
    """K9's lit grid and L (and the lit grid alone, L not kept), and K10's
    grid gradient for the cotangent as each sweep layout hands it back (and
    a contiguous one), equal the ATen passes bit for bit: one launch each
    way, and one more forward launch a further 64 directions (100: the
    running sums carried from the first launch to the second)."""
    from tpuvr_torch.kernels import light_apply as kla

    grid, cfg, axes, taus = _lit_case(card, shape, n_samples, up)
    if n_samples == 16:
        assert set(axes) == {0, 1, 2}
    scale = cfg.sky_intensity / cfg.n_samples
    lit, ell = kla._forward(grid, taus, axes, scale, True)
    ref_ell = kla.light_value_torch(taus, axes, scale)
    assert _ulps(ell, ref_ell) == 0
    assert _ulps(lit, kla.lit_grid_torch(grid, ref_ell)) == 0
    assert torch.equal(kla._forward(grid, taus, axes, scale, False)[0], lit)
    gen = torch.Generator(device=card).manual_seed(1)
    for layout in ("contiguous", 0, 1, 2):
        def out(t, layout=layout):
            return (t if layout == "contiguous"
                    else render.grid_to_sweep_layout(t, layout))

        wts = torch.randn(out(grid).shape, generator=gen, device=card)
        grads = []
        for twin in (False, True):
            g = grid.clone().requires_grad_(True)
            before = kla.launches.copy()
            fn = kla.light_apply_torch if twin else kla.light_apply
            (out(fn(g, taus, axes, scale)) * wts).sum().backward()
            assert dict(kla.launches - before) == (
                {} if twin else {"fwd": -(-n_samples // kla.MAX_DIRS),
                                 "bwd": 1})
            grads.append(g.grad)
        assert _ulps(grads[0], grads[1]) == 0


def test_apply_lighting_takes_one_pass_on_the_card(card):
    """A detached bake of a float32 grid on the card launches K9 (and K10
    backward) and no fallback, with or without gradients, and equals the
    ATen route; so does ``detach=False`` for a grid that takes no gradient
    (K9 alone); 'persample' takes the ATen passes, counted once."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight

    grid, cfg, _, _ = _lit_case(card, (12, 14, 16), 16, (0.0, 0.0, 1.0))
    g = grid.clone().requires_grad_(True)
    before = kla.launches.copy()
    lit = olight.apply_lighting(g, cfg)
    lit.square().sum().backward()
    with torch.no_grad():
        lit_ng = olight.apply_lighting(grid, cfg)
    assert dict(kla.launches - before) == {"fwd": 2, "bwd": 1}
    ref = kla.lit_grid_torch(grid, olight.light_volume(grid[..., 0], cfg,
                                                       device=card))
    assert _ulps(lit.detach(), ref) == 0 and _ulps(lit_ng, ref) == 0
    before = kla.launches.copy()
    lit_nd = olight.apply_lighting(grid, cfg, detach=False)
    assert dict(kla.launches - before) == {"fwd": 1}
    assert _ulps(lit_nd, ref) == 0
    exact = LightingConfig(mode="persample", n_samples=2, secondary_dt=2.0)
    before = kla.launches.copy()
    olight.apply_lighting(grid[:6, :6, :6].contiguous(), exact)
    assert dict(kla.launches - before) == {"fallback": 1}


@pytest.mark.parametrize("layout", ["strided", "offset"])
def test_apply_lighting_takes_one_pass_for_any_layout(card, layout):
    """A float32 grid on the card that is not contiguous (a permuted view,
    512 wide) or not on a 16-byte boundary still takes K9 and K10 (the
    wrapper copies it first) and counts no fallback; its lit grid and its
    gradient, which reaches the base tensor, equal the ATen route's."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight

    def view(b):
        return (b.permute(2, 1, 0, 3) if layout == "strided"
                else b[1:].view(9, 10, 11, 4))

    gen = torch.Generator(device=card).manual_seed(2)
    base = torch.rand((512, 6, 5, 4) if layout == "strided"
                      else (1 + 9 * 10 * 11 * 4,), generator=gen,
                      device=card)
    cfg = LightingConfig(mode="lightvolume", n_samples=16,
                         up=(0.3, -0.5, 0.8))
    wts = torch.randn(view(base).shape, generator=gen, device=card)
    outs = []
    for plain in (False, True):
        b = base.clone().requires_grad_(True)
        g = view(b)
        assert not g.is_contiguous() or g.data_ptr() % 16
        before = kla.launches.copy()
        lit = (kla.lit_grid_torch(g, olight.light_volume(
            g[..., 0].detach(), cfg, device=card)) if plain
            else olight.apply_lighting(g, cfg))
        (lit * wts).sum().backward()
        assert dict(kla.launches - before) == (
            {} if plain else {"fwd": 1, "bwd": 1})
        outs.append((lit.detach(), b.grad))
    assert _ulps(outs[0][0], outs[1][0]) == 0
    assert _ulps(outs[0][1], outs[1][1]) == 0


@pytest.mark.parametrize("density_softplus", [False, True])
def test_lit_fit_launches_one_pass_a_step_and_keeps_its_bits(
        card, tmp_path, monkeypatch, density_softplus):
    """A 3-step lit fit at 64^3 (16 directions, detached): one K9 and one
    K10 a step, no fallback, and parameters equal to those of the same fit
    through the ATen passes, bit for bit."""
    from tpuvr_torch.config import LightingConfig, TrainConfig
    from tpuvr_torch.io.synth import orbit_cameras
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight

    gt = smoke_sphere(64, device=card)
    cams = orbit_cameras(4, 64, res=48, elevation_deg=25.0)
    rcfg = RenderConfig(early_stop_eps=0.0)
    light = LightingConfig(mode="lightvolume", n_samples=16)
    targets = fit.render_all_views(gt, cams, rcfg, lighting=light,
                                   device=card)
    cfg = TrainConfig(lr=2e-2, steps=3, views_per_batch=1, ckpt_every=0,
                      seed=3, density_softplus=density_softplus)
    params = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(olight, "light_apply",
                                kla.light_apply_torch)
        before = kla.launches.copy()
        _, p, _ = fit.fit_grid(targets, cams, gt.shape, cfg, rcfg,
                               run_dir=str(tmp_path / str(plain)),
                               lighting=light, device=card)
        assert dict(kla.launches - before) == (
            {} if plain else {"fwd": 3, "bwd": 3})
        params.append(p)
    assert _ulps(params[0], params[1]) == 0


def _sweep_view_cotangent(shape, layout, gen, card):
    """A (Z, Y, X, 4) view of a seeded gradient in sweep axis ``layout``'s
    (S, 4, Ny, Nx) layout, as the sweep's backward hands it back."""
    from tpuvr_torch.ref.march import GRID_PERM

    p = [shape[i] for i in GRID_PERM[layout][:3]]
    return torch.randn((p[0], 4, p[1], p[2]), generator=gen,
                       device=card).permute(0, 2, 3, 1).permute(
        tuple(int(i) for i in np.argsort(GRID_PERM[layout])))


@pytest.mark.parametrize("shape", [(20, 33, 47), (17, 40, 9)])
@pytest.mark.parametrize("n_samples", [4, 16, 64, 100])
@pytest.mark.parametrize("up", LIGHT_UPS)
def test_shadow_kernels_match_plain(card, shape, n_samples, up):
    """K11's grid gradient and the cotangents it writes over the taus, for
    the lit grid's cotangent as each sweep layout hands it back (and a
    contiguous one), and K12's masked sum with the z sweep's sigma and with
    the grid's channel 0, equal their ATen passes bit for bit, one launch
    each a run of 64 directions (100: the sums carried from one launch to
    the next, K12's from the last run to the first)."""
    from tpuvr_torch.kernels import light_apply as kla

    grid, cfg, axes, taus = _lit_case(card, shape, n_samples, up)
    scale = cfg.sky_intensity / cfg.n_samples
    gen = torch.Generator(device=card).manual_seed(3)
    for layout in ("contiguous", 0, 1, 2):
        g = (torch.randn(grid.shape, generator=gen, device=card)
             if layout == "contiguous"
             else _sweep_view_cotangent(shape, layout, gen, card))
        cots = [t.clone() for t in taus]
        plain = [t.clone() for t in taus]
        runs = -(-n_samples // kla.MAX_DIRS)
        before = kla.launches.copy()
        dgrid = kla.shadow_cotangents(g, grid, cots, axes, scale)
        assert dict(kla.launches - before) == {"shadow_bwd": runs}
        assert _ulps(dgrid, kla.shadow_cotangents_torch(
            g, grid, plain, axes, scale)) == 0
        assert max(_ulps(a, b) for a, b in zip(cots, plain)) == 0
        for sigma in (grid[..., 0].contiguous(), grid[..., 0]):
            a, b = dgrid.clone(), dgrid.clone()
            before = kla.launches.copy()
            kla.mask_sum(a, cots, axes, sigma)
            assert dict(kla.launches - before) == {"mask": runs}
            kla.mask_sum_torch(b, cots, axes, sigma)
            assert _ulps(a, b) == 0


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("layout", ["contiguous", 0, 1, 2, "strided"])
def test_shadow_route_matches_the_aten_route(card, n, layout):
    """An undetached 16-direction bake of a smoke sphere (density partly
    below 0) through the shadow route (K2, K9; K11, K4, K12) gives the lit
    grid and the grid gradient of the ATen route (``light_volume``, then
    ``lit_grid_torch``) bit for bit, for the lit grid's cotangent as each
    sweep layout hands it back, a contiguous one, and a grid that is a
    permuted view (copied first; its gradient reaches the base tensor):
    one K9, K11 and K12 launch, no K10, no fallback, 16 adjoint directions
    and one ``light_shadow`` bake and adjoint."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.utils import trace

    base = smoke_sphere(n, device=card).clone()
    base[..., 0] -= 0.05
    cfg = LightingConfig(mode="lightvolume", n_samples=16, detach=False)
    gen = torch.Generator(device=card).manual_seed(4)
    cot = (_sweep_view_cotangent(base.shape[:3], 1, gen, card)
           if layout == "strided"
           else torch.randn(base.shape, generator=gen, device=card)
           if layout == "contiguous"
           else _sweep_view_cotangent(base.shape[:3], layout, gen, card))
    outs = []
    for aten in (False, True):
        if layout == "strided":
            leaf = base.permute(2, 1, 0, 3).contiguous().requires_grad_(True)
            g = leaf.permute(2, 1, 0, 3)
        else:
            leaf = base.clone().requires_grad_(True)
            g = leaf
        before = trace.launch_counts()
        lit = (kla.lit_grid_torch(g, olight.light_volume(g[..., 0], cfg,
                                                         device=card))
               if aten else olight.apply_lighting(g, cfg))
        lit.backward(cot)
        torch.cuda.synchronize()
        counts = trace.launch_counts() - before
        if not aten:
            assert {k: v for k, v in counts.items()
                    if k.startswith("light_")} == {
                "light_apply_fwd": 1, "light_apply_shadow_bwd": 1,
                "light_apply_mask": 1, "light_shadow": 1,
                "light_shadow_adjoint": 1}
            assert counts["tau_adj_dirs"] == 16
        outs.append((lit.detach(), leaf.grad))
    assert _ulps(outs[0][0], outs[1][0]) == 0
    assert _ulps(outs[0][1], outs[1][1]) == 0


@pytest.mark.parametrize("layout", ["contiguous", 0])
def test_shadow_route_takes_more_than_64_directions(card, layout):
    """An undetached 100-direction bake at 48^3 takes the shadow route in
    two launches of K9, K11 and K12 (the sums carried between them), 100
    adjoint directions and no fallback, with the ATen route's lit grid and
    grid gradient bit for bit."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.utils import trace

    base = smoke_sphere(48, device=card).clone()
    base[..., 0] -= 0.05
    cfg = LightingConfig(mode="lightvolume", n_samples=100,
                         up=(0.3, -0.5, 0.8), detach=False)
    gen = torch.Generator(device=card).manual_seed(5)
    cot = (torch.randn(base.shape, generator=gen, device=card)
           if layout == "contiguous"
           else _sweep_view_cotangent(base.shape[:3], layout, gen, card))
    outs = []
    for aten in (False, True):
        leaf = base.clone().requires_grad_(True)
        before = trace.launch_counts()
        lit = (kla.lit_grid_torch(leaf, olight.light_volume(
            leaf[..., 0], cfg, device=card)) if aten
            else olight.apply_lighting(leaf, cfg))
        lit.backward(cot)
        torch.cuda.synchronize()
        counts = trace.launch_counts() - before
        if not aten:
            assert {k: v for k, v in counts.items()
                    if k.startswith("light_")} == {
                "light_apply_fwd": 2, "light_apply_shadow_bwd": 2,
                "light_apply_mask": 2, "light_shadow": 1,
                "light_shadow_adjoint": 1}
            assert counts["tau_adj_dirs"] == 100
        outs.append((lit.detach(), leaf.grad))
    assert _ulps(outs[0][0], outs[1][0]) == 0
    assert _ulps(outs[0][1], outs[1][1]) == 0


def test_undetached_light_bake_without_a_gradient_launches_k9_alone(card):
    """An undetached 16-direction bake at 64^3 under ``torch.no_grad`` (as
    ``render_all_views`` and ``prepare_grid`` make it) of a grid that takes
    a gradient is the detached bake's function: one K9, no K10, K11, K12,
    K4 or fallback and no shadow bake, with the ATen route's lit grid bit
    for bit."""
    from tpuvr_torch.config import LightingConfig
    from tpuvr_torch.kernels import light_apply as kla
    from tpuvr_torch.ops import lighting as olight
    from tpuvr_torch.utils import trace

    grid = smoke_sphere(64, device=card).clone().requires_grad_(True)
    cfg = LightingConfig(mode="lightvolume", n_samples=16, detach=False)
    with torch.no_grad():
        before = trace.launch_counts()
        lit = olight.apply_lighting(grid, cfg)
        torch.cuda.synchronize()
        counts = trace.launch_counts() - before
        ref = kla.lit_grid_torch(grid, olight.light_volume(
            grid[..., 0], cfg, device=card))
    assert {k: v for k, v in counts.items()
            if k.startswith("light_")} == {"light_apply_fwd": 1}
    assert counts["tau_adj_dirs"] == 0 and counts["tau_sweep_dirs"] == 16
    assert not lit.requires_grad and _ulps(lit, ref) == 0


@pytest.mark.parametrize("density_softplus", [False, True],
                         ids=["raw", "softplus"])
def test_undetached_lit_fit_matches_the_shadow_reference(
        card, tmp_path, density_softplus):
    """The benchmark's c5-shadow fit (light not detached) cut to 64^3 at
    64^2, 16 directions, 3 steps through ``fit_grid`` as its job calls
    it: the first step's loss (1e-5 relative) and each leaf's gradient
    (1e-5 of the leaf's max|grad|: the sweeps, K2 and K4 sum in other
    orders than the reference's dense matmuls) against
    ``vrbench/ref/shadow.py`` on the card, TF32 off; one ``light_shadow``
    bake, one ``light_shadow_adjoint`` and 16 adjoint directions a step,
    the span ``tpuvr.light.adjoint`` once a step, one K9, K11 and K12 a
    step, no K10 and no fallback."""
    from tpuvr_torch.utils import trace
    from vrbench import fitjob
    from vrbench.ref import shadow as RS
    from vrbench.ref import train as RT
    from vrbench.ref.sweep import strict_f32
    from vrbench.spec import Spec

    strict_f32()
    cfg = Spec().config("c5-shadow")
    cfg.update(grid_n=64, res=64, density_softplus=density_softplus)
    assert cfg["lighting"]["n_samples"] == 16
    inp = fitjob.Inputs(cfg, {}, 2**31 + 5, card)
    gen = torch.Generator(device=card).manual_seed(6)
    p0 = torch.rand(inp.shape, generator=gen, device=card) + 0.1
    # density in [-0.06, 0.24), or in [-3, -1) raw through softplus
    p0[..., 0] = ((p0[..., 0] - 0.1) * 2.0 - 3.0 if density_softplus
                  else (p0[..., 0] - 0.3) * 0.3)
    rcfg, lcfg = fitjob.program_configs(cfg)
    grads = []

    class Keep(fit.Adam):
        def update(self, g, state):
            grads.append(g.clone())
            return super().update(g, state)

    steps = 3
    before = trace.launch_counts()
    with trace.recording():
        _, _, hist = fit.fit_grid(
            inp.targets, fitjob.program_cameras(inp.cams), inp.shape,
            fitjob.train_config(cfg, steps, inp.draw.fit_seed), rcfg,
            lighting=lcfg, params_init=p0, opt=Keep(cfg["lr"]),
            run_dir=str(tmp_path), device=card, **fitjob.fit_options(cfg))
        torch.cuda.synchronize()
        snap = trace.snapshot()
    counts = trace.launch_counts() - before
    assert counts["light_shadow"] == steps
    assert counts["light_shadow_adjoint"] == steps
    assert counts["tau_adj_dirs"] == 16 * steps
    assert counts["light_apply_fwd"] == steps
    assert counts["light_apply_shadow_bwd"] == steps
    assert counts["light_apply_mask"] == steps
    assert counts["light_apply_bwd"] == counts["light_apply_fallback"] == 0
    assert snap["totals"]["tpuvr.light.adjoint"]["count"] == steps
    pick = RT.draws(inp.views, cfg, 1, inp.draw.fit_seed)[0]
    loss, g = RS.loss_and_grad(p0, inp.views, inp.targets, pick, cfg, 64)
    assert abs(hist["loss"][0] - float(loss)) <= 1e-5 * abs(float(loss))
    for c in range(4):
        scale = float(g[..., c].abs().max())
        assert scale > 0
        err = float((grads[0][..., c] - g[..., c]).abs().max())
        assert err <= 1e-5 * scale, (c, err / scale)
