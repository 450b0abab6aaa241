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
from tpuvr_torch.kernels.sweep_torch import sweep_bwd_torch, sweep_fwd_torch
from tpuvr_torch.ops import render, vjp
from tpuvr_torch.ref.camera import dominant_axis

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
    before = ksweep.launches
    k = ksweep.sweep_fwd(*args, **kw)
    p = sweep_fwd_torch(*args, **kw)
    assert ksweep.launches == before + 1
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 + eps)


@pytest.mark.parametrize("d", [(0.37, -0.81), (-1.0, 0.25), (0.0, 0.0)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_tau_kernel_matches_plain(card, d, precision):
    sig = smoke_sphere(20, device=card)[..., 0].contiguous()
    kw = dict(d_y=d[0], d_x=d[1], dt=1.3, precision=precision)
    before = klight.launches
    k = klight.tau_sweep(sig, **kw)
    p = klight.tau_sweep_torch(sig, **kw)
    assert klight.launches == before + 1
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
    before = kbwd.launches
    k = kbwd.sweep_bwd(*args, rgb, t, d_rgb, d_t, **kw)
    p = sweep_bwd_torch(*args, rgb, t, d_rgb, d_t, **kw)
    assert kbwd.launches == before + 1
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
    before = klight.adj_launches
    k = klight.tau_sweep_adj(g, **kw)
    p = klight.tau_sweep_adj_torch(g, **kw)
    assert klight.adj_launches == before + 1
    assert bool((k[0] == 0).all())
    torch.testing.assert_close(k, p, rtol=0,
                               atol=1e-5 * float(p.abs().max()))


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
        before = (kbwd.launches, klight.adj_launches)
        rgb, t = render.render_view(g, cam, RenderConfig(early_stop_eps=0.0),
                                    lighting=lit, device=dev)
        (rgb.square().sum() + t.sum()).backward()
        grads[str(dev)] = g.grad.cpu()
        launched = (kbwd.launches - before[0],
                    klight.adj_launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 3))
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
