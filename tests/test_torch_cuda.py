"""tpuvr_torch's CUDA kernels against their plain PyTorch versions, on
the card, at small sizes. Every test needs an NVIDIA card (sm_90a for the
built kernels) and skips without one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: 1e-5 absolute at early_stop_eps = 0 (f32 roundoff); with
eps > 0 the kernel stops each ray at its own T < eps and the plain
version at the global maximum, so they differ by at most eps * max|c|.
"""

import numpy as np
import pytest
import torch

from tpuvr_torch import configs
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.kernels import lighting as klight
from tpuvr_torch.kernels import sweep as ksweep
from tpuvr_torch.kernels.sweep_torch import sweep_fwd_torch
from tpuvr_torch.ops import render
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


def test_card_refuses_gradients(card):
    g = smoke_sphere(8, device=card).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        render.render_view(g, configs.front_ortho(8, 8), device=card)
    with pytest.raises(NotImplementedError, match="training slice"):
        klight.tau_sweep(g[..., 0].contiguous(), d_y=0.0, d_x=0.0, dt=1.0)
    with torch.no_grad():
        rgb, _ = render.render_view(g, configs.front_ortho(8, 8),
                                    device=card)
    assert bool(torch.isfinite(rgb).all())


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
