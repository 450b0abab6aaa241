"""The voxel-line plan of the backward sweep's voxel stage
(``csrc/sweep_bwd.cu``): for every (slice, view, voxel row or column) the
kernel gathers only over the rays ``line_rays`` names, so every ray whose
tent weight on a voxel line is non-zero must lie in that line's range, and
a voxel whose row or column range is empty in every view gets zero
gradient. ``kernels/sweep_bwd.py`` mirrors the device helpers
(``rays_reaching``, ``line_rays``) in f32 numpy; here they are held against
brute force over the tent weights, with the forward's f32 position
formula, at the coefficients of c1, c2 (a reverse perspective sweep), c4's
four view groups, the lit fit's 128^3 at 128^2 and c4's 4-rank row tiles,
and at edge coefficients; and the plain twin's gradient for a row tile is
zero on every voxel row the plan gives no ray.
"""

import functools

import numpy as np
import pytest
import torch

from tpuvr_torch import configs
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.kernels import _build
from tpuvr_torch.kernels import sweep as ksweep
from tpuvr_torch.kernels import sweep_bwd as kbwd
from tpuvr_torch.kernels.sweep_torch import (
    sweep_bwd_views_torch,
    sweep_fwd_views_torch,
)
from tpuvr_torch.ops import render
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.train import fit


def _positions(n_rays, a, b, row0=0):
    """Ray positions (row0 + i)*a + b in f32, a product then a sum, as the
    kernels form them."""
    i = np.arange(row0, row0 + n_rays, dtype=np.float32)
    return i * np.float32(a) + np.float32(b)


def _check_axis(n_rays, a, b, n_vox, row0=0):
    """On every voxel line c: the rays with a non-zero tent weight lie in
    rays_reaching's band and in line_rays' range; every ray of that range
    has floor(pos) in {c - 1, c}; and the range is empty exactly where no
    ray's floor(pos) is c - 1 or c."""
    pos = _positions(n_rays, a, b, row0)
    c = np.arange(n_vox, dtype=np.float32)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(
        pos[:, None] - c[None, :]).astype(np.float32))
    lo, hi = kbwd.rays_reaching(np.arange(n_vox), a, b, row0 + n_rays)
    lo = np.maximum(lo, row0)
    floor = np.floor(pos)
    for line in range(n_vox):
        hit = np.nonzero(w[:, line] > 0)[0] + row0
        first, count = kbwd.line_rays(line, a, b, row0 + n_rays, row0)
        if hit.size:
            assert lo[line] <= hit.min() and hit.max() <= hi[line]
            assert first <= hit.min() and hit.max() < first + count, (
                a, b, line, first, count, hit)
        near = np.nonzero((floor == line - 1) | (floor == line))[0] + row0
        near = near[(near >= lo[line]) & (near <= hi[line])]
        assert count == near.size and (count == 0 or first == near.min())


def _check_plan(coeffs, enables, shape, n_v, n_u, row0=0, every=1):
    """Both axes of every ``every``-th enabled slice of one view."""
    n_y, n_x = shape
    ay, by, ax, bx = (np.asarray(c, dtype=np.float32) for c in coeffs)
    for k in range(0, ay.shape[0], every):
        if enables[k] == 0:
            continue
        _check_axis(n_v, ay[k], by[k], n_y, row0)
        _check_axis(n_u, ax[k], bx[k], n_x)


def _single_plan(name):
    cfg = configs.CONFIGS[name]
    cam = configs.camera(cfg)
    n = cfg["grid_n"]
    prep = render.prepare_grid(smoke_sphere(n, device="cpu"),
                               axes=(dominant_axis(cam),), device="cpu")
    plan, _, (grid_sc, coeffs, en, dt) = render.sweep_inputs(
        prep, cam, cfg["render"], "cpu")
    return plan, grid_sc.shape, coeffs, en, dt.shape


@functools.lru_cache(maxsize=None)
def _groups(n, res, n_views):
    cams = configs.cameras(configs.CONFIGS["c4"], n=n, res=res,
                           n_views=n_views)
    return fit.group_views(cams, (n, n, n, 4))


def test_plan_holds_at_c1_ortho():
    plan, shape, coeffs, en, (n_v, n_u) = _single_plan("c1")
    assert abs(float(coeffs[0][0])) < 0.5  # several rays per voxel
    _check_plan(coeffs, en, shape[2:], n_v, n_u, every=9)


def test_plan_holds_at_c2_reverse_perspective():
    plan, shape, coeffs, en, (n_v, n_u) = _single_plan("c2")
    assert plan.reverse
    _check_plan(coeffs, en, shape[2:], n_v, n_u, every=17)


@pytest.mark.parametrize("n,res", [(256, 256), (128, 128)],
                         ids=["c4", "lit_fit_128"])
def test_plan_holds_in_each_c4_group(n, res):
    """c4's four view groups at 256^3 from 256^2 views (more voxels than
    rays: 1.3-3.6 voxels a ray), and the lit fit's 128^3 at 128^2: the
    first view of each group."""
    groups = _groups(n, res, 64)
    assert len(groups) == 4
    for key in sorted(groups):
        _, stacked, _, _ = groups[key]
        coeffs = stacked["coeffs"][0]
        n_v, n_u = stacked["dt"].shape[1:]
        _check_plan([coeffs[i].numpy() for i in range(4)],
                    np.asarray(stacked["valid"][0]), (n, n), n_v, n_u,
                    every=23)


def test_plan_holds_on_c4_row_tiles():
    """A 4-rank row tile of a c4 group's first view: rows [row0, row0 +
    64) of 256, the ranges cut to them."""
    groups = _groups(256, 256, 64)
    _, stacked, _, _ = groups[sorted(groups)[1]]
    coeffs = stacked["coeffs"][0]
    n_v, n_u = stacked["dt"].shape[1:]
    for r in range(4):
        ay, by = (coeffs[i].numpy() for i in range(2))
        for k in range(0, ay.shape[0], 29):
            _check_axis(n_v // 4, ay[k], by[k], 256, row0=r * n_v // 4)


@pytest.mark.parametrize("a,b", [(0.0, 3.3), (0.0, 40.0), (1e-31, 5.5),
                                 (-2.7, 100.0), (0.06, -3.0),
                                 (-0.3, 50.0), (3.6, -200.0)])
def test_plan_holds_at_edge_coefficients(a, b):
    """|a| < 1e-30 (every ray on one or two lines, or none), |a| > 1
    (lines no ray reaches), a tiny grid under a large image, and reverse
    directions."""
    _check_axis(64, a, b, 40)
    _check_axis(16, a, b, 40, row0=24)


def test_row_tile_gradient_is_zero_where_the_plan_has_no_ray():
    """The plain twin's gradient for a row tile of a 4-view batch (a
    quarter of each view's rows) is exactly zero on every voxel row whose
    plan is empty in every view."""
    n, res, views = 24, 20, 4
    groups = _groups(n, res, 16)
    key = sorted(groups)[0]
    _, stacked, _, _ = groups[key]
    grid = smoke_sphere(n, device="cpu") + torch.tensor([0.3, 0, 0, 0])
    grid_sc = render.grid_to_sweep_layout(grid, key[0]).contiguous()
    coeffs = tuple(stacked["coeffs"][:views, i].contiguous()
                   for i in range(4))
    en = (render.slice_enables(grid_sc, key[1], True)[None]
          * stacked["valid"][:views]).contiguous()
    v_l = res // 4
    gen = torch.Generator().manual_seed(0)
    for r in (0, 3):
        dt = stacked["dt"][:views, r * v_l:(r + 1) * v_l].reshape(
            -1, res).contiguous()
        kw = dict(reverse=key[1], precision="highest", views=views,
                  row0=r * v_l)
        rgb, t = sweep_fwd_views_torch(grid_sc, coeffs, en, dt, **kw)
        d_rgb = torch.randn((3, *t.shape), generator=gen)
        d_t = torch.randn(t.shape, generator=gen)
        g = sweep_bwd_views_torch(grid_sc, coeffs, en, dt, rgb, t, d_rgb,
                                  d_t, **kw)
        s = grid_sc.shape[0]
        reached = np.zeros((s, n), dtype=bool)
        for k in range(s):
            at = s - 1 - k if key[1] else k
            for w in range(views):
                if float(en[w, k]) != 0.0:
                    a, b = float(coeffs[0][w, k]), float(coeffs[1][w, k])
                    reached[at] |= [kbwd.line_rays(y, a, b, r * v_l + v_l,
                                                   r * v_l)[1] > 0
                                    for y in range(n)]
        rows = g.abs().amax(dim=(1, 3)).numpy()  # (S, Y)
        assert (rows[~reached] == 0.0).all()
        assert (~reached).any() and rows[reached].max() > 0.0


def test_entries_resolve_once(monkeypatch):
    """The sweep wrappers resolve and type their C entries once per
    process, not at every launch."""
    loads = []

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {"__name__": name})()

    def load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_entries", {})
    for _ in range(2):
        kbwd._entry()
        ksweep._entry()
    assert loads == ["sweep_bwd", "sweep_fwd"]


def test_scratch_holds_two_buffers_and_the_plan():
    """The wrapper's scratch: two dS buffers when the sweep takes more
    than one slab (one otherwise), then the plan's float4 weights and int2
    ranges per (slice, view, voxel line)."""
    assert kbwd.scratch_floats(256, 16, 2048, 256, 256, 256, 8) == (
        4 * 2 * 16 * 2048 * 256 + 6 * 256 * 8 * 512)
    assert kbwd.scratch_floats(8, 8, 40, 24, 12, 16, 2) == (
        4 * 8 * 40 * 24 + 6 * 8 * 2 * 28)
