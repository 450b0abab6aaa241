"""The forward sweep kernel's per-tile windows (``csrc/sweep_fwd.cu``):
a block of 8 x 32 rays stages or gathers, per slice, only the voxel rows
and columns its window names, so every tap of every ray inside the tents'
support must lie in its tile's window, and a tile with such a ray must not
be skipped. ``kernels/sweep.py``'s ``tile_windows`` is the numpy twin of
the kernel's window and regime arithmetic (the same f32 position formula);
here it is held against the rays' own taps, brute force, at the real
geometry of c1, c2 (a reverse perspective sweep), the headline and a c4
view and its row tiles, at edge coefficients, and its geometry counts
against the figures the kernel's design was sized from. Numpy only: no
grid is swept.
"""

import functools

import numpy as np
import pytest
import torch

from tpuvr_torch import configs
from tpuvr_torch.kernels import sweep as ksweep
from tpuvr_torch.ops.render import _frame_geometry
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.train import fit


@functools.lru_cache(maxsize=None)
def _single(name):
    """(coeffs, enables, n, V, U) of a render config's camera, its sweep
    plan at full size."""
    cfg = configs.CONFIGS[name]
    cam = configs.camera(cfg)
    n = cfg["grid_n"]
    _, coeffs, dt, valid, _ = _frame_geometry(
        cam, (n, n, n, 4), dominant_axis(cam), 1.0, torch.float32, "cpu")
    return (tuple(c.numpy() for c in coeffs), valid.numpy(), n,
            *dt.shape)


@functools.lru_cache(maxsize=None)
def _c4_groups():
    c4 = configs.CONFIGS["c4"]
    n = c4["grid_n"]
    return fit.group_views(configs.cameras(c4), (n, n, n, 4))


def _c4(group=0, views=8):
    _, stacked, _, _ = _c4_groups()[sorted(_c4_groups())[group]]
    coeffs = tuple(stacked["coeffs"][:views, i].numpy() for i in range(4))
    n_v, n_u = stacked["dt"].shape[1:]
    return coeffs, stacked["valid"][:views].numpy(), 256, n_v, n_u


def _positions(a, b, n_rays, row0=0):
    """(..., n_rays) ray positions (row0 + i)*a + b in f32."""
    i = np.arange(row0, row0 + n_rays, dtype=np.float32)
    return (np.asarray(a, np.float32)[..., None] * i
            + np.asarray(b, np.float32)[..., None])


def _tiles(x, tile):
    """(..., n) -> (..., tiles, tile), padded with NaN (never in range)."""
    pad = -x.shape[-1] % tile
    x = np.concatenate((x, np.full((*x.shape[:-1], pad), np.nan,
                                   np.float32)), -1)
    return x.reshape(*x.shape[:-1], -1, tile)


def _check_axis(pos, lo, lines, tile, n):
    """Every ray in range on this axis has both taps in its tile's window,
    which lies in [-1, n]; returns (..., tiles) 'some ray in range'."""
    p = _tiles(pos, tile)
    with np.errstate(invalid="ignore"):
        inside = (p > -1.0) & (p < n)
        f0 = np.floor(p)
    hit = inside.any(-1)
    assert (lo[hit] >= -1).all() and ((lo + lines - 1)[hit] <= n).all()
    low = np.where(inside, f0 - lo[..., None], 0)
    high = np.where(inside, f0 + 1 - (lo + lines - 1)[..., None], 0)
    assert (low >= 0).all() and (high <= 0).all()
    return hit


def _check(coeffs, enables, n, n_v, n_u, row0=0):
    tw = ksweep.tile_windows(coeffs, enables, n, n, n_v, n_u, row0)
    ay, by, ax, bx = (np.atleast_2d(c) for c in coeffs)
    en = np.atleast_2d(enables) != 0
    hit_y = _check_axis(_positions(ay, by, n_v, row0), tw["y_lo"],
                        tw["rows"], ksweep.TILE_V, n)
    hit_x = _check_axis(_positions(ax, bx, n_u), tw["x_lo"], tw["cols"],
                        ksweep.TILE_U, n)
    reached = en[..., None, None] & hit_y[..., :, None] & hit_x[..., None, :]
    reg = tw["regime"]
    assert ((reg != ksweep.SKIP) == reached).all()
    dense = reg == ksweep.DENSE
    rows = np.broadcast_to(tw["rows"][..., :, None], reg.shape)
    cols = np.broadcast_to(tw["cols"][..., None, :], reg.shape)
    assert (rows[dense] <= ksweep.DENSE_ROWS).all()
    assert (cols[dense] <= ksweep.DENSE_COLS).all()
    fits = (rows <= ksweep.DENSE_ROWS) & (cols <= ksweep.DENSE_COLS)
    if n % 4 == 0:
        assert (reg[reached & fits] == ksweep.DENSE).all()
    else:
        assert not dense.any()
    return tw


@pytest.mark.parametrize("name", ["c1", "c2", "headline"])
def test_windows_hold_every_tap_in_the_render_configs(name):
    coeffs, en, n, n_v, n_u = _single(name)
    reg = _check(coeffs, en, n, n_v, n_u)["regime"]
    # These shapes take only the dense regime where they do not skip.
    assert (reg == ksweep.DENSE).any() and not (reg == ksweep.SPARSE).any()


@pytest.mark.parametrize("group", [0, 1])
def test_windows_hold_every_tap_in_a_c4_minibatch(group):
    """8 views of a c4 group at 256^2 over 256^3: mostly sparse, with the
    dense regime where a window is clipped to the grid's edge."""
    reg = _check(*_c4(group))["regime"]
    live = reg != ksweep.SKIP
    assert (reg == ksweep.SPARSE).sum() > 10 * (reg == ksweep.DENSE).sum()
    assert (reg == ksweep.DENSE).any() and live.any()


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_windows_hold_every_tap_on_c4_row_tiles(r):
    """A rank's quarter of each view's rows (row0 = 0, 64, 128, 192)."""
    coeffs, en, n, n_v, n_u = _c4(1, views=2)
    _check(coeffs, en, n, n_v // 4, n_u, row0=r * n_v // 4)


@pytest.mark.parametrize("a,b", [(0.0, 3.3), (0.0, -0.5), (0.0, 40.0),
                                 (1e-31, 5.5), (-2.7, 100.0), (0.06, -3.0),
                                 (-0.3, 50.0), (3.6, -200.0), (0.6, -5.0)])
@pytest.mark.parametrize("n", [40, 18])
def test_windows_hold_at_edge_coefficients(a, b, n):
    """a = 0 (every ray on one line), |a| > 1, windows overhanging the
    grid's edges, reverse directions; n = 18 is no multiple of 4 (no dense
    regime)."""
    s = 3
    coeffs = (np.full(s, a, np.float32), np.full(s, b, np.float32),
              np.full(s, a * 0.9, np.float32), np.full(s, b + 0.3,
                                                       np.float32))
    _check(coeffs, np.array([1.0, 0.0, 1.0]), n, 37, 70)
    _check(coeffs, np.array([1.0, 1.0, 1.0]), n, 16, 40, row0=21)


def test_a_view_crossing_the_box_takes_both_regimes():
    """Slopes rising along the sweep (0.3 -> 2.0 voxels a ray): one view's
    tiles go from dense to sparse."""
    s, n = 40, 40
    k = np.arange(s, dtype=np.float64)
    a = 0.3 + 1.7 * k / (s - 1)
    coeffs = tuple(np.asarray(c, np.float32) for c in (
        a, n / 2 - a * 12 + 0.37, a * 0.9, n / 2 - a * 0.9 * 36 - 0.21))
    reg = _check(coeffs, (k % 7 != 3).astype(np.float32), n, 24, 72)[
        "regime"][0]
    per_slice = [set(np.unique(reg[i])) - {ksweep.SKIP} for i in range(s)]
    assert per_slice[0] == {ksweep.DENSE}
    assert ksweep.SPARSE in per_slice[-1]


@pytest.mark.parametrize("name,ray_slices,support,warps,taps", [
    ("c1", 4.19e6, 2.21e6, None, 33.8),
    ("c2", 8.39e6, 2.83e6, 0.39, 5.39),
    ("headline", 67.1e6, 34.67e6, 0.54, 8.27),
])
def test_geometry_counts_match_the_design_figures(name, ray_slices, support,
                                                  warps, taps):
    coeffs, en, n, n_v, n_u = _single(name)
    st = ksweep.window_stats(coeffs, en, n, n, n_v, n_u)
    assert st["ray_slices"] == pytest.approx(ray_slices, rel=2e-3)
    assert st["in_support"] == pytest.approx(support, rel=2e-3)
    assert st["taps_per_voxel"] == pytest.approx(taps, rel=2e-3)
    if warps is not None:
        assert st["warp_slices_in_range"] == pytest.approx(warps, abs=0.01)
    shares = st["regime_shares"]
    assert shares["sparse"] == 0.0
    assert shares["dense"] + shares["skip"] == pytest.approx(1.0)


def test_geometry_counts_of_the_c4_minibatch():
    """134.2 M ray-slices, 25% inside the tents' support, 31% of warp-
    slices in range, slopes 1.3-3.6 voxels a ray; about a third of the
    (tile, slice) pairs work, nearly all sparse."""
    st = ksweep.window_stats(*_c4(0)[:2], 256, 256, 256, 256)
    assert st["ray_slices"] == 8 * 256 * 256 * 256
    assert st["in_support"] == pytest.approx(33.84e6, rel=2e-3)
    assert st["warp_slices_in_range"] == pytest.approx(0.31, abs=0.01)
    assert 1.3 < st["ay_abs"][0] and st["ay_abs"][1] < 3.7
    shares = st["regime_shares"]
    assert 0.3 < shares["sparse"] < 0.34 and 0.005 < shares["dense"] < 0.03


def test_wrapper_raises_past_the_kernel_limits():
    """The checks the wrapper runs before a launch, on meta tensors (no
    memory, no card)."""
    def t(*shape):
        return torch.empty(shape, device="meta")

    ok = ksweep.check_fwd(t(8, 4, 16, 16), t(4 * 5, 7), "highest", 4)
    assert ok == (8, 16, 16, 20, 7, 5)
    with pytest.raises(ValueError, match="slices"):
        ksweep.check_fwd(t(2049, 4, 1, 1), t(2, 1), "highest", 1)
    with pytest.raises(ValueError, match="views"):
        ksweep.check_fwd(t(1, 4, 1, 1), t(65536, 1), "highest", 65536)
    with pytest.raises(ValueError, match="equal views"):
        ksweep.check_fwd(t(1, 4, 1, 1), t(7, 1), "highest", 2)
    with pytest.raises(ValueError, match="32-bit"):
        ksweep.check_fwd(t(1, 4, 23171, 23171), t(2, 1), "highest", 1)
    with pytest.raises(ValueError, match="precision"):
        ksweep.check_fwd(t(1, 4, 1, 1), t(2, 1), "low", 1)
    with pytest.raises(ValueError, match="empty"):
        ksweep.check_fwd(t(1, 4, 0, 1), t(2, 1), "highest", 1)
