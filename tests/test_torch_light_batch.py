"""The batched light bake held against the JAX package and against the
one-direction route it replaced, on the CPU: the direction table, the
light volume and the shadows' gradient through one batched sweep each way
(f64 1e-12, f32 1e-5 against the JAX package's scan path; bit for bit
against a sum of one-direction sweeps), the batched wrappers' twins, the
numpy twin of the cluster kernel's map of a plane over its CTAs (every
cell kept once, every tap read from the CTA that keeps it), and the lit
grid's one-pass assembly (``kernels.light_apply``): which calls take it,
the fallback's count, its twin against ``apply_lighting`` and its
wrapper's checks of the taus' layouts; and the shadow route (the
undetached bake as one autograd function): its backward through the twins
of K11 and K12 against autograd of the ATen passes, which calls take it,
and its wrappers' checks."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.io.synth import smoke_sphere
from tpuvr.ops import lighting as jlight
from tpuvr_torch.config import LightingConfig
from tpuvr_torch.kernels import light_apply as tkla
from tpuvr_torch.kernels import lighting as tklight
from tpuvr_torch.ops import lighting as tlight
from tpuvr_torch.utils import trace

N = 10
TOL = {"float64": 1e-12, "float32": 1e-5}
UPS = [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0.3, -0.5, 0.8)]


def _grid(dtype, n=N):
    return np.array(smoke_sphere(n, dtype=jnp.dtype(dtype)))


def _cfg(n_samples=16, up=(0.0, 0.0, 1.0), detach=True, jax_side=False):
    cls = JLightingConfig if jax_side else LightingConfig
    return cls(mode="lightvolume", n_samples=n_samples, up=up, detach=detach)


def _one_direction_volume(sigma, cfg):
    """The light volume as the parent built it: one autograd function and
    one sweep a direction, summed in the table's order."""
    total = torch.zeros_like(sigma)
    for w in tlight.hemisphere_dirs(cfg.n_samples, cfg.up):
        total = total + torch.exp(-tlight._directional_tau(sigma, w))
    return (cfg.sky_intensity / cfg.n_samples) * total


@pytest.mark.parametrize("n_samples", [4, 16])
@pytest.mark.parametrize("up", UPS)
def test_direction_table_matches_the_jax_setup(monkeypatch, n_samples, up):
    """Each row (axis, flip, d_y, d_x, dt) against what the JAX package's
    ``_directional_tau`` hands its sweep: the shift and dt it passes to the
    tau op, and the layout (axis, flip) read off a stand-in op that
    returns each voxel's index in the layout it was given."""
    seen = []

    def op(d_y, d_x, dt, precision):
        seen.append((d_y, d_x, dt))
        return lambda sig_p: jnp.arange(sig_p.size, dtype=jnp.float64
                                        ).reshape(sig_p.shape)

    monkeypatch.setattr(jlight, "_tau_op", op)
    shape = (5, 6, 7)
    table = tlight.direction_table(_cfg(n_samples, up))
    dirs = tlight.hemisphere_dirs(n_samples, up)
    assert len(table) == len(dirs) == n_samples
    for w, (axis, flip, d_y, d_x, dt) in zip(dirs, table):
        got = np.asarray(jlight._directional_tau(
            jnp.zeros(shape, jnp.float64), w, impl="pallas"))
        assert seen[-1] == (d_y, d_x, dt)
        perm = tlight.GRID_PERM[axis][:3]
        idx = np.arange(np.prod(shape), dtype=np.float64).reshape(
            np.transpose(np.zeros(shape), perm).shape)
        if flip:
            idx = idx[::-1]
        np.testing.assert_array_equal(got, np.transpose(idx,
                                                        np.argsort(perm)))
        assert max(abs(d_y), abs(d_x)) <= 1.0


@pytest.mark.parametrize("up", UPS)
def test_direction_table_is_what_one_direction_uses(monkeypatch, up):
    """``_directional_tau`` sweeps each direction with the table's shift
    and dt (a spy on its autograd function)."""
    seen = []
    real = tlight._Tau.apply

    def spy(sig_p, d_y, d_x, dt, precision):
        seen.append((d_y, d_x, dt))
        return real(sig_p, d_y, d_x, dt, precision)

    monkeypatch.setattr(tlight._Tau, "apply", spy)
    cfg = _cfg(16, up)
    sig = torch.as_tensor(_grid("float32")[..., 0])
    for w in tlight.hemisphere_dirs(cfg.n_samples, cfg.up):
        tlight._directional_tau(sig, w)
    assert seen == [row[2:] for row in tlight.direction_table(cfg)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("up", [(0.0, 0.0, 1.0), (0.3, -0.5, 0.8)])
def test_light_volume_and_its_gradient_match_jax(dtype, up):
    """The batched route's L and dL/dsigma against the JAX package's scan
    path and its autodiff."""
    sig = _grid(dtype)[..., 0] - 0.02  # some voxels below 0: the relu mask
    ct = np.random.default_rng(6).normal(size=sig.shape).astype(dtype)
    ref, vjp = jax.vjp(lambda s: jlight.light_volume(
        s, _cfg(16, up, jax_side=True), impl="xla"), jnp.asarray(sig))
    (ref_grad,) = vjp(jnp.asarray(ct))
    s = torch.as_tensor(sig).requires_grad_(True)
    out = tlight.light_volume(s, _cfg(16, up), device="cpu")
    (out * torch.as_tensor(ct)).sum().backward()
    tol = TOL[dtype]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(s.grad.numpy(), ref_grad, rtol=0,
                               atol=tol * np.abs(ref_grad).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_samples", [4, 16])
def test_light_volume_bits_equal_one_direction_route(dtype, n_samples):
    """L and dL/dsigma from the batched route equal, bit for bit, those of
    a sweep and an autograd function a direction (autograd adds the
    directions' gradients from the last to the first; the batched
    backward sums in that order)."""
    sig = _grid(dtype)[..., 0] - 0.02
    ct = torch.as_tensor(
        np.random.default_rng(7).normal(size=sig.shape).astype(dtype))
    cfg = _cfg(n_samples)
    outs = []
    for fn in (lambda s: tlight.light_volume(s, cfg, device="cpu"),
               lambda s: _one_direction_volume(s, cfg)):
        s = torch.as_tensor(sig).clone().requires_grad_(True)
        ell = fn(s)
        (ell * ct).sum().backward()
        outs.append((ell.detach(), s.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_apply_lighting_shadow_gradients_bits_equal_one_direction_route(
        dtype):
    """``apply_lighting(detach=False)``: the lit grid and its gradient
    equal those of the one-direction route bit for bit, and match the
    JAX package's ``jax.grad``."""
    grid = _grid(dtype)
    grid[..., 0] -= 0.02
    wts = np.random.default_rng(8).normal(size=grid.shape).astype(dtype)
    cfg = _cfg(16, detach=False)
    ref = np.asarray(jax.grad(lambda g: jnp.sum(jlight.apply_lighting(
        g, _cfg(16, detach=False, jax_side=True), impl="xla") * wts))(
            jnp.asarray(grid)))
    outs = []
    for one in (False, True):
        g = torch.as_tensor(grid).clone().requires_grad_(True)
        sigma = g[..., 0]
        ell = (_one_direction_volume(sigma, cfg) if one
               else tlight.light_volume(sigma, cfg, device="cpu"))
        lit = torch.cat([g[..., :1], g[..., 1:4] * ell[..., None]], dim=-1)
        if not one:
            assert torch.equal(lit, tlight.apply_lighting(g, cfg))
        (lit * torch.as_tensor(wts)).sum().backward()
        outs.append((lit.detach(), g.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    np.testing.assert_allclose(outs[0][1].numpy(), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())


def _rows(seed=9):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.normal(size=(6, 7, 9)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(5, 9, 7)).astype(np.float32))
    return [(a, False, 0.37, -0.81, 1.3), (a, True, -1.0, 0.25, 1.5),
            (b, True, 0.2, 1.0, 1.1)]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_batched_twins_are_one_direction_twins(precision):
    """On the CPU the batched wrappers run the twins a direction (a flipped
    row walks its field's planes in reverse) and launch nothing."""
    rows = _rows()
    before = (sum(tklight.launches.values()),
              sum(tklight.adj_launches.values()))
    taus = tklight.tau_sweep_dirs(rows, precision)
    ds = tklight.tau_sweep_adj_dirs(rows, precision)
    assert before == (sum(tklight.launches.values()),
                      sum(tklight.adj_launches.values()))
    for (field, flip, d_y, d_x, dt), tau, d in zip(rows, taus, ds):
        kw = dict(d_y=d_y, d_x=d_x, dt=dt, precision=precision)
        f = field.flip(0) if flip else field
        want = tklight.tau_sweep_torch(f, **kw)
        want_d = tklight.tau_sweep_adj_torch(f, **kw)
        assert torch.equal(tau, want.flip(0) if flip else want)
        assert torch.equal(d, want_d.flip(0) if flip else want_d)
        assert bool((tau[0 if flip else -1] == 0).all())


# Shared bytes a block may opt into on the H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KiB); the C entry reads it
# from the card.
H100_SHARED = 232448


def _fits(plan):
    """Whether the C entry takes the plane at this cluster size on the
    H100: a suitable shape within the card's shared memory a block."""
    return plan["ok"] and plan["smem"] <= H100_SHARED


_PLANES = [(8, 8), (9, 13), (20, 20), (37, 23), (100, 64), (128, 128),
           (255, 257), (256, 256), (300, 300), (512, 512), (7, 1000)]


@pytest.mark.parametrize("plane", _PLANES)
@pytest.mark.parametrize("n", tklight.CLUSTERS)
def test_cluster_map_covers_the_plane(plane, n):
    """Every cell of the plane is kept by exactly one (CTA, thread, slot),
    and every tap of a CTA's rows (|d| <= 1, f32 positions) inside the
    plane lies in its own rows or in its halo rows (one below, two above),
    each of which the neighbour that writes it keeps as its last row or its
    first two."""
    n_y, n_x = plane
    plan = tklight.cluster_plan(n_y, n_x, n)
    if not _fits(plan):
        assert (plan["by"] < 1 or plan["rows"] < 2
                or plan["smem"] > H100_SHARED)
        return
    for d_y in (-1.0, -0.73, -1e-9, 0.0, 0.5, 0.999, 1.0):
        ctas = tklight.cluster_map(n_y, n_x, n, d_y)
        seen = np.zeros((n_y, n_x), np.int64)
        rows = np.zeros(n_y, np.int64)
        for c in ctas:
            rows[c["r0"]:c["r0"] + c["own"]] += 1
            kept = c["cells"].reshape(-1, 2)
            kept = kept[kept[:, 0] >= 0]
            np.add.at(seen, (kept[:, 0], kept[:, 1]), 1)
            assert len(kept) <= tklight.THREADS * plan["cells"]
            mine = set(range(c["r0"], c["r0"] + c["own"]))
            for t_row in c["taps"][c["inside"]].tolist():
                if t_row in mine:
                    continue
                writer = ctas[c["halo"][t_row]]
                local = t_row - writer["r0"]
                assert 0 <= local < writer["own"]
                assert local in (0, 1, plan["rows"] - 1)
        assert (rows == 1).all()
        assert (seen == 1).all()


def test_cluster_route_capacity():
    """The planes the cluster route takes on the H100: c3's and the lit
    fit's planes (256^2, 128^2) at every size, c5's 512^2 planes only at 16
    (the largest square plane is 535^2), a plane wider than a block's
    threads or cut into strips of one row at none (the plane loop). The
    size the C entry chooses among them is held on the card
    (tests/test_torch_cuda.py)."""
    def sizes(n_y, n_x):
        return [n for n in tklight.CLUSTERS
                if _fits(tklight.cluster_plan(n_y, n_x, n))]

    assert sizes(256, 256) == [4, 8, 16]
    assert sizes(128, 128) == [4, 8, 16]
    assert sizes(512, 512) == [16]
    assert sizes(535, 535) == [16]
    assert sizes(536, 536) == []
    assert sizes(8, 1100) == []
    assert sizes(4, 40) == []  # strips of one row
    assert tklight.cluster_plan(128, 128, 4)["rows"] == 32
    assert tklight.cluster_plan(128, 128, 4)["by"] == 8


class _OnCard:
    """A CPU tensor that says it lies on the card: for the route rule of
    ``apply_lighting`` alone, which reads the grid's attributes."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _route_case(case):
    """(grid, cfg, detach) of a route case on a 6x7x5 float32 grid."""
    grid = torch.as_tensor(_grid("float32", 7)[:6, :, :5]).contiguous()
    cfg = _cfg(4)
    detach = True
    if case == "no_detach":
        detach = False
    elif case == "persample":
        cfg = LightingConfig(mode="persample", n_samples=2, secondary_dt=2.0)
    elif case == "many":
        cfg = _cfg(tkla.MAX_DIRS + 1)
    elif case == "float64":
        grid = grid.double()
    elif case == "strided":
        grid = grid.transpose(0, 1)
    elif case == "offset":
        grid = torch.cat([grid.new_zeros(1), grid.reshape(-1)])[1:].view(
            grid.shape)
    return grid, cfg, detach


@pytest.mark.parametrize("case", ["card", "cpu", "no_detach", "persample",
                                  "many", "float64", "strided", "offset"])
def test_one_pass_takes_a_detached_float32_bake_on_the_card(case,
                                                           monkeypatch):
    """``apply_lighting`` takes K9/K10 for a detached 'lightvolume' bake of
    a float32 grid on the card, in any layout and with any number of
    directions, and for an undetached one whose grid takes no gradient
    (the same function), and the ATen passes, counted once, for every
    other grid and configuration. The grids here say they lie on the card;
    the kernels' place is taken by their twin."""
    grid, cfg, detach = _route_case(case)
    takes = tkla.takes
    assert takes(grid if case == "cpu" else _OnCard(grid)) == (
        case not in ("cpu", "float64"))
    monkeypatch.setattr(tkla, "takes", lambda g: takes(
        g if case == "cpu" else _OnCard(g)))
    calls = []

    def kernels(*args):
        calls.append(args[0])
        return tkla.light_apply_torch(*args)

    monkeypatch.setattr(tlight, "light_apply", kernels)
    before = tkla.launches.copy()
    lit = tlight.apply_lighting(grid, cfg, detach=detach)
    one_pass = case in ("card", "no_detach", "many", "strided", "offset")
    assert len(calls) == one_pass
    assert dict(tkla.launches - before) == ({} if one_pass
                                            else {"fallback": 1})
    ell = (tlight.light_volume_exact(grid[..., 0], cfg)
           if cfg.mode == "persample"
           else tlight.light_volume(grid[..., 0], cfg, device="cpu"))
    assert torch.equal(lit, tkla.lit_grid_torch(grid, ell))


@pytest.mark.parametrize("case", ["cpu", "no_detach", "persample",
                                  "float64"])
def test_each_aten_route_counts_one_fallback(case):
    """A call that takes the ATen passes counts one ``light_apply_fallback``
    and launches nothing, and its lit grid is the light volume times the
    emission."""
    grid, cfg, detach = _route_case(case)
    before = trace.launch_counts()
    lit = tlight.apply_lighting(grid, cfg, detach=detach)
    counts = trace.launch_counts() - before
    assert {k: v for k, v in counts.items()
            if k.startswith("light_apply_")} == {"light_apply_fallback": 1}
    ell = (tlight.light_volume_exact(grid[..., 0], cfg)
           if cfg.mode == "persample"
           else tlight.light_volume(grid[..., 0], cfg, device="cpu"))
    assert torch.equal(lit[..., 0], grid[..., 0])
    assert torch.equal(lit[..., 1:], grid[..., 1:] * ell[..., None])


def test_light_apply_counters_in_launch_counts():
    assert {"light_apply_fwd", "light_apply_bwd", "light_apply_shadow_bwd",
            "light_apply_mask",
            "light_apply_fallback"} <= set(trace.launch_counts())


@pytest.mark.parametrize("n_samples", [4, 16])
@pytest.mark.parametrize("up", UPS)
def test_light_apply_twin_bits_equal_apply_lighting(n_samples, up):
    """``light_apply``'s twin of the batched sweep's taus gives
    ``apply_lighting``'s lit grid and grid gradient bit for bit, and the
    wrapper's checks take the taus' layouts as the sweeps return them."""
    grid = _grid("float32")
    grid[..., 0] -= 0.02
    wts = torch.as_tensor(
        np.random.default_rng(10).normal(size=grid.shape).astype(np.float32))
    cfg = _cfg(n_samples, up)
    table = tlight.direction_table(cfg)
    axes = [row[0] for row in table]
    outs = []
    for one_pass in (True, False):
        g = torch.as_tensor(grid).clone().requires_grad_(True)
        if one_pass:
            taus = tlight._TauDirs.apply(g[..., 0].detach(), table,
                                         "highest")
            tkla._check(g, taus, axes)
            lit = tkla.light_apply_torch(
                g, taus, axes, cfg.sky_intensity / cfg.n_samples)
        else:
            lit = tlight.apply_lighting(g, cfg)
        (lit * wts).sum().backward()
        outs.append((lit.detach(), g.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("bad", ["grid_shape", "grid_dtype", "grid_strided",
                                 "tau_layout", "tau_grad", "count",
                                 "none"])
def test_light_apply_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper's checks, which run before a launch: a contiguous
    float32 (Z, Y, X, 4) grid, one contiguous float32 tau a direction in
    its sweep axis's layout ((X, Y, Z), (Y, Z, X), (Z, Y, X)), at least
    one, and no gradient to the taus. More than 64 directions pass: they
    take one launch a run of 64."""
    grid = torch.rand(4, 5, 6, 4)
    table = tlight.direction_table(_cfg(16, (0.3, -0.5, 0.8)))
    axes = [row[0] for row in table]
    assert set(axes) == {0, 1, 2}
    taus = list(tlight._TauDirs.apply(grid[..., 0], table, "highest"))
    tkla._check(grid, taus, axes)
    tkla._check(grid, taus * 5, axes * 5)
    match = {"grid_shape": "(Z, Y, X, 4)", "grid_dtype": "float32",
             "grid_strided": "contiguous", "tau_layout": "sweep axis",
             "tau_grad": "no gradient", "count": "one tau a direction",
             "none": "at least one"}[bad]
    if bad == "grid_shape":
        grid = grid[..., :3].contiguous()
    elif bad == "grid_dtype":
        grid = grid.double()
    elif bad == "grid_strided":
        grid = grid.transpose(0, 2)
    elif bad == "tau_layout":
        i = axes.index(0)  # an x-sweep tau handed over in (Z, Y, X)
        taus[i] = taus[i].permute(tkla.grid_order(0)).contiguous()
    elif bad == "tau_grad":
        taus[0] = taus[0].clone().requires_grad_(True)
    elif bad == "count":
        taus = taus[:-1]
    else:
        taus, axes = [], []
    with pytest.raises(ValueError, match=match):
        tkla._check(grid, taus, axes)


def test_light_apply_refuses_a_grid_off_the_card():
    """The kernels' wrapper runs nothing on the CPU or in float64: there
    ``light_apply_torch`` is the route."""
    grid = torch.rand(4, 5, 6, 4)
    table = tlight.direction_table(_cfg(4))
    taus = tlight._TauDirs.apply(grid[..., 0], table, "highest")
    axes = [row[0] for row in table]
    for g in (grid, _OnCard(grid.double())):
        assert not tkla.takes(g)
    with pytest.raises(ValueError, match="on the card"):
        tkla.light_apply(grid, taus, axes, 0.25)


# The shadow route (``ops.lighting._Shadow``): K2 and K9 forward, K11, K4
# and K12 backward on the card. Here the kernels' places are taken by their
# twins, which hold the route to autograd of the ATen passes.

# (n_samples, up): one direction along each sweep axis (x, y, z: flipped),
# then tables over all three.
SHADOW_CASES = [(1, (0.0, 0.0, 1.0)), (1, (-0.6, 0.7, 0.1)),
                (1, (1.0, 0.0, 0.0)), (4, (0.3, -0.5, 0.8)),
                (16, (0.0, 0.0, 1.0)), (16, (-0.9, 0.1, 0.3))]


@pytest.fixture
def shadow_twins(monkeypatch):
    """The shadow route's kernels (K9, K11, K12), and the detached route's
    (K9 and K10), replaced by their twins; K2 and K4 take theirs for CPU
    tensors."""
    for name, twin in (("light_apply", tkla.light_apply_torch),
                       ("light_apply_fwd", tkla.light_apply_torch),
                       ("shadow_cotangents", tkla.shadow_cotangents_torch),
                       ("mask_sum", tkla.mask_sum_torch)):
        monkeypatch.setattr(tlight, name, twin)


@pytest.mark.parametrize("softplus", [False, True], ids=["raw", "softplus"])
@pytest.mark.parametrize("n_samples,up", SHADOW_CASES)
def test_shadow_twins_bits_equal_autograd(shadow_twins, n_samples, up,
                                          softplus):
    """The shadow route through the twins of K9, K11 and K12 gives the lit
    grid, and the gradient of the parameters (raw, with densities below 0
    that the relu masks cut, or through softplus), of autograd through
    ``_TauDirs``, ``light_value_torch`` and ``lit_grid_torch`` bit for bit,
    with one ``light_shadow_adjoint``."""
    from tpuvr_torch.train.fit import params_to_grid

    rng = np.random.default_rng(11)
    raw = rng.uniform(0.0, 1.0, (7, 9, 11, 4)).astype(np.float32)
    raw[..., 0] = raw[..., 0] * 4.0 - 3.0 if softplus else raw[..., 0] - 0.3
    assert softplus or (raw[..., 0] < 0).any()
    wts = torch.as_tensor(rng.normal(size=raw.shape).astype(np.float32))
    cfg = _cfg(n_samples, up, detach=False)
    table = tlight.direction_table(cfg)
    axes = [row[0] for row in table]
    assert len(set(axes)) == (1 if n_samples == 1 else 3)
    scale = cfg.sky_intensity / cfg.n_samples
    outs = []
    for shadow_route in (True, False):
        p = torch.as_tensor(raw).clone().requires_grad_(True)
        grid = params_to_grid(p, softplus)
        before = tlight.shadow.copy()
        if shadow_route:
            lit = tlight._Shadow.apply(grid, table, "highest", scale)
        else:
            taus = tlight._TauDirs.apply(grid[..., 0], table, "highest")
            lit = tkla.lit_grid_torch(
                grid, tkla.light_value_torch(taus, axes, scale))
        (lit * wts).sum().backward()
        assert dict(tlight.shadow - before) == {"adjoint": 1}
        outs.append((lit.detach(), p.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("case", ["card", "strided", "offset", "cpu",
                                  "persample", "many", "float64",
                                  "no_grad"])
def test_shadow_route_takes_an_undetached_bake_with_a_gradient(
        case, monkeypatch, shadow_twins):
    """``apply_lighting(detach=False)`` takes the shadow route (no
    fallback) for a float32 grid on the card that takes a gradient, in any
    layout (a strided or misaligned grid is copied first, and its gradient
    reaches the base tensor) and with more than MAX_DIRS directions, with
    the ATen route's lit grid and gradient bit for bit; a call without a
    gradient takes K9 (``light_apply``, no shadow bake and no fallback),
    with the ATen route's lit grid; the CPU, 'persample' and float64 take
    the ATen passes, counted once as ``light_apply_fallback``. The grids
    here say they lie on the card; the kernels' places are taken by their
    twins."""
    grid, cfg, _ = _route_case("card" if case == "no_grad" else case)
    takes = tkla.takes
    monkeypatch.setattr(tkla, "takes", lambda g: takes(
        g if case == "cpu" else _OnCard(g)))
    wts = torch.as_tensor(np.random.default_rng(12).normal(
        size=grid.shape).astype(np.float32)).to(grid.dtype)
    shadow_route = case in ("card", "strided", "offset", "many")
    on_card = shadow_route or case == "no_grad"
    calls = []
    monkeypatch.setattr(tlight, "light_apply", lambda *args: calls.append(
        args[0]) or tkla.light_apply_torch(*args))
    outs = []
    for aten in (False, True) if on_card else (False,):
        if case == "strided":
            leaf = grid.transpose(0, 1).contiguous().requires_grad_(True)
            g = leaf.transpose(0, 1)
        elif case == "offset":
            leaf = torch.cat([grid.new_zeros(1), grid.reshape(-1)])
            leaf.requires_grad_(True)
            g = leaf[1:].view(grid.shape)
        else:
            leaf = grid.clone().requires_grad_(True)
            g = leaf
        assert (case in ("strided", "offset")) == (
            not g.is_contiguous() or g.data_ptr() % 16 != 0)
        before = trace.launch_counts()
        grad = contextlib.nullcontext() if case != "no_grad" else (
            torch.no_grad())
        with grad:
            lit = (tkla.lit_grid_torch(g, tlight.light_volume(
                g[..., 0], cfg, device="cpu")) if aten
                else tlight.apply_lighting(g, cfg, detach=False))
        if case != "no_grad":
            (lit * wts).sum().backward()
        counts = trace.launch_counts() - before
        if not aten:
            assert counts["light_apply_fallback"] == (not on_card)
            shadows = case not in ("persample", "no_grad")
            assert counts["light_shadow"] == shadows
            assert counts["light_shadow_adjoint"] == shadows
            assert len(calls) == (case == "no_grad")
        outs.append((lit.detach(), leaf.grad))
    if on_card:
        assert torch.equal(outs[0][0], outs[1][0])
        assert (outs[0][1] is outs[1][1] is None if case == "no_grad"
                else torch.equal(outs[0][1], outs[1][1]))


def test_shadow_route_backward_runs_once(shadow_twins):
    """The shadow route's backward writes the cotangents over its saved
    taus, so a second backward through a kept graph raises."""
    grid = torch.as_tensor(_grid("float32")).requires_grad_(True)
    cfg = _cfg(4, detach=False)
    lit = tlight._Shadow.apply(grid, tlight.direction_table(cfg), "highest",
                               cfg.sky_intensity / cfg.n_samples)
    loss = lit.square().sum()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="runs once"):
        loss.backward()


@pytest.mark.parametrize("bad", ["count", "tau_layout", "cotangent",
                                 "sigma"])
def test_shadow_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """K11's and K12's wrappers check before a launch: one field a
    direction, each in its sweep axis's layout, a (Z, Y, X, 4) float32
    cotangent for K11 and a (Z, Y, X) float32 sigma for K12. More than 64
    directions pass: they take one launch a run of 64."""
    grid = torch.rand(4, 5, 6, 4)
    table = tlight.direction_table(_cfg(16, (0.3, -0.5, 0.8)))
    axes = [row[0] for row in table]
    taus = list(tlight._TauDirs.apply(grid[..., 0], table, "highest"))
    g, sigma = torch.rand(grid.shape), grid[..., 0]
    tkla._check(grid, taus * 5, axes * 5)
    match = {"count": "one tau a direction", "tau_layout": "sweep axis",
             "cotangent": "cotangent must be", "sigma": "sigma must be"}[bad]
    if bad == "count":
        taus = taus[:-1]
    elif bad == "tau_layout":
        i = axes.index(0)
        taus[i] = taus[i].permute(tkla.grid_order(0)).contiguous()
    elif bad == "cotangent":
        g = g[..., :3]
    else:
        sigma = sigma[:-1]
    if bad != "sigma":
        with pytest.raises(ValueError, match=match):
            tkla.shadow_cotangents(g, grid, taus, axes, 0.25)
    if bad != "cotangent":
        with pytest.raises(ValueError, match=match):
            tkla.mask_sum(grid.clone(), taus, axes, sigma)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "reverse"])
@pytest.mark.parametrize("n", [1, 64, 65, 130])
def test_runs_split_a_table_into_launches_with_carries(n, reverse):
    """``_runs`` gives one launch a run of MAX_DIRS directions, in table
    order or (K12's) from the last run to the first, each with its fields'
    pointers, axes and count, and says which launches start from a carry
    (a run went before) and which leave one (a run comes after); a carry
    buffer exists exactly where there is more than one launch."""
    fields = [torch.zeros(1) for _ in range(n)]
    axes = [i % 3 for i in range(n)]
    runs = list(tkla._runs(fields, axes, reverse=reverse))
    starts = list(range(0, n, tkla.MAX_DIRS))
    if reverse:
        starts.reverse()
    assert len(runs) == len(starts) == -(-n // tkla.MAX_DIRS)
    for i, ((ptrs, run_axes, k), after, more) in enumerate(runs):
        d0 = starts[i]
        assert k == len(fields[d0:d0 + tkla.MAX_DIRS])
        assert list(ptrs) == [f.data_ptr() for f in fields[d0:d0 + k]]
        assert list(run_axes) == axes[d0:d0 + k]
        assert (after, more) == (i > 0, i + 1 < len(runs))
    carry = tkla._carry(torch.zeros(2, 3, 4, 4), n)
    assert (carry is None) == (len(runs) == 1)
    assert carry is None or carry.shape == (2, 3, 4)
