"""tpuvr_torch's ray data parallelism (``tpuvr_torch.dist``, the mesh
train step and ``fit_grid(mesh=...)``, the ring backward) on 4 gloo ranks
on the CPU, held against the JAX package on its 4-device CPU mesh
(``data_mesh(4)``) and against the port's single-process results.

Every port-side case runs in one start of the 4 ranks
(``tpuvr_torch.dist.launch.spawn``, module fixture ``ranks``); the cases
live in ``tpuvr_torch.dist.workers``, so a rank imports no JAX.

Tolerances (f32):
- a mesh gradient against the JAX mesh gradient: 1e-5 of max|grad|, the
  bound of the port's backward twin against the JAX scan twin
  (tests/test_torch_sweep_bwd.py), plus the all-reduce's own roundoff:
  summing 4 partial gradients in another order moves each element by at
  most 3 roundings of the running sum, 3 * 2^-24 * sum_r |g_r|;
- against the port's single-process full-rows gradient: 1e-5 of
  max|grad|: a rank samples its rows where the whole image's rows are
  (the sweep's ``row0``), so only the sums differ: each rank's rows are
  summed apart and the all-reduce adds the four partials. (The JAX
  package shifts ``by`` by ``r0 * ay`` instead, which moves each position
  and tent weight by up to an ulp of the position: 2^-20 at 16 rows here,
  but 5.5e-5 of max|grad| over c4's 256 rows on the card);
- at early_stop_eps > 0 (and with softplus): the ring against the
  backward in one call then one all-reduce, 1e-5 of max|grad| (the slabs
  thread the (T, q) carry, which holds the early-stop state, as one call
  does); the mesh gradient against the single-process twin of each rank's
  rows summed, 1e-5 of max|grad| plus the all-reduce's roundoff; against
  the single-process twin of the whole image, the derived bound of
  ``_ert_bound``: the twins stop at a per-slice maximum of T over the rows
  they hold, so a rank stops its rows no later than the whole image does;
- the lit mesh step (c5's shape: raw density, one view, the light baked
  from the current density on every rank) as the unlit one: 1e-5 of
  max|grad| against the JAX single-device step and against the JAX mesh
  step divided by 4, with ``detach`` True and False;
- images 1e-5, as the single-process render tests; losses 1e-6
  relative, as the single-device trainer tests; loss trajectories over
  several steps rtol 2e-3 (the JAX package's own bound for a mesh
  trajectory, tests/test_dist.py), every rank's bit-identical.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpuvr.config import LightingConfig as JLightingConfig
from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.config import TrainConfig as JTrainConfig
from tpuvr.dist import replicated as jdist
from tpuvr.dist.sharded_grid import grid_mesh as jgrid_mesh
from tpuvr.dist.sharded_grid import render_view_zsharded as jrender_zsharded
from tpuvr.io.synth import orbit_cameras, smoke_sphere
from tpuvr.kernels.ring_bwd import sweep_bwd_ring as jsweep_bwd_ring
from tpuvr.ops import vjp as jvjp
from tpuvr.ref.camera import OrthoCamera, look_at_perspective
from tpuvr.train import fit as jfit
from tpuvr_torch.config import LightingConfig, RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.dist.init import DataMesh, GridMesh
from tpuvr_torch.dist.replicated import render_view_dp
from tpuvr_torch.dist.retile import render_view_retiled
from tpuvr_torch.dist.sharded_grid import render_view_zsharded
from tpuvr_torch.kernels.ring_bwd import sweep_bwd_ring
from tpuvr_torch.kernels.sweep_torch import (
    sweep_fwd_torch,
    sweep_fwd_views_torch,
)
from tpuvr_torch.ops import render as trender
from tpuvr_torch.ops import vjp as tvjp
from tpuvr_torch.train import fit as tfit

WORLD = 4
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)
BUCKETS = (1, 3, 4, 64)
SWEEPS = {"one_view": (1, False), "two_views": (2, True)}
REDUCE = {"chunked": dict(bwd_chunks=2), "ring": dict(ring_chunks=2)}
STEP_MODES = {"bucketed": dict(grad_buckets=4, view_batch=True),
              "chunked": dict(bwd_chunks=2, view_batch=True),
              "ring": dict(bwd_chunks=2, grad_ring=True, view_batch=True),
              "loop": dict(grad_buckets=4, view_batch=False)}
STEPS = [("gather", m) for m in STEP_MODES] + [
    ("rows", m) for m in ("bucketed", "chunked", "ring")]
FIT_MODES = {"plain": {}, "chunked": dict(bwd_chunks=2),
             "ring": dict(bwd_chunks=2, grad_ring=True)}
FIT_CFG = dict(lr=3e-2, steps=4, views_per_batch=2, ckpt_every=0, seed=11)
# c5's lit training (tools/c5_train.py: raw density from a faint fog, one
# view a step, two steps a view group), its 16 sky directions cut to 4.
C5_FIT_CFG = dict(lr=3e-2, steps=4, views_per_batch=1, ckpt_every=0,
                  density_softplus=False, steps_per_call=2, seed=0)
LIT = {"detached": True, "shadows": False}
# The ring and the mesh gradient with early ray termination and softplus,
# on a 2-view reverse batch whose density is raised so that rays stop.
ERT = {"ert": dict(eps=0.1), "softplus": dict(softplus=True),
       "ert_softplus": dict(eps=0.1, softplus=True)}


def _tcam(jcam):
    return camera_from_fields(type(jcam).__name__, **dataclasses.asdict(jcam))


class _env:
    """Environment variables set (None: unset) for a ``with`` block."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        for k, v in self.env.items():
            workers._set_env(k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            workers._set_env(k, v)


def _render_cams(n=12, res=16):
    c = (n - 1) / 2.0
    return [OrthoCamera(center=(c, c, -3.0 * n), forward=(0.0, 0.0, 1.0),
                        up=(0.0, 1.0, 0.0), width=1.5 * n, height=1.5 * n,
                        res_x=res, res_y=res),
            look_at_perspective((c, c - 3.0 * n, c + 0.8 * n), (c, c, c),
                                res_x=res, res_y=res)]


def _render_grid():
    return np.asarray(smoke_sphere(12), np.float32)


def _sweep_inputs(views, reverse, seed=0, s=8, n_y=11, n_x=12, n_v=16,
                  n_u=10, dense=False):
    """A random slab, geometry and cotangents as f32 numpy: coefficients
    and enables (S,) for one view, else (views, S); dt (views, V, U);
    cotangents (3, views, V, U) and (views, V, U); one slice disabled.
    ``dense`` adds 0.6 to the density, so that rays reach T < 0.1."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lead = () if views == 1 else (views,)
    coeffs = tuple(rng.uniform(lo, hi, lead + (s,)).astype(f)
                   for lo, hi in ((0.6, 1.3), (-2.0, 3.0), (0.6, 1.3),
                                  (-2.0, 3.0)))
    en = np.ones(lead + (s,), f)
    en[..., rng.integers(1, s - 1)] = 0.0
    grid_sc = (rng.random((s, 4, n_y, n_x)) * 0.6).astype(f)
    if dense:
        grid_sc[:, 0] += 0.6
    return dict(grid_sc=grid_sc, coeffs=coeffs, enables=en,
                dt=rng.uniform(0.5, 1.5, (views, n_v, n_u)).astype(f),
                d_rgb=rng.normal(size=(3, views, n_v, n_u)).astype(f),
                d_t=rng.normal(size=(views, n_v, n_u)).astype(f),
                views=views, reverse=reverse)


def _train_scene():
    """Three perspective views of a 16^3 smoke sphere at 16^2: one view
    group (so both trainers choose the fused mode unless told not to)."""
    n = 16
    gt = np.array(smoke_sphere(n))
    c = (n - 1) / 2.0
    jcams = [look_at_perspective((c + dx, c - 3.0 * n, c + 0.4 * n),
                                 (c, c, c), res_x=16, res_y=16)
             for dx in (-2.0, 0.0, 2.0)]
    targets = np.array(jfit.render_all_views(gt, jcams, JRCFG))
    return gt.shape, jcams, [_tcam(j) for j in jcams], targets


def _rows_scene(n=64):
    """The row-warp trainer tests' half scene (tests/test_torch_warp.py):
    a 16 x n x n grid seen by two cameras at n^2, one view group that gets
    a row plan."""
    rng = np.random.default_rng(11)
    gshape = (16, n, n, 4)
    gt = rng.random(gshape, dtype=np.float32) * 0.4
    c = (7.5, (n - 1) / 2, (n - 1) / 2)
    s = n / 128
    jcams = [look_at_perspective((c[2] + dx * s, c[1], -300.0 * s),
                                 (c[2], c[1], c[0]), res_x=n, res_y=n)
             for dx in (-12.0, 15.0)]
    targets = np.asarray(jfit.render_all_views(jnp.asarray(gt), jcams, JRCFG,
                                               impl="xla"))
    return gshape, jcams, [_tcam(j) for j in jcams], targets


def _c5_scene(n=16):
    """c5's four orbit views cut to an n^3 smoke sphere at n^2 (four view
    groups of one view, n intermediate rows each), lit targets rendered
    by the JAX package as ``tools/c5_train.py`` renders them."""
    gt = smoke_sphere(n)
    jcams = orbit_cameras(4, n, res=n)
    targets = np.array(jfit.render_views_grouped(
        gt, jcams, JRCFG, impl="xla", lighting=_lights(True)[1]))
    return gt.shape, jcams, [_tcam(j) for j in jcams], targets


def _lights(detach):
    """(port, JAX) configs of c5's sky light at 4 directions."""
    return (LightingConfig(mode="lightvolume", n_samples=4, detach=detach),
            JLightingConfig(mode="lightvolume", n_samples=4, detach=detach))


def _fog(shape, seed=None):
    """tools/c5_train.py's fog (density 0.01, emission 0.5); with a seed
    perturbed by N(0, 0.02), so that some densities are negative and the
    relus of the sweep's and the tau sweeps' samples cut some gradients."""
    fog = workers.fog_params(shape, "cpu").numpy()
    if seed is None:
        return fog
    rng = np.random.default_rng(seed)
    return fog + rng.normal(0.0, 0.02, shape).astype(np.float32)


def _lit_step_inputs(scene, detach):
    """The first view group's view of the c5 scene, from the perturbed
    fog, lit, with raw density."""
    gshape, _, tcams, targets = scene
    key, (idxs, stacked, _, _) = sorted(tfit.group_views(
        tcams, gshape, n_shards=WORLD).items())[0]
    return dict(key=key, n_views=1, render_cfg=RCFG,
                stacked={k: v.numpy() for k, v in stacked.items()},
                targets=targets[idxs], params=_fog(gshape, seed=7),
                pick=np.zeros(1, np.int64), r0s=np.zeros(1, np.int32),
                density_softplus=False, lighting=_lights(detach)[0])


def _raw_params(shape, seed=5):
    rng = np.random.default_rng(seed)
    return (np.array(jfit.init_params(shape, True))
            + rng.normal(0.0, 0.3, shape).astype(np.float32))


def _warp_env(warp):
    return {"TPUVR_WARP": "rows" if warp == "rows" else None}


def _step_inputs(scene, warp):
    """Both views of the scene's one group under ``warp`` ("gather" or
    "rows"): stacked geometry (numpy), targets, raw parameters, the pick
    and the group's row plan."""
    gshape, _, tcams, targets = scene
    with _env(_warp_env(warp)):
        (key, (idxs, stacked, _, plan)), = tfit.group_views(
            tcams, gshape, n_shards=WORLD).items()
    assert (plan is not None) == (warp == "rows")
    return dict(key=key, n_views=2, render_cfg=RCFG,
                stacked={k: v.numpy() for k, v in stacked.items()},
                targets=targets[idxs], params=_raw_params(gshape),
                pick=np.array([1, 0]), r0s=np.zeros(2, np.int32),
                warp_tiling=plan)


@pytest.fixture(scope="module")
def scenes():
    return {"gather": _train_scene(), "rows": _rows_scene(),
            "c5": _c5_scene()}


def _cases(scenes, tmp):
    per_rank = np.random.default_rng(4).normal(
        size=(WORLD, 10, 3, 5)).astype(np.float32)
    cases = [(f"all_reduce_{b}", workers.all_reduce_case,
              dict(per_rank=per_rank, n_buckets=b), {}) for b in BUCKETS]
    for i, jcam in enumerate(_render_cams()):
        cases.append((f"render_{i}", workers.render_case,
                      dict(grid=_render_grid(), cam=_tcam(jcam), cfg=RCFG),
                      {}))
    for name, (views, reverse) in SWEEPS.items():
        for mode, kw in REDUCE.items():
            cases.append((f"sweep_{name}_{mode}", workers.sweep_grad_case,
                          dict(_sweep_inputs(views, reverse), **kw), {}))
    ring_in = _sweep_inputs(2, True, seed=3)
    cases.append(("ring_vs_one_call", workers.ring_case, dict(
        grid_sc=ring_in["grid_sc"], coeffs=ring_in["coeffs"],
        enables=ring_in["enables"], dt=ring_in["dt"].reshape(-1, 10),
        views=2, reverse=True, ring_chunks=2, seed=9), {}))
    ring_dense = _sweep_inputs(2, True, seed=3, dense=True)
    for tag, kw in ERT.items():
        cases.append((f"ring_vs_one_call_{tag}", workers.ring_case, dict(
            grid_sc=ring_dense["grid_sc"], coeffs=ring_dense["coeffs"],
            enables=ring_dense["enables"],
            dt=ring_dense["dt"].reshape(-1, 10), views=2, reverse=True,
            ring_chunks=2, seed=9, **kw), {}))
        cases.append((f"sweep_ring_{tag}", workers.sweep_grad_case, dict(
            _sweep_inputs(2, True, dense=True), ring_chunks=2, **kw), {}))
    for warp, mode in STEPS:
        cases.append((f"step_{warp}_{mode}", workers.step_case,
                      dict(_step_inputs(scenes[warp], warp),
                           **STEP_MODES[mode]), {}))
    for tag, detach in LIT.items():
        cases.append((f"step_lit_{tag}", workers.step_case,
                      _lit_step_inputs(scenes["c5"], detach), {}))
    gshape, _, tcams, targets = scenes["c5"]
    cases.append(("fit_lit", workers.fit_case, dict(
        targets=targets, cams=tcams, grid_shape=gshape,
        cfg=TrainConfig(**C5_FIT_CFG), render_cfg=RCFG,
        lighting=_lights(True)[0], params_init=_fog(gshape),
        run_dir=str(tmp / "lit")), {}))
    gshape, _, tcams, targets = scenes["gather"]
    for mode, kw in FIT_MODES.items():
        for fused in (False, True):
            cases.append((f"fit_{mode}_{fused}", workers.fit_case,
                          dict(targets=targets, cams=tcams, grid_shape=gshape,
                               cfg=TrainConfig(**FIT_CFG), render_cfg=RCFG,
                               fused=fused, run_dir=str(tmp / f"{mode}{fused}"),
                               **kw), {}))
    return cases


@pytest.fixture(scope="module")
def ranks(scenes, tmp_path_factory):
    """Every port-side case on 4 gloo ranks, in one spawn; a rank that
    fails or hangs fails here (timeout 240 s)."""
    run_dir = tmp_path_factory.mktemp("dist")
    out = launch.spawn(workers.run_suite, WORLD, "gloo", "cpu",
                       (_cases(scenes, run_dir),), timeout_s=240)
    out[0]["fit_run_dir"] = run_dir
    return out


def _check_grad(got, ref, extra=0.0):
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale + extra)


def _reduce_roundoff(partials):
    """3 roundings of the running sum of 4 partials, per element."""
    return 3 * 2.0**-24 * float(np.abs(np.stack(partials)).sum(0).max())


@pytest.mark.parametrize("n_buckets", BUCKETS)
def test_bucketed_all_reduce_equals_one_all_reduce(ranks, n_buckets):
    per_rank = np.random.default_rng(4).normal(
        size=(WORLD, 10, 3, 5)).astype(np.float32)
    tol = _reduce_roundoff(list(per_rank))
    for r in range(WORLD):
        bucketed, one = ranks[r][f"all_reduce_{n_buckets}"]
        # gloo may sum a bucket in another order than the whole tensor.
        np.testing.assert_allclose(bucketed, one, rtol=0, atol=2 * tol)
        np.testing.assert_allclose(one, per_rank.sum(0), rtol=0, atol=tol)
        np.testing.assert_array_equal(bucketed,
                                      ranks[0][f"all_reduce_{n_buckets}"][0])


@pytest.mark.parametrize("cam", [0, 1], ids=["ortho", "perspective"])
def test_render_view_dp_matches_jax_and_one_process(ranks, devices8, cam):
    jcam = _render_cams()[cam]
    grid = _render_grid()
    j_rgb, j_t = jdist.render_view_dp(jnp.asarray(grid), jcam,
                                      jdist.data_mesh(WORLD), JRCFG,
                                      impl="xla")
    t_rgb, t_t = trender.render_view(torch.as_tensor(grid), _tcam(jcam),
                                     RCFG, device="cpu")
    for r in range(WORLD):
        rgb, t = ranks[r][f"render_{cam}"]
        for got, j_ref, t_ref in ((rgb, j_rgb, t_rgb), (t, j_t, t_t)):
            np.testing.assert_allclose(got, np.asarray(j_ref), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got, t_ref.numpy(), rtol=0, atol=1e-5)
    assert float(np.abs(ranks[0][f"render_{cam}"][0]).max()) > 0.01


@functools.lru_cache(maxsize=None)
def _jax_mesh_grad(name):
    """JAX ``sweep_op(ring=("data", 4, 2))`` on its CPU mesh (the ring's
    XLA twin: each device's backward, then a psum) for the inputs of
    ``SWEEPS[name]``, every device's copy."""
    inp = _sweep_inputs(*SWEEPS[name])
    v_l = inp["dt"].shape[1] // WORLD
    op = jvjp.sweep_op(inp["reverse"], 1.0, 0.0, "xla", views=inp["views"],
                       ring=("data", WORLD, 2))

    def body(g, ay, by, ax, bx, en, dt, d_rgb, d_t):
        off = (jax.lax.axis_index("data") * v_l).astype(jnp.float32)
        coeffs = (ay, by + off * ay, ax, bx)
        _, vjp = jax.vjp(
            lambda x: op(x, coeffs, en, dt.reshape(-1, dt.shape[-1])), g)
        (grad,) = vjp((d_rgb.reshape(3, -1, d_rgb.shape[-1]),
                       d_t.reshape(-1, d_t.shape[-1])))
        return grad[None]

    out = jax.shard_map(
        body, mesh=jdist.data_mesh(WORLD),
        in_specs=(P(),) * 6 + (P(None, "data", None),
                               P(None, None, "data", None),
                               P(None, "data", None)),
        out_specs=P("data"), check_vma=False,
    )(*map(jnp.asarray, (inp["grid_sc"], *inp["coeffs"], inp["enables"],
                         inp["dt"], inp["d_rgb"], inp["d_t"])))
    return np.asarray(out)


def _port_rows_grad(inp, r0, r1, row0=False, eps=0.0, softplus=False):
    """The port's single-process gradient of rows [r0, r1) of every view,
    swept with ``by`` shifted by ``r0 * ay`` or, with ``row0``, at the
    whole image's positions; ``eps`` and ``softplus`` as the sweep op's."""
    ay, by, ax, bx = map(torch.as_tensor, inp["coeffs"])
    op = tvjp.sweep_op(inp["reverse"], 1.0, eps, "torch", views=inp["views"],
                       row0=r0 if row0 else 0, softplus=softplus)
    g = torch.as_tensor(inp["grid_sc"]).requires_grad_(True)
    by = by if row0 else by + r0 * ay
    rgb, t = op(g, (ay, by, ax, bx), torch.as_tensor(inp["enables"]),
                torch.as_tensor(inp["dt"][:, r0:r1]).flatten(0, 1))
    (grad,) = torch.autograd.grad((rgb, t), g, (
        torch.as_tensor(inp["d_rgb"][:, :, r0:r1]).flatten(1, 2),
        torch.as_tensor(inp["d_t"][:, r0:r1]).flatten(0, 1)))
    return grad.numpy()


@pytest.mark.parametrize("mode", sorted(REDUCE))
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_mesh_sweep_grad_matches_jax_and_one_process(ranks, devices8, name,
                                                     mode):
    """``sweep_op`` over the mesh, its gradient summed slab by slab in
    stream order (``bwd_chunks=2, mesh=``) or through the ring backward
    (``ring=(mesh, 4, 2)``), on one view and on a 2-view batch (a reverse
    sweep), on every rank."""
    inp = _sweep_inputs(*SWEEPS[name])
    ref = _jax_mesh_grad(name)
    for d in range(1, WORLD):
        np.testing.assert_array_equal(ref[d], ref[0])
    n_v = inp["dt"].shape[1]
    v_l = n_v // WORLD
    partials = [_port_rows_grad(inp, r * v_l, (r + 1) * v_l)
                for r in range(WORLD)]
    whole = _port_rows_grad(inp, 0, n_v)
    for r in range(WORLD):
        got = ranks[r][f"sweep_{name}_{mode}"]
        _check_grad(got, ref[0], _reduce_roundoff(partials))
        _check_grad(got, whole)
        np.testing.assert_array_equal(got, ranks[0][f"sweep_{name}_{mode}"])


def test_ring_backward_matches_one_call_and_one_all_reduce(ranks):
    """The ring backward's slab loop, on the CPU over the backward twin,
    against the backward in one call then one all-reduce (a reverse 2-view
    batch, 2 slabs): 1e-5 of max|grad| (the slabs thread the carry as one
    call does, and a reduction order's few roundings of the 4 partials lie
    far below it); one all-reduce a slab, and no kernel launch on the
    CPU."""
    for r in range(WORLD):
        got, ref, counts = ranks[r]["ring_vs_one_call"]
        _check_grad(got, ref)
        assert counts == {"k6": 0, "ring": 0, "all_reduce": 2}
        np.testing.assert_array_equal(got, ranks[0]["ring_vs_one_call"][0])


def _ert_bound(inp, eps):
    """How far a gradient whose rays stop earlier (at T < ``eps``) can lie
    from one whose rays run on, per grid voxel. A stopped ray's later
    samples had T_k < eps: their colour cotangent dC T_k (1 - att_k) is at
    most |dC| eps, and every density cotangent of the ray moves by at most
    sdt eps (2 sum_c |dC_c| max|c| + |dT|) (the skipped samples' own terms
    and the suffix sum and T_fin that all earlier samples read); softplus
    only scales the density's by sigmoid <= 1. A voxel of a slice gathers
    those per-sample changes with tent weights that sum to at most
    (1/ay + 1)(1/ax + 1) a view, ay, ax the sample spacings in voxels."""
    ay, _, ax, _ = inp["coeffs"]
    spread = inp["views"] * (1 / ay.min() + 1) * (1 / ax.min() + 1)
    d_c, d_t = np.abs(inp["d_rgb"]).max(), np.abs(inp["d_t"]).max()
    c_max = np.abs(inp["grid_sc"][:, 1:]).max()
    per_sample = max(inp["dt"].max() * (2 * 3 * d_c * c_max + d_t), d_c)
    return float(spread * eps * per_sample)


@pytest.mark.parametrize("tag", sorted(ERT))
def test_ring_backward_with_ert_and_softplus_matches_one_call(ranks, tag):
    """The ring backward at eps > 0 and with softplus against the backward
    in one call then one all-reduce: 1e-5 of max|grad| (the carry threads
    the early-stop state through the slabs), the same on every rank (the
    inputs are ``test_mesh_ring_grad_with_ert_and_softplus``'s density, at
    which the ranks' rows stop)."""
    for r in range(WORLD):
        got, ref, counts = ranks[r][f"ring_vs_one_call_{tag}"]
        _check_grad(got, ref)
        assert counts == {"k6": 0, "ring": 0, "all_reduce": 2}
        np.testing.assert_array_equal(
            got, ranks[0][f"ring_vs_one_call_{tag}"][0])


@pytest.mark.parametrize("tag", sorted(ERT))
def test_mesh_ring_grad_with_ert_and_softplus(ranks, tag):
    """The mesh gradient through the ring at eps > 0 and with softplus:
    against the single-process twin of each rank's rows, summed, 1e-5 of
    max|grad| plus the all-reduce's roundoff (each rank's rows stop at
    their own per-slice maximum, in one process as on the mesh); against
    the single-process twin of the whole image within ``_ert_bound``; and
    at eps > 0 the ranks do stop rays the whole image keeps."""
    kw = ERT[tag]
    inp = _sweep_inputs(2, True, dense=True)
    n_v = inp["dt"].shape[1]
    v_l = n_v // WORLD
    partials = [_port_rows_grad(inp, r * v_l, (r + 1) * v_l, row0=True, **kw)
                for r in range(WORLD)]
    by_rows = np.sum(partials, 0)
    whole = _port_rows_grad(inp, 0, n_v, **kw)
    bound = _ert_bound(inp, kw.get("eps", 0.0))
    for r in range(WORLD):
        got = ranks[r][f"sweep_ring_{tag}"]
        _check_grad(got, by_rows, _reduce_roundoff(partials))
        _check_grad(got, whole, bound)
        np.testing.assert_array_equal(got, ranks[0][f"sweep_ring_{tag}"])
    if "eps" in kw:
        assert np.abs(by_rows - whole).max() > 1e-3 * np.abs(whole).max()


_J_CAPTURE = optax.GradientTransformation(
    lambda p: jnp.zeros_like(p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_steps(scenes, devices8):
    """The JAX package's step (view batch) from the same state, per warp,
    on its 4-device mesh (bucketed) and on one device: {(warp, mesh):
    (loss, gradient)}."""
    out = {}
    for warp in ("gather", "rows"):
        gshape, jcams, _, targets = scenes[warp]
        with _env(_warp_env(warp)):
            (key, (idxs, stacked, band, tiling)), = jfit.group_views(
                jcams, gshape, n_shards=WORLD).items()
        for mesh in (jdist.data_mesh(WORLD), None):
            step = jfit.make_train_step(key, 2, _J_CAPTURE, JRCFG, True,
                                        "xla", mesh, band=band,
                                        warp_tiling=tiling, view_batch=True,
                                        prestage=True)
            _, grad, loss = step(jnp.asarray(_raw_params(gshape)),
                                 jnp.zeros(gshape), stacked,
                                 jnp.asarray(targets[np.array(idxs)]),
                                 jnp.asarray([1, 0]), jnp.zeros(2, jnp.int32))
            out[warp, mesh is not None] = (float(loss), np.asarray(grad))
    return out


@pytest.mark.parametrize("warp,mode", STEPS)
def test_mesh_step_matches_jax(ranks, jax_steps, warp, mode):
    """One mesh train step from one state, in each reduction mode (and the
    view loop), with the gather and the row warp: the loss and the
    gradient, the same on every rank, against the JAX package's step on
    one device; and against its mesh step, whose gradient is 4x as large
    (a fault of the reference, ROADMAP C: its all_gather's transpose sums
    the image cotangent over the devices, each of which took the whole
    loss; Adam, invariant to a gradient's scale, hides it in trajectories)
    and whose three modes differ only in reduction order."""
    name = f"step_{warp}_{mode}"
    j_loss, j_grad = jax_steps[warp, False]
    m_loss, m_grad = jax_steps[warp, True]
    assert abs(m_loss - j_loss) <= 1e-6 * j_loss
    _check_grad(m_grad / WORLD, j_grad)
    for r in range(WORLD):
        loss, grad = ranks[r][name]
        assert abs(loss - j_loss) <= 1e-6 * j_loss
        _check_grad(grad, j_grad)
        _check_grad(grad, m_grad / WORLD)
        np.testing.assert_array_equal(grad, ranks[0][name][1])


@pytest.fixture(scope="module")
def jax_fits(scenes, devices8, tmp_path_factory):
    """JAX ``fit_grid(mesh=data_mesh(4))`` losses, configured
    (``TPUVR_FUSED_SOFTPLUS=0``) and fused."""
    gshape, jcams, _, targets = scenes["gather"]
    out = {}
    for fused in (False, True):
        with _env({"TPUVR_FUSED_SOFTPLUS": "1" if fused else "0"}):
            _, _, hist = jfit.fit_grid(
                targets, jcams, gshape, JTrainConfig(**FIT_CFG), JRCFG,
                mesh=jdist.data_mesh(WORLD),
                run_dir=str(tmp_path_factory.mktemp("jfit")))
        out[fused] = hist["loss"]
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["configured", "fused"])
@pytest.mark.parametrize("mode", sorted(FIT_MODES))
def test_fit_grid_on_the_mesh_matches_jax(ranks, jax_fits, mode, fused):
    """``fit_grid`` over 4 steps on the mesh in each reduction mode has the
    JAX mesh trainer's loss trajectory, and every rank the same history
    and parameters."""
    name = f"fit_{mode}_{fused}"
    losses, params = ranks[0][name]
    assert len(losses) == FIT_CFG["steps"] and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_fits[fused], rtol=2e-3, atol=0)
    for r in range(1, WORLD):
        assert ranks[r][name][0] == losses
        np.testing.assert_array_equal(ranks[r][name][1], params)


@pytest.fixture(scope="module")
def jax_lit_steps(scenes, devices8):
    """The JAX package's lit step (raw density, one view) from the
    perturbed fog, on its 4-device mesh and on one device, per ``detach``:
    {(detach, mesh): (loss, gradient)}. Its mesh step runs the ring
    backward (2 slabs): in its other reductions the step does not trace on
    the CPU mesh (the tau sweep's scan carry, or the Pallas interpreter's
    slices, fail shard_map's varying-axes check; ROADMAP C)."""
    gshape, jcams, _, targets = scenes["c5"]
    groups = jfit.group_views(jcams, gshape, n_shards=WORLD)
    key = sorted(groups)[0]
    idxs, stacked, band, tiling = groups[key]
    out = {}
    for detach in LIT.values():
        for mesh in (jdist.data_mesh(WORLD), None):
            step = jfit.make_train_step(key, 1, _J_CAPTURE, JRCFG, False,
                                        "xla", mesh, band=band,
                                        warp_tiling=tiling, prestage=True,
                                        grad_ring=mesh is not None,
                                        bwd_chunks=2,
                                        lighting=_lights(detach)[1])
            _, grad, loss = step(jnp.asarray(_fog(gshape, seed=7)),
                                 jnp.zeros(gshape), stacked,
                                 jnp.asarray(targets[np.array(idxs)]),
                                 jnp.zeros(1, jnp.int32),
                                 jnp.zeros(1, jnp.int32))
            out[detach, mesh is not None] = (float(loss), np.asarray(grad))
    return out


@pytest.mark.parametrize("tag", sorted(LIT))
def test_lit_mesh_step_matches_jax(ranks, jax_lit_steps, tag):
    """c5's lit step on the mesh (raw density, the light baked on every
    rank; with ``detach=False`` the shadows' gradient joins the grid
    gradient before its all-reduce): the loss and the gradient against the
    JAX single-device step, and against the JAX mesh step (ring mode)
    divided by 4 (the reference's n-fold gradient, ROADMAP C), the same on
    every rank."""
    detach = LIT[tag]
    j_loss, j_grad = jax_lit_steps[detach, False]
    m_loss, m_grad = jax_lit_steps[detach, True]
    assert abs(m_loss - j_loss) <= 1e-6 * j_loss
    _check_grad(m_grad / WORLD, j_grad)
    for r in range(WORLD):
        loss, grad = ranks[r][f"step_lit_{tag}"]
        assert abs(loss - j_loss) <= 1e-6 * j_loss
        _check_grad(grad, j_grad)
        _check_grad(grad, m_grad / WORLD)
        np.testing.assert_array_equal(grad, ranks[0][f"step_lit_{tag}"][1])


@pytest.fixture(scope="module")
def jax_lit_fit(scenes, devices8, tmp_path_factory):
    """JAX ``fit_grid(mesh=data_mesh(4), lighting=..., params_init=fog)``
    with c5's tool settings, through the ring backward (the reduction in
    which its lit step traces on the CPU mesh), and Adam's eps 4x optax's
    default: Adam is invariant to the scale of its gradient but for eps,
    so 4x eps undoes that trainer's 4x gradient exactly (ROADMAP C; at
    optax's eps the fog's voxels of gradients near eps move otherwise,
    3.5e-3 of the loss in 4 steps here). Its losses."""
    gshape, jcams, _, targets = scenes["c5"]
    _, _, hist = jfit.fit_grid(
        targets, jcams, gshape, JTrainConfig(**C5_FIT_CFG), JRCFG,
        mesh=jdist.data_mesh(WORLD), grad_ring=True, bwd_chunks=2,
        opt=optax.adam(C5_FIT_CFG["lr"], eps=WORLD * 1e-8),
        lighting=_lights(True)[1],
        params_init=jnp.asarray(_fog(gshape)),
        run_dir=str(tmp_path_factory.mktemp("jlit")))
    return hist["loss"]


def test_lit_fit_grid_on_the_mesh_matches_jax(ranks, jax_lit_fit):
    """``fit_grid`` with c5's tool settings (lit, raw density from the fog,
    one view a step, two steps a view group) over 4 steps on the mesh,
    its gradient in 4 buckets, has the JAX mesh trainer's loss trajectory
    (Adam does not see that trainer's 4x gradient), and every rank the
    same history and parameters."""
    losses, params = ranks[0]["fit_lit"]
    assert len(losses) == C5_FIT_CFG["steps"]
    assert losses[1] < losses[0] and losses[3] < losses[2]
    np.testing.assert_allclose(losses, jax_lit_fit, rtol=2e-3, atol=0)
    for r in range(1, WORLD):
        assert ranks[r]["fit_lit"][0] == losses
        np.testing.assert_array_equal(ranks[r]["fit_lit"][1], params)


def test_fit_grid_on_the_mesh_writes_metrics_on_rank_zero(ranks):
    """Rank 0 alone writes the run directory's metrics: one line a step
    (the ranks share the directory)."""
    run = ranks[0]["fit_run_dir"] / "plainFalse"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == FIT_CFG["steps"]


@pytest.mark.parametrize("views", [1, 2])
def test_row_tile_sweeps_where_the_whole_image_does(views):
    """A row tile swept with ``row0`` is the whole image's rows: the
    forward's outputs within 1e-6 (the twins' matmuls may sum another
    number of rows in another order), and the tiles' gradients summed are
    the whole image's within 1e-5 of max|grad|."""
    inp = _sweep_inputs(views, views > 1, seed=5)
    v_l = inp["dt"].shape[1] // WORLD
    coeffs = tuple(map(torch.as_tensor, inp["coeffs"]))
    en = torch.as_tensor(inp["enables"])
    kw = dict(views=views) if views > 1 else {}
    op = sweep_fwd_views_torch if views > 1 else sweep_fwd_torch
    whole = op(torch.as_tensor(inp["grid_sc"]), coeffs, en,
               torch.as_tensor(inp["dt"]).flatten(0, 1), reverse=views > 1,
               **kw)
    grads = []
    for r in range(WORLD):
        rows = slice(r * v_l, (r + 1) * v_l)
        tile = op(torch.as_tensor(inp["grid_sc"]), coeffs, en,
                  torch.as_tensor(inp["dt"][:, rows]).flatten(0, 1),
                  reverse=views > 1, row0=rows.start, **kw)
        for got, ref in zip(tile, whole):
            ref = ref.unflatten(-2, (views, -1))[..., rows, :]
            np.testing.assert_allclose(got.unflatten(-2, (views, -1)), ref,
                                       rtol=0, atol=1e-6)
        grads.append(_port_rows_grad(inp, rows.start, rows.stop, row0=True))
    _check_grad(np.sum(grads, 0), _port_rows_grad(inp, 0, v_l * WORLD))


def test_ring_refusals_match_jax():
    """Ring size 1, and slabs that do not split over the ring or the JAX
    kernel's grid steps, raise ValueError in both packages."""
    inp = _sweep_inputs(1, False)
    n_v, n_u = inp["dt"].shape[1:]
    ops = (np.zeros((3, n_v, n_u), np.float32), np.ones((n_v, n_u), np.float32),
           np.ones((3, n_v, n_u), np.float32), np.zeros((n_v, n_u), np.float32))
    args = (inp["grid_sc"], inp["coeffs"], inp["enables"], inp["dt"][0], *ops)
    for size, chunks in ((1, 1), (4, 3), (4, 8)):
        with pytest.raises(ValueError, match="ring_size|ring_chunks"):
            jsweep_bwd_ring(*(jax.tree.map(jnp.asarray, a) for a in args),
                            ring_size=size, ring_chunks=chunks)
        with pytest.raises(ValueError, match="ring_size|ring_chunks"):
            sweep_bwd_ring(*(jax.tree.map(torch.as_tensor, a) for a in args),
                           mesh=DataMesh(None, 0, size), ring_size=size,
                           ring_chunks=chunks)


def test_indivisible_rows_refused_as_in_jax(devices8, scenes):
    """A mesh whose size does not divide the intermediate rows: both
    packages' ``render_view_dp`` and the port's ``fit_grid`` raise
    ValueError (before any collective)."""
    jcam = _render_cams()[0]
    with pytest.raises(ValueError, match="divisible"):
        jdist.render_view_dp(jnp.asarray(_render_grid()), jcam,
                             jdist.data_mesh(3), JRCFG, impl="xla")
    three = DataMesh(None, 0, 3)
    with pytest.raises(ValueError, match="divisible"):
        render_view_dp(torch.as_tensor(_render_grid()), _tcam(jcam), three,
                       RCFG, device="cpu")
    gshape, _, tcams, targets = scenes["gather"]
    with pytest.raises(ValueError, match="divisible"):
        tfit.fit_grid(targets, tcams, gshape, TrainConfig(**FIT_CFG), RCFG,
                      mesh=three, device="cpu")


def _hand_zmesh(n_data, n_z):
    """Rank 0 of an n_data x n_z mesh made by hand, with no process group:
    a collective on it would fail, so a refusal must come first."""
    return GridMesh(n_data, n_z, 0, data=DataMesh(None, 0, n_data),
                    z=DataMesh(None, 0, n_z),
                    flat=DataMesh(None, 0, n_data * n_z))


# fit_grid on a 2 x 2 mesh: (camera index of _render_cams(4, res), res,
# grid Z, fit_grid keywords, environment, the message's words).
Z_REFUSALS = {
    "lighting": (0, 4, 4, dict(lighting=LightingConfig(mode="lightvolume")),
                 {}, "lighting"),
    "grad_ring": (0, 4, 4, dict(grad_ring=True, bwd_chunks=2), {},
                  "grad_ring"),
    "bwd_chunks": (0, 4, 4, dict(bwd_chunks=2), {}, "bwd_chunks"),
    "warp_rows": (0, 4, 4, {}, {"TPUVR_WARP": "rows"}, "TPUVR_WARP=rows"),
    "fused": (0, 4, 4, dict(fused=True), {}, "fused mode"),
    "cross_axis": (1, 4, 4, {}, {}, "z-sharded training requires"),
    "indivisible_z": (0, 4, 5, {}, {}, "Z=5 not divisible by z-mesh 2"),
    "indivisible_rows": (0, 6, 4, {}, {}, "6 rows not divisible by mesh 2x2"),
}


@pytest.mark.parametrize("case", sorted(Z_REFUSALS))
def test_z_mesh_refused(devices8, case):
    """What fit_grid cannot honour on a ('data', 'z') mesh raises
    ValueError before any collective: lighting, grad_ring, bwd_chunks > 1
    and TPUVR_WARP=rows (the JAX trainer drops all four silently there),
    the fused mode, and, as in the JAX package (with its message, checked
    on its 2 x 2 mesh), views that do not sweep the z axis and a Z the z
    ranks do not divide; and intermediate rows the ranks do not divide."""
    cam_i, res, z, kw, env, words = Z_REFUSALS[case]
    jcam = _render_cams(4, res)[cam_i]
    shape = (z, 4, 4, 4)
    targets = np.zeros((1, res, res, 3), np.float32)
    with _env(env), pytest.raises(ValueError, match=words):
        tfit.fit_grid(targets, [_tcam(jcam)], shape, mesh=_hand_zmesh(2, 2),
                      device="cpu", **kw)
    if case in ("cross_axis", "indivisible_z"):
        with pytest.raises(ValueError, match=words):
            jfit.fit_grid(targets, [jcam], shape,
                          JTrainConfig(steps=1, ckpt_every=0),
                          mesh=jgrid_mesh(2, 2))


def test_z_render_refusals_match_jax(devices8):
    """The z render's divisibility refusals (slices over 'z', rows over
    every rank) in both packages, before any collective."""
    grid = np.zeros((6, 6, 6, 4), np.float32)
    jcam = _render_cams(6, 6)[0]
    for layout, words in (((1, 4), "6 slices not divisible by z-mesh 4"),
                          ((2, 2), "6 rows not divisible by mesh 2x2")):
        with pytest.raises(ValueError, match=words):
            jrender_zsharded(jnp.asarray(grid), jcam, jgrid_mesh(*layout),
                             JRCFG, impl="xla")
        for fold in ("all_gather", "ring"):
            with pytest.raises(ValueError, match=words):
                render_view_zsharded(grid, _tcam(jcam),
                                     _hand_zmesh(*layout), RCFG,
                                     device="cpu", fold=fold)
        with pytest.raises(ValueError, match=words):
            render_view_retiled(grid, _tcam(jcam), _hand_zmesh(*layout),
                                RCFG, device="cpu")
