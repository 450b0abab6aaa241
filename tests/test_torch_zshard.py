"""tpuvr_torch's z-sharded grid (``tpuvr_torch.dist.sharded_grid``,
``dist.retile``, ``make_train_step_zsharded``, ``fit_grid`` on a
``('data', 'z')`` mesh) on 4 gloo ranks on the CPU, held against the JAX
package on its CPU mesh (``grid_mesh(1, 4)`` and ``grid_mesh(2, 2)`` over
its first 4 devices) and against the port's single-process results.

Every 4-rank case runs in one start of the ranks (module fixture
``ranks``; the cases live in ``tpuvr_torch.dist.workers``, so a rank
imports no JAX); the checkpoint-and-resume on a (1, 2) mesh starts 2 ranks
of its own.

Tolerances (f32):
- images 1e-5, as the single-process render tests (the folds compose the
  same segments in another association, and the JAX package samples its
  rows at ``by + row_off * ay``, an ulp from the port's ``row0``);
- a slab's gradient against the port's single-process step: 1e-5 of
  max|grad| plus the all-reduce's roundoff over ``'data'``, 3 * 2^-24 *
  sum_r |g_r| of the ranks' parts (``tests/test_torch_dist.py``); losses
  1e-6 relative;
- against the JAX z step's gradient the same, the JAX band branch's
  divided by n_data * n_z: every one of its devices takes the whole band's
  loss after two ``all_gather``s, whose transposes sum the cotangent over
  them (ROADMAP C); its retile branch carries no factor;
- loss trajectories over several steps rtol 2e-3 (the JAX package's own
  bound for a sharded trajectory, tests/test_sharded_grid.py), every
  rank's history bit-identical.
"""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.config import TrainConfig as JTrainConfig
from tpuvr.dist.retile import render_view_retiled as jrender_retiled
from tpuvr.dist.sharded_grid import grid_mesh as jgrid_mesh
from tpuvr.dist.sharded_grid import render_view_zsharded as jrender_zsharded
from tpuvr.io.synth import smoke_sphere
from tpuvr.ops.geometry import warp_to_pixels_owned as jwarp_owned
from tpuvr.ref.camera import OrthoCamera, look_at_perspective
from tpuvr.train import fit as jfit
from tpuvr_torch.config import RenderConfig, TrainConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.ops import render as trender
from tpuvr_torch.ops.geometry import (
    view_geometry,
    warp_to_pixels_dynamic,
    warp_to_pixels_owned,
)
from tpuvr_torch.train import fit as tfit

WORLD = 4
N = 16
RES = 16
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)
LAYOUTS = [(1, 4), (2, 2)]
FOLDS = ["all_gather", "ring", "retile"]
CAMS = ["ortho", "reverse_perspective"]
# Train branches: the retile (every row) and a band of 8 of the 16 rows.
BRANCHES = {"retile": None, "band": 8}
BAND_R0S = np.array([0, 8], np.int32)
FIT_CFG = dict(lr=5e-2, steps=4, views_per_batch=2, ckpt_every=0, seed=1)
FIT_BAND = 8 * RES  # rays_per_view: a band of 8 rows


def _tcam(jcam):
    return camera_from_fields(type(jcam).__name__, **dataclasses.asdict(jcam))


def _render_cams():
    """The JAX z-mesh render tests' cameras: ortho along z, and a reverse
    perspective sweep through the warp."""
    c = (N - 1) / 2.0
    return [OrthoCamera(center=(c, c, -3.0 * N), forward=(0.0, 0.0, 1.0),
                        up=(0.0, 1.0, 0.0), width=1.5 * N, height=1.5 * N,
                        res_x=RES, res_y=RES),
            look_at_perspective((c, c + 3.0 * N, c + 0.8 * N), (c, c, c),
                                res_x=RES, res_y=RES)]


def _train_cams():
    """Four perspective cameras sweeping the z axis, two each way: two view
    groups, (2, False) and (2, True)."""
    c = (N - 1) / 2.0
    return [look_at_perspective((c + dx, c + dy, c + dz * 3.0 * N),
                                (c, c, c), res_x=RES, res_y=RES)
            for dx, dy, dz in ((1.0, -0.5, -1), (-1.0, 0.5, -1),
                               (-0.8, 0.4, 1), (0.8, -0.4, 1))]


def _grid():
    return np.array(smoke_sphere(N), np.float32)


@functools.lru_cache(maxsize=None)
def _scene():
    """The train cameras (JAX and port), their targets rendered by the JAX
    package, and a raw-parameter state (init plus seeded noise)."""
    jcams = _train_cams()
    targets = np.array(jfit.render_all_views(jnp.asarray(_grid()), jcams,
                                             JRCFG, impl="xla"))
    rng = np.random.default_rng(5)
    shape = (N, N, N, 4)
    params = (np.array(jfit.init_params(shape, True))
              + rng.normal(0.0, 0.3, shape).astype(np.float32))
    return dict(shape=shape, jcams=jcams, tcams=[_tcam(j) for j in jcams],
                targets=targets, params=params)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _step_inputs(scene, layout, branch):
    """Both views of each z group, grouped over the layout's data shards:
    {key: make_train_step_zsharded inputs}."""
    out = {}
    for key, (idxs, stacked, _, _) in tfit.group_views(
            scene["tcams"], scene["shape"], n_shards=layout[0]).items():
        rows = BRANCHES[branch]
        out[key] = dict(
            layout=layout, key=key, n_views=2, render_cfg=RCFG,
            params=scene["params"],
            stacked={k: v.numpy() for k, v in stacked.items()},
            targets=scene["targets"][idxs], pick=np.array([1, 0]),
            r0s=np.zeros(2, np.int32) if rows is None else BAND_R0S,
            rows=rows)
    return out


KEYS = [(2, False, ()), (2, True, ())]
STEPS = [(layout, key, branch) for layout in LAYOUTS for key in KEYS
         for branch in BRANCHES]


def _step_name(layout, key, branch):
    return f"step_{layout[0]}x{layout[1]}_{int(key[1])}_{branch}"


def _cases(scene, tmp):
    cases = []
    grid = _grid()
    for layout in LAYOUTS:
        cases.append((f"collectives_{layout}", workers.zcollectives_case,
                      dict(layout=layout), {}))
        for ci, jcam in enumerate(_render_cams()):
            for fold in FOLDS:
                cases.append((f"render_{layout}_{ci}_{fold}",
                              workers.zrender_case,
                              dict(layout=layout, grid=grid, cam=_tcam(jcam),
                                   cfg=RCFG, fold=fold), {}))
    for layout, key, branch in STEPS:
        cases.append((_step_name(layout, key, branch), workers.zstep_case,
                      _step_inputs(scene, layout, branch)[key], {}))
    for branch, rpv in (("retile", None), ("band", FIT_BAND)):
        cases.append((f"fit_{branch}", workers.zfit_case, dict(
            layout=(2, 2), targets=scene["targets"], cams=scene["tcams"],
            grid_shape=scene["shape"],
            cfg=TrainConfig(**FIT_CFG, rays_per_view=rpv), render_cfg=RCFG,
            run_dir=str(tmp / branch)), {}))
    return cases


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """Every 4-rank case in one spawn of gloo ranks; a rank that fails or
    hangs fails here (timeout 240 s)."""
    run_dir = tmp_path_factory.mktemp("zshard")
    out = launch.spawn(workers.run_suite, WORLD, "gloo", "cpu",
                       (_cases(scene, run_dir),), timeout_s=240)
    out[0]["run_dir"] = run_dir
    return out


def _check_grad(got, ref, extra=0.0):
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale + extra)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_z_mesh_exchanges(ranks, layout):
    """The halo ``exchange`` gives each rank its successor's tensor and the
    last rank zeros; ``all_to_all`` over ``'z'`` hands chunk j to rank j;
    ``all_gather`` stacks the ``'z'`` and ``'data'`` groups in rank order;
    each counted once."""
    n_data, n_z = layout
    for r in range(WORLD):
        halo, a2a, gz, gd, counts = ranks[r][f"collectives_{layout}"]
        x = np.arange(6.0).reshape(2, 3)
        want = x + 10 * (r + 1) if r < WORLD - 1 else np.zeros_like(x)
        np.testing.assert_array_equal(halo, want)
        i, d = divmod(r, n_z)
        z_ranks = [i * n_z + k for k in range(n_z)]
        np.testing.assert_array_equal(
            a2a, [[2.0 * d + 100 * s, 2.0 * d + 1 + 100 * s]
                  for s in z_ranks])
        np.testing.assert_array_equal(gz, [x + 10 * s for s in z_ranks])
        np.testing.assert_array_equal(
            gd, [x + 10 * (k * n_z + d) for k in range(n_data)])
        assert counts == {"exchange": 1, "all_to_all": 1, "all_gather": 2}


@functools.lru_cache(maxsize=None)
def _jax_render(layout, ci, fold):
    jcam = _render_cams()[ci]
    mesh = jgrid_mesh(*layout)
    grid = jnp.asarray(_grid())
    if fold == "retile":
        out = jrender_retiled(grid, jcam, mesh, JRCFG, impl="xla")
    else:
        out = jrender_zsharded(grid, jcam, mesh, JRCFG, impl="xla", fold=fold)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_zsharded_render_matches_jax_and_one_process(ranks, devices8, layout,
                                                     cam, fold):
    """Each fold on each layout, forward (ortho) and reverse (perspective,
    through the warp): every rank's whole image against the JAX package's
    fold and the port's single-process render, 1e-5."""
    j_rgb, j_t = _jax_render(layout, cam, fold)
    t_rgb, t_t = trender.render_view(torch.as_tensor(_grid()),
                                     _tcam(_render_cams()[cam]), RCFG,
                                     device="cpu")
    for r in range(WORLD):
        rgb, t = ranks[r][f"render_{layout}_{cam}_{fold}"]
        for got, j_ref, t_ref in ((rgb, j_rgb, t_rgb), (t, j_t, t_t)):
            np.testing.assert_allclose(got, j_ref, rtol=0, atol=1e-5)
            np.testing.assert_allclose(got, t_ref.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            rgb, ranks[0][f"render_{layout}_{cam}_{fold}"][0])
    assert float(np.abs(j_rgb).max()) > 0.01


@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_ring_fold_matches_gathered_fold(ranks, layout, cam):
    """The ordered ring reduce-scatter composes the same segments as the
    gathered fold, in another association: 1e-6."""
    for fold in ("ring", "retile"):
        for r in range(WORLD):
            got = ranks[r][f"render_{layout}_{cam}_{fold}"]
            ref = ranks[r][f"render_{layout}_{cam}_all_gather"]
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _port_step(key, branch):
    """The port's single-process step (view loop) from the same state."""
    inp = _step_inputs(_scene(), (1, 1), branch)[key]
    step = tfit.make_train_step(key, 2, workers.CaptureGrad(), RCFG, True,
                                None, rows=inp["rows"])
    geom = {k: torch.as_tensor(v) for k, v in inp["stacked"].items()}
    _, grad, loss = step(torch.as_tensor(inp["params"]), None, geom,
                         torch.as_tensor(inp["targets"]), inp["pick"],
                         inp["r0s"])
    return float(loss), grad.numpy()


_J_CAPTURE = optax.GradientTransformation(
    lambda p: jnp.zeros_like(p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def _jax_step(layout, key, branch):
    """The JAX package's z step from the same state: (loss, gradient)."""
    scene = _scene()
    rows = BRANCHES[branch]
    groups = jfit.group_views(scene["jcams"], scene["shape"],
                              n_shards=layout[0])
    (jkey, (idxs, stacked, band, tiling)), = [
        kv for kv in groups.items() if kv[0][:2] == key[:2]]
    step = jfit.make_train_step_zsharded(
        jkey, 2, _J_CAPTURE, JRCFG, True, "xla", jgrid_mesh(*layout),
        band=band, rows=rows, warp_tiling=tiling, prestage=True)
    r0s = np.zeros(2, np.int32) if rows is None else BAND_R0S
    _, grad, loss = step(jnp.asarray(scene["params"]),
                         jnp.zeros(scene["shape"]), stacked,
                         jnp.asarray(scene["targets"][np.array(idxs)]),
                         jnp.asarray([1, 0]), jnp.asarray(r0s))
    return float(loss), np.asarray(grad)


def _slab_results(ranks, name, layout, ref):
    """Per rank: (loss, the reference's slab, the rank's gradient, the sum
    roundoff bound over its slab's 'data' ranks)."""
    n_data, n_z = layout
    sz = N // n_z
    for r in range(WORLD):
        d = r % n_z
        loss, grad, _ = ranks[r][name]
        parts = [ranks[k * n_z + d][name][2] for k in range(n_data)]
        roundoff = 3 * 2.0**-24 * float(np.abs(np.stack(parts)).sum(0).max())
        yield loss, ref[d * sz:(d + 1) * sz], grad, roundoff


@pytest.mark.parametrize("layout,key,branch", STEPS,
                         ids=[_step_name(*s)[5:] for s in STEPS])
def test_zstep_matches_one_process(ranks, layout, key, branch):
    """The z step's loss and every slab's gradient, retile and band,
    forward and reverse group, against the port's single-process step from
    the same state: no n_data * n_z factor in either branch; the ranks of
    a slab bit-identical."""
    name = _step_name(layout, key, branch)
    s_loss, s_grad = _port_step(key, branch)
    for loss, ref, grad, roundoff in _slab_results(ranks, name, layout,
                                                   s_grad):
        assert abs(loss - s_loss) <= 1e-6 * s_loss
        np.testing.assert_allclose(grad, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(s_grad).max())
                                   + roundoff)
    n_z = layout[1]
    for r in range(n_z, WORLD):
        np.testing.assert_array_equal(ranks[r][name][1],
                                      ranks[r % n_z][name][1])
        assert ranks[r][name][0] == ranks[0][name][0]


@pytest.mark.parametrize("layout,key,branch", STEPS,
                         ids=[_step_name(*s)[5:] for s in STEPS])
def test_zstep_matches_jax(ranks, devices8, layout, key, branch):
    """Against the JAX z step from the same state: the loss, and the
    gradient, the band branch's divided by the n_data * n_z = 4 it
    measures (that branch's fault, ROADMAP C: the JAX band gradient is 4x
    its single-device step's, its retile gradient 1x)."""
    name = _step_name(layout, key, branch)
    j_loss, j_grad = _jax_step(layout, key, branch)
    factor = WORLD if branch == "band" else 1
    s_grad = _port_step(key, branch)[1]
    measured = float((j_grad * s_grad).sum() / (s_grad * s_grad).sum())
    assert abs(measured - factor) <= 1e-5 * factor
    for loss, ref, grad, roundoff in _slab_results(ranks, name, layout,
                                                   j_grad / factor):
        assert abs(loss - j_loss) <= 1e-6 * j_loss
        _check_grad(grad, ref, roundoff)


@pytest.fixture(scope="module")
def ref_fits(scene, devices8, tmp_path_factory):
    """Reference loss trajectories: the JAX ``fit_grid`` on its (2, 2) z
    mesh (the retile), and, for the band, the JAX ``fit_grid`` on one
    device (its z mesh's band gradient is 4x; Adam would hide it)."""
    out = {}
    for branch, rpv, mesh in (("retile", None, jgrid_mesh(2, 2)),
                              ("band", FIT_BAND, None)):
        _, _, hist = jfit.fit_grid(
            scene["targets"], scene["jcams"], scene["shape"],
            JTrainConfig(**FIT_CFG, rays_per_view=rpv), JRCFG, mesh=mesh,
            run_dir=str(tmp_path_factory.mktemp("jzfit")))
        out[branch] = hist["loss"]
    return out


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_fit_grid_on_a_z_mesh_matches_jax(ranks, ref_fits, branch):
    """``fit_grid`` over 4 steps on the (2, 2) mesh, both view groups, in
    each branch: the reference trajectory (rtol 2e-3), and every rank the
    same history; the slabs' ranks the same parameters. The retile's loss
    falls (each band step draws its own rows, so its loss need not)."""
    losses, _ = ranks[0][f"fit_{branch}"]
    assert len(losses) == FIT_CFG["steps"]
    assert branch == "band" or losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref_fits[branch], rtol=2e-3, atol=0)
    for r in range(1, WORLD):
        assert ranks[r][f"fit_{branch}"][0] == losses
    np.testing.assert_array_equal(ranks[2][f"fit_{branch}"][1],
                                  ranks[0][f"fit_{branch}"][1])
    assert ranks[0][f"fit_{branch}"][1].shape == (N // 2, N, N, 4)


def test_fit_grid_on_a_z_mesh_writes_metrics_on_rank_zero(ranks):
    """Rank 0 alone writes the metrics: one line a step."""
    run = ranks[0]["run_dir"] / "retile"
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == FIT_CFG["steps"]


@pytest.mark.parametrize("n_blocks", [2, 4, 8])
def test_warp_to_pixels_owned_covers_every_pixel_once(n_blocks):
    """Row blocks of a perspective view's intermediate image, each with
    the next block's first row as its halo (zeros for the last): the
    masks are disjoint and cover every pixel, the owned pixels equal the
    whole image's 4-tap warp, pixels of a block boundary fall on both
    sides, and the JAX package's owned warp agrees (1e-6)."""
    cam = _tcam(_render_cams()[1])
    _, _, geom, _ = view_geometry(cam, (N, N, N, 4))
    n_v, n_u = geom["dt"].shape
    inter = torch.as_tensor(np.random.default_rng(3).random(
        (n_v, n_u, 4), dtype=np.float32))
    whole = warp_to_pixels_dynamic(inter, geom["lattice"], geom["uv"])
    rows = n_v // n_blocks
    covered = torch.zeros(whole.shape[:2], dtype=torch.int64)
    for b in range(n_blocks):
        r0 = b * rows
        halo = (inter[r0 + rows:r0 + rows + 1] if b < n_blocks - 1
                else torch.zeros_like(inter[:1]))
        block = torch.cat([inter[r0:r0 + rows], halo])
        img, mask = warp_to_pixels_owned(block, geom["lattice"], geom["uv"],
                                         r0, rows, n_v)
        j_img, j_mask = jwarp_owned(jnp.asarray(block.numpy()),
                                    jnp.asarray(geom["lattice"].numpy()),
                                    jnp.asarray(geom["uv"].numpy()),
                                    jnp.int32(r0), rows, n_v)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        np.testing.assert_allclose(img.numpy(), np.asarray(j_img), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(img[mask], whole[mask], rtol=0, atol=1e-6)
        covered += mask
        if b:
            assert bool(mask.any())  # each block owns pixels
    assert bool((covered == 1).all())


def test_fit_grid_resumes_each_slab_on_a_z_mesh(scene, tmp_path):
    """Checkpoint and resume on a (1, 2) mesh of 2 gloo ranks: each slab's
    first ``'data'`` rank writes its slab to ``ckpt/z{d}``; a run resumed
    from the step-3 checkpoints continues as the uninterrupted run (losses
    1e-6 relative, each rank's slab within 1e-6), every rank restoring its
    own slab."""
    cfg = TrainConfig(lr=5e-2, steps=6, views_per_batch=2, ckpt_every=2,
                      seed=1)
    common = dict(layout=(1, 2), targets=scene["targets"],
                  cams=scene["tcams"], grid_shape=scene["shape"],
                  render_cfg=RCFG)
    whole, first = tmp_path / "whole", tmp_path / "first"
    out = launch.spawn(workers.run_suite, 2, "gloo", "cpu", ([
        ("whole", workers.zfit_case, dict(common, cfg=cfg,
                                          run_dir=str(whole)), {}),
        ("first", workers.zfit_case, dict(
            common, cfg=dataclasses.replace(cfg, steps=4),
            run_dir=str(first)), {})],), timeout_s=120)
    for d in (0, 1):
        assert sorted(os.listdir(first / "ckpt" / f"z{d}")) == [
            "step_1.pt", "step_3.pt"]
    resumed = tmp_path / "resumed"
    shutil.copytree(first, resumed)
    back = launch.spawn(workers.run_suite, 2, "gloo", "cpu", ([
        ("resumed", workers.zfit_case, dict(
            common, cfg=cfg, run_dir=str(resumed), resume=True), {})],),
        timeout_s=120)
    for r in range(2):
        losses, params = back[r]["resumed"]
        w_losses, w_params = out[r]["whole"]
        assert len(losses) == 2
        np.testing.assert_allclose(losses, w_losses[4:], rtol=1e-6, atol=0)
        np.testing.assert_allclose(params, w_params, rtol=0, atol=1e-6)
    assert not np.allclose(back[0]["resumed"][1], back[1]["resumed"][1])
