"""Gradients of tpuvr_torch's distributed renders on 4 gloo ranks on the
CPU: the three z folds (``render_view_zsharded`` gathered and ring,
``render_view_retiled``) on ``('data', 'z')`` meshes (1, 4) and (2, 2),
``render_view_dp`` on a 4-rank data mesh, and the differentiable
collectives of ``tpuvr_torch.dist.init`` under them.

The gradient contract (``tpuvr_torch.dist.init``): every rank takes the
same loss of the same image, ``sum(rgb^2) + sum(T)`` (the JAX package's z
gradient tests), and differentiates it. A z rank's gradient is its slab's,
summed over its ``'data'`` ranks, and zeros elsewhere; a data-mesh rank's
is the whole grid's, equal to the one-process ``render_view``'s.

Every case runs in one start of the ranks (module fixture ``ranks``; the
cases live in ``tpuvr_torch.dist.workers``, so a rank imports no JAX).

Tolerances (f32):
- a gradient against the port's one-process ``render_view`` gradient, or
  the JAX package's: 1e-5 of max|grad| plus the roundoff of the
  backward's all-reduce over the ranks that share the slab (or the grid),
  3 * 2^-24 * sum_r |g_r| of the ranks' parts (``tests/test_torch_dist.py``);
  outside the slab, exactly zero;
- the ring fold's gradient against the gathered fold's: 1e-5 of
  max|grad| (the same segments composed in another association);
- the collectives themselves, in f64 on integers: exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.dist import replicated as jdist
from tpuvr.dist.retile import render_view_retiled as jrender_retiled
from tpuvr.dist.sharded_grid import grid_mesh as jgrid_mesh
from tpuvr.dist.sharded_grid import render_view_zsharded as jrender_zsharded
from tpuvr.io.synth import smoke_sphere
from tpuvr.ref.camera import OrthoCamera, look_at_perspective
from tpuvr_torch.config import RenderConfig
from tpuvr_torch.convert import camera_from_fields
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.ops import render as trender
from tpuvr_torch.ops.geometry import plan_sweep
from tpuvr_torch.ref.camera import dominant_axis
from tpuvr_torch.ref.march import GRID_PERM

WORLD = 4
N = 16
RES = 16
RCFG = RenderConfig(early_stop_eps=0.0)
JRCFG = JRenderConfig(early_stop_eps=0.0)
# render_view_dp also in row chunks of 2: each rank's 4 rows in 2 sweeps.
DP_CFGS = {"whole": RCFG,
           "chunked": dataclasses.replace(RCFG, max_rows_per_call=2)}
LAYOUTS = [(1, 4), (2, 2)]
FOLDS = ["all_gather", "ring", "retile"]
CAMS = ["ortho", "reverse_perspective"]
COLLECTIVES = ["all_gather", "all_to_all", "exchange", "gather_tiles",
               "replicated"]


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


def _grid():
    return np.array(smoke_sphere(N), np.float32)


def _zname(layout, cam, fold):
    return f"z_{layout[0]}x{layout[1]}_{cam}_{fold}"


def _cases():
    grid = _grid()
    cases = [(f"collectives_{layout}", workers.grad_collectives_case,
              dict(layout=layout), {}) for layout in LAYOUTS]
    for ci, jcam in enumerate(_render_cams()):
        for layout in LAYOUTS:
            for fold in FOLDS:
                cases.append((_zname(layout, ci, fold), workers.zgrad_case,
                              dict(layout=layout, grid=grid, cam=_tcam(jcam),
                                   cfg=RCFG, fold=fold), {}))
        for kind, cfg in DP_CFGS.items():
            cases.append((f"dp_{ci}_{kind}", workers.dpgrad_case,
                          dict(grid=grid, cam=_tcam(jcam), cfg=cfg), {}))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """Every case in one spawn of 4 gloo ranks; a rank that fails or hangs
    fails here (timeout 240 s)."""
    return launch.spawn(workers.run_suite, WORLD, "gloo", "cpu",
                        (_cases(),), timeout_s=240)


@functools.lru_cache(maxsize=None)
def _port_grad(cam, dp_kind="whole"):
    """The port's one-process ``render_view``: (loss, gradient)."""
    g = torch.as_tensor(_grid()).requires_grad_(True)
    rgb, t = trender.render_view(g, _tcam(_render_cams()[cam]),
                                 DP_CFGS[dp_kind], device="cpu")
    loss = workers.image_loss(rgb, t)
    (grad,) = torch.autograd.grad(loss, g)
    return float(loss.detach()), grad.numpy()


@functools.lru_cache(maxsize=None)
def _jax_grad(kind, cam, layout=None):
    """``jax.grad`` of the JAX package's ``kind`` ("all_gather": the
    gathered z fold, "retile", "dp": ``render_view_dp`` over 4 devices)."""
    jcam = _render_cams()[cam]
    if kind == "dp":
        mesh = jdist.data_mesh(WORLD)

        def render(g):
            return jdist.render_view_dp(g, jcam, mesh, JRCFG, impl="xla")
    elif kind == "retile":
        def render(g):
            return jrender_retiled(g, jcam, jgrid_mesh(*layout), JRCFG,
                                   impl="xla")
    else:
        def render(g):
            return jrender_zsharded(g, jcam, jgrid_mesh(*layout), JRCFG,
                                    impl="xla", fold=kind)

    def loss(g):
        rgb, t = render(g)
        return jnp.sum(rgb * rgb) + jnp.sum(t)

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(_grid())))


def _slab_mask(cam, layout, rank):
    """The grid voxels of rank's slab: traversal steps [d sz, (d + 1) sz)
    of the camera's sweep, z index d = rank % n_z."""
    tcam = _tcam(_render_cams()[cam])
    axis = dominant_axis(tcam)
    plan, _ = plan_sweep(tcam, (N, N, N, 4), axis)
    sz = plan.n_planes // layout[1]
    d = rank % layout[1]
    lo = plan.n_planes - (d + 1) * sz if plan.reverse else d * sz
    mask = np.zeros((N, N, N, 4), bool)
    mask.transpose(GRID_PERM[axis])[lo:lo + sz] = True
    return mask


def _roundoff(results, name, ranks_of_sum):
    """3 * 2^-24 * max sum_r |g_r| of the ranks' parts before their sum."""
    parts = np.stack([results[r][name]["partial"] for r in ranks_of_sum])
    return 3 * 2.0**-24 * float(np.abs(parts).sum(0).max())


def _z_results(ranks, layout, cam, fold):
    """Per rank: (its case's results, its slab mask, the roundoff bound of
    its slab's sum over 'data')."""
    n_data, n_z = layout
    name = _zname(layout, cam, fold)
    for r in range(WORLD):
        slab_ranks = [k * n_z + r % n_z for k in range(n_data)]
        yield (ranks[r][name], _slab_mask(cam, layout, r),
               _roundoff(ranks, name, slab_ranks))


def _check_grad(got, ref, scale, extra=0.0):
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale + extra)


def _factor(j_grad, s_grad):
    """The scale of the JAX gradient against the port's one-process one."""
    return float((j_grad * s_grad).sum() / (s_grad * s_grad).sum())


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_zgrad_matches_one_process(ranks, layout, cam, fold):
    """Each fold on each layout, both cameras: every rank's gradient is the
    one-process ``render_view`` gradient on its slab and exactly zero
    elsewhere; the ranks of a slab hold the same gradient; every rank's
    loss is the one-process loss; summed over the 'z' ranks of a data row
    the gradients are the whole one-process gradient."""
    s_loss, s_grad = _port_grad(cam)
    scale = float(np.abs(s_grad).max())
    for res, mask, roundoff in _z_results(ranks, layout, cam, fold):
        assert abs(res["loss"] - s_loss) <= 1e-6 * s_loss
        _check_grad(res["grad"], np.where(mask, s_grad, 0.0), scale,
                    roundoff)
        assert not res["grad"][~mask].any()
    n_z = layout[1]
    name = _zname(layout, cam, fold)
    for r in range(n_z, WORLD):
        np.testing.assert_array_equal(ranks[r][name]["grad"],
                                      ranks[r % n_z][name]["grad"])
    whole = sum(ranks[d][name]["grad"] for d in range(n_z))
    _check_grad(whole, s_grad, scale,
                max(roundoff for _, _, roundoff in
                    _z_results(ranks, layout, cam, fold)))


@pytest.mark.parametrize("fold", ["all_gather", "retile"])
@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_zgrad_matches_jax(ranks, devices8, layout, cam, fold):
    """The gathered and retiled folds against ``jax.grad`` of the JAX
    package's z render on its CPU mesh of the same layout (first 4
    devices), sliced to each rank's slab: the JAX gradient carries no
    factor here (its folds' transposes keep the slabs sharded), and every
    rank's gradient is its slab's."""
    j_grad = _jax_grad(fold, cam, layout)
    assert abs(_factor(j_grad, _port_grad(cam)[1]) - 1.0) <= 1e-5
    scale = float(np.abs(j_grad).max())
    for res, mask, roundoff in _z_results(ranks, layout, cam, fold):
        _check_grad(res["grad"], np.where(mask, j_grad, 0.0), scale,
                    roundoff)


@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_ring_grad_matches_gathered_fold(ranks, layout, cam):
    """The ring fold's gradient against the gathered fold's on every rank
    (the JAX package's ring fold compiles too slowly on the CPU to be held
    here itself)."""
    for r in range(WORLD):
        ring = ranks[r][_zname(layout, cam, "ring")]["grad"]
        ref = ranks[r][_zname(layout, cam, "all_gather")]["grad"]
        _check_grad(ring, ref, float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", sorted(DP_CFGS))
@pytest.mark.parametrize("cam", [0, 1], ids=CAMS)
def test_dp_grad_matches_one_process_and_jax(ranks, devices8, cam, kind):
    """``render_view_dp`` on 4 ranks, whole and in row chunks of 2: every
    rank holds the same gradient, the one-process ``render_view``'s (with
    the same chunks) and ``jax.grad`` of the JAX ``render_view_dp`` on a
    4-device data mesh, which carries no factor: its shard_map's transpose
    psums the replicated grid's cotangent once."""
    name = f"dp_{cam}_{kind}"
    s_loss, s_grad = _port_grad(cam, kind)
    j_grad = _jax_grad("dp", cam)
    assert abs(_factor(j_grad, s_grad) - 1.0) <= 1e-5
    roundoff = _roundoff(ranks, name, range(WORLD))
    for r in range(WORLD):
        res = ranks[r][name]
        assert abs(res["loss"] - s_loss) <= 1e-6 * s_loss
        np.testing.assert_array_equal(res["grad"], ranks[0][name]["grad"])
        _check_grad(res["grad"], s_grad, float(np.abs(s_grad).max()),
                    roundoff)
        _check_grad(res["grad"], j_grad, float(np.abs(j_grad).max()),
                    roundoff)


def _forward_collectives(case):
    """The collectives a forward frame runs on a rank."""
    if case == "dp":
        return {"all_reduce": 1}
    layout, fold = case
    fold_kind = {"all_gather": {"all_gather": 1},
                 "ring": {"exchange": layout[1] - 1},
                 "retile": {"all_to_all": 1}}[fold]
    return {"all_reduce": 1, **fold_kind}


def _backward_collectives(case):
    """The collectives the backward adds: each fold's transpose (the
    gathered fold's reduce-scatter, the ring's exchanges, the retile's
    all_to_all), and the all-reduce of the slab's gradient over 'data'
    where n_data > 1, or of the replicated grid's over the data mesh; the
    tiles' gather adds none."""
    if case == "dp":
        return {"all_reduce": 1}
    layout, fold = case
    out = {"all_gather": {"reduce_scatter": 1},
           "ring": {"exchange": layout[1] - 1},
           "retile": {"all_to_all": 1}}[fold]
    return {**out, **({"all_reduce": 1} if layout[0] > 1 else {})}


def _collectives(counts):
    return {k[len("collective_"):]: v for k, v in counts.items()
            if k.startswith("collective_") and v}


GRAD_CASES = ([(layout, cam, fold) for layout in LAYOUTS for cam in (0, 1)
               for fold in FOLDS]
              + [("dp", cam, kind) for cam in (0, 1) for kind in DP_CFGS])


def _grad_case_name(layout, cam, fold):
    return (f"dp_{cam}_{fold}" if layout == "dp"
            else _zname(layout, cam, fold))


@pytest.mark.parametrize("layout,cam,fold", GRAD_CASES,
                         ids=[_grad_case_name(*c) for c in GRAD_CASES])
def test_forward_only_unchanged_and_backward_collectives(ranks, layout, cam,
                                                         fold):
    """A forward-only frame (a grid that needs no gradient) gives the same
    bits as the forward of the differentiated frame and runs only the
    forward's collectives; a forward and backward run exactly the
    forward's and the transposes' collectives, on every rank."""
    name = _grad_case_name(layout, cam, fold)
    case = "dp" if layout == "dp" else (layout, fold)
    fwd = _forward_collectives(case)
    both = dict(fwd)
    for k, v in _backward_collectives(case).items():
        both[k] = both.get(k, 0) + v
    for r in range(WORLD):
        res = ranks[r][name]
        np.testing.assert_array_equal(res["fwd_rgb"], res["rgb"])
        np.testing.assert_array_equal(res["fwd_t"], res["t"])
        assert _collectives(res["fwd_counts"]) == fwd
        assert _collectives(res["counts"]) == both


def _expected_collective(name, layout, r, cot):
    """(output, gradient) of collective ``name`` on rank r by its
    definition, from every rank's inputs and cotangents ``cot[k]``."""
    n_z = layout[1]
    i, d = divmod(r, n_z)
    z_ranks = [i * n_z + k for k in range(n_z)]

    def x(k, *shape):
        base = np.arange(float(np.prod(shape))).reshape(shape)
        return base if name == "replicated" else base + {
            "all_to_all": 100}.get(name, 10) * k

    if name == "all_gather":
        return (np.stack([x(k, 2, 3) for k in z_ranks]),
                sum(cot[k][d] for k in z_ranks))
    if name == "all_to_all":
        return (np.stack([x(k, n_z, 2)[d] for k in z_ranks]),
                np.stack([cot[k][d] for k in z_ranks]))
    if name == "exchange":  # b -> b - 1; the last rank receives zeros
        out = x(r + 1, 2, 3) if r + 1 < WORLD else np.zeros((2, 3))
        return out, cot[r - 1] if r else np.zeros((2, 3))
    if name == "gather_tiles":  # the own tile, with no sum
        return (np.concatenate([x(k, 2, 3) for k in range(WORLD)]),
                cot[r][2 * r:2 * r + 2])
    return x(r, 2, 3), sum(cot[k] for k in range(WORLD))  # replicated


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_differentiable_collectives(ranks, layout, name):
    """Each differentiable collective in f64 against its definition, on
    every rank: ``all_gather``'s gradient is the sum over the ranks of
    their cotangents' slot for this rank (one reduce-scatter);
    ``all_to_all``'s is its inverse applied to the cotangent (one
    all_to_all); ``exchange``'s comes back over the reversed pairs, zeros
    to the rank that was no source (one exchange); ``gather_tiles``' is the
    own tile of the cotangent every rank holds, with no sum and no
    collective; ``replicated``'s is the all-reduce of the cotangents."""
    res = [ranks[r][f"collectives_{layout}"][name] for r in range(WORLD)]
    cots = [c for _, _, c, _ in res]
    if name == "gather_tiles":  # the same cotangent on every rank
        for c in cots[1:]:
            np.testing.assert_array_equal(c, cots[0])
    counts = {"all_gather": {"reduce_scatter": 1},
              "all_to_all": {"all_to_all": 1}, "exchange": {"exchange": 1},
              "gather_tiles": {}, "replicated": {"all_reduce": 1}}[name]
    for r, (out, grad, _, got) in enumerate(res):
        want_out, want_grad = _expected_collective(name, layout, r, cots)
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(grad, want_grad)
        assert got == counts
