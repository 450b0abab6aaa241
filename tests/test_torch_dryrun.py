"""``tpuvr_torch.entry``: the forward render of the compile check, and
``dryrun_multichip(4)`` on 4 gloo ranks on the CPU, a (2, 2)
``('data', 'z')`` mesh, held against one process and the JAX package.

Tolerances (f32): the loss 1e-6 relative; gradients 1e-5 of max|grad|
plus, on the ranks, the roundoff of their sums (3 * 2^-24 * n * max|g|
for n ranks); the updated parameters 1e-6 absolute where |g| > 1e-6
(Adam's m / sqrt(v) turns roundoff-sized gradients into full steps, as
``tests/test_torch_train.py`` has it); images 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tpuvr.config import RenderConfig as JRenderConfig
from tpuvr.io.synth import orbit_cameras as jorbit_cameras
from tpuvr.io.synth import smoke_sphere as jsmoke_sphere
from tpuvr.ops.render import render_view as jrender_view
from tpuvr.ref.camera import OrthoCamera
from tpuvr_torch import entry

RANKS = 4


@pytest.fixture(scope="module")
def ranks():
    return entry.dryrun_multichip(RANKS, device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def one_process():
    """The step on one process (``render_view`` and the port's Adam, from
    the dry run's fog) and the ring leg's one backward over every row."""
    return entry.dryrun_reference(RANKS, device="cpu")


def _grad_tol(ref, n_sum):
    scale = float(np.abs(ref).max())
    assert scale > 0
    return 1e-5 * scale + 3 * 2.0**-24 * n_sum * scale


def test_layout_and_scene():
    assert entry.dryrun_layout(4) == (2, 2)
    assert entry.dryrun_layout(3) == (3, 1)
    n, cams, _ = entry.dryrun_scene(2)
    assert n == 8 and len(cams) == 2 and cams[0].res_y % 2 == 0


def test_step_matches_one_process(ranks, one_process):
    """Every rank's loss, whole gradient and z slab of the updated grid are
    the one-process step's; the ranks of a slab agree bit for bit."""
    n_data, n_z = entry.dryrun_layout(RANKS)
    ref = one_process
    sz = entry.DRYRUN_GRID // n_z
    live = np.abs(ref["grad"]) > 1e-6
    assert live.mean() > 0.3
    for r, res in enumerate(ranks):
        assert abs(res["loss"] - ref["loss"]) <= 1e-6 * ref["loss"]
        np.testing.assert_allclose(res["grad"], ref["grad"], rtol=0,
                                   atol=_grad_tol(ref["grad"], RANKS))
        d = res["z"]
        assert d == r % n_z
        want = ref["params"][d * sz:(d + 1) * sz]
        m = live[d * sz:(d + 1) * sz]
        np.testing.assert_allclose(res["slab"][m], want[m], rtol=0,
                                   atol=1e-6)
        assert res["digest"] == ranks[d]["digest"]
        np.testing.assert_array_equal(res["slab"], ranks[d]["slab"])
        counts = res["launches"]
        # The targets' and the loss's renders, a view each: the fold's
        # all_gather and the tiles' all-reduce; the loss's backward, a view:
        # a reduce-scatter and the slab's 'data' all-reduce; then the
        # gradient's 'z' all-reduce and the ring's one slab.
        assert counts["collective_all_gather"] == 4
        assert counts["collective_reduce_scatter"] == 2
        assert counts["collective_all_reduce"] == 8


def test_one_process_step_matches_jax(one_process):
    """The reference step against the JAX package's ``render_view`` and
    ``optax.adam(1e-2)`` on the same scene."""
    n_data, _ = entry.dryrun_layout(RANKS)
    n, _, _ = entry.dryrun_scene(n_data)
    res = max(8, n_data)
    jcams = jorbit_cameras(entry.DRYRUN_VIEWS, n, res=res)
    cfg = JRenderConfig(early_stop_eps=0.0)
    truth = jsmoke_sphere(n)
    targets = [jrender_view(truth, c, cfg, impl="xla")[0] for c in jcams]

    def loss_fn(p):
        total = 0.0
        for cam, target in zip(jcams, targets):
            rgb, _ = jrender_view(p, cam, cfg, impl="xla")
            total = total + jnp.mean((rgb - target) ** 2)
        return total / len(jcams)

    params = jnp.asarray(entry.dryrun_start(truth.shape, "cpu").numpy())
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(params)
    opt = optax.adam(entry.DRYRUN_LR)
    updates, _ = opt.update(grad, opt.init(params))
    new = np.asarray(optax.apply_updates(params, updates))
    grad = np.asarray(grad)
    ref = one_process
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * ref["loss"]
    np.testing.assert_allclose(ref["grad"], grad, rtol=0,
                               atol=1e-5 * np.abs(grad).max())
    live = np.abs(grad) > 1e-6
    np.testing.assert_allclose(ref["params"][live], new[live], rtol=0,
                               atol=1e-6)


def test_ring_leg_matches_one_process(ranks, one_process):
    """The ring backward's gradient (every rank its rows, summed in one
    slab) is the one-process gradient of sum(rgb^2) over every row, on
    every rank."""
    ref = one_process["ring_grad"]
    for res in ranks:
        assert res["ring_grad"] is not None
        np.testing.assert_allclose(res["ring_grad"], ref, rtol=0,
                                   atol=_grad_tol(ref, RANKS))
        np.testing.assert_array_equal(res["ring_grad"],
                                      ranks[0]["ring_grad"])


def test_entry_renders_on_the_cpu_and_matches_jax():
    """``entry(device="cpu")`` renders on the CPU, and its frame is the JAX
    package's ``render_view`` of the same grid and camera."""
    fn, (grid,) = entry.entry(device="cpu")
    assert grid.device.type == "cpu" and grid.shape == (64, 64, 64, 4)
    rgb = fn(grid)
    assert rgb.shape == (256, 256, 3) and rgb.device.type == "cpu"
    c = 63 / 2.0
    jcam = OrthoCamera(center=(c, c, -128.0), forward=(0.0, 0.0, 1.0),
                       up=(0.0, 1.0, 0.0), width=1.4 * 64, height=1.4 * 64,
                       res_x=256, res_y=256)
    j_rgb, _ = jrender_view(jsmoke_sphere(64), jcam, JRenderConfig(),
                            impl="xla")
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), rtol=0,
                               atol=1e-5)
