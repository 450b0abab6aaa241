"""``fit_grid`` resumed on a data mesh whose ranks share no run directory:
rank 0's checkpoint decides where every rank starts.

Two gloo ranks on the CPU, in a spawn of their own with a short timeout:
ranks that started at different steps would wait for each other in a
collective until the timeout fails the test. Only rank 0's directory holds
a checkpoint. Both ranks must resume at its step, from its parameters and
Adam state, and follow a one-process resume from the same checkpoint:
losses within 1e-6 relative and parameters within 1e-5 (the mesh step
equals the one-process step up to the order of the gradient's sums, as
``tests/test_torch_dist.py`` holds it; two Adam steps carry that
roundoff), the ranks bit-identical to each other.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from tpuvr_torch.config import RenderConfig, TrainConfig
from tpuvr_torch.dist import launch, workers
from tpuvr_torch.io.synth import smoke_sphere
from tpuvr_torch.ref.camera import look_at_perspective
from tpuvr_torch.train import fit

WORLD = 2
RCFG = RenderConfig(early_stop_eps=0.0)
CFG = TrainConfig(lr=3e-2, steps=6, views_per_batch=2, ckpt_every=2,
                  seed=11)


@pytest.fixture(scope="module")
def scene():
    """Three perspective views of a 16^3 smoke sphere at 16^2 (one view
    group), their targets rendered by the port on the CPU."""
    torch.set_num_threads(1)
    n = 16
    c = (n - 1) / 2.0
    cams = [look_at_perspective((c + dx, c - 3.0 * n, c + 0.4 * n),
                                (c, c, c), res_x=16, res_y=16)
            for dx in (-2.0, 0.0, 2.0)]
    targets = fit.render_all_views(smoke_sphere(n, device="cpu"), cams, RCFG,
                                   device="cpu").numpy()
    return (n, n, n, 4), cams, targets


def test_mesh_resume_takes_rank_zero_step_and_state(scene, tmp_path):
    shape, cams, targets = scene
    first = tmp_path / "first"
    fit.fit_grid(targets, cams, shape, dataclasses.replace(CFG, steps=4),
                 RCFG, run_dir=str(first), device="cpu")
    one, rank0, rank1 = (tmp_path / d for d in ("one", "rank0", "rank1"))
    shutil.copytree(first, one)
    shutil.copytree(first, rank0)
    rank1.mkdir()
    _, ref_params, ref_hist = fit.fit_grid(targets, cams, shape, CFG, RCFG,
                                           run_dir=str(one), resume=True,
                                           device="cpu")
    assert len(ref_hist["loss"]) == 2  # resumed after the step-3 checkpoint
    out = launch.spawn(workers.run_suite, WORLD, "gloo", "cpu", ([(
        "resume", workers.resume_case,
        dict(targets=targets, cams=cams, grid_shape=shape, cfg=CFG,
             render_cfg=RCFG, run_dirs=[str(rank0), str(rank1)]), {})],),
        timeout_s=60)
    losses, params = out[0]["resume"]
    np.testing.assert_allclose(losses, ref_hist["loss"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(params, ref_params.numpy(), rtol=0, atol=1e-5)
    assert out[1]["resume"][0] == losses
    np.testing.assert_array_equal(out[1]["resume"][1], params)
    # Rank 0 alone wrote: its directory gained the last checkpoint, rank 1's
    # stayed empty.
    assert (rank0 / "ckpt" / "step_5.pt").exists()
    assert not any((rank1 / "ckpt").iterdir())
