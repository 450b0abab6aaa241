"""The benchmark's plain reference against tpuvr_torch's CPU path at 16^3
(image, grid gradient, one Adam step), and its frozen work counts against
``tpuvr_torch/bench/roofline.py``."""

import numpy as np
import pytest
import torch

from conftest import TINY
from vrbench import fitjob, scene, work
from vrbench.ref import geometry as G
from vrbench.ref import sweep as S
from vrbench.ref import train as RT
from vrbench.spec import Spec

CPU = torch.device("cpu")


def tiny_config(name, **over):
    cfg = Spec().config(name)
    cfg.update(TINY[name], **over)
    return cfg


@pytest.mark.parametrize("name", ["c4", "c5"])
def test_images_match_the_port(name):
    from tpuvr_torch.ops.render import render_view

    cfg = tiny_config(name)
    draw = scene.Draw(5, cfg["grid_n"])
    grid = scene.smoke_scene(cfg["grid_n"], draw, CPU)
    rcfg, lcfg = fitjob.program_configs(cfg)
    cams = fitjob.cameras(cfg, {}, draw)
    for cam, pcam in zip(cams, fitjob.program_cameras(cams)):
        rgb_p, t_p = render_view(grid, pcam, rcfg, lighting=lcfg, device="cpu")
        v = G.view(cam, tuple(grid.shape), CPU)
        rgb_r, t_r = S.render(S.lit(grid, cfg["lighting"]), v,
                              cfg["early_stop_eps"], cfg["use_occupancy"])
        assert float((rgb_p - rgb_r).abs().max()) <= 1e-6
        assert float((t_p - t_r).abs().max()) <= 1e-6


class _Recorder:
    """The port's Adam, keeping the gradient it was given."""

    def __init__(self, adam):
        self.adam, self.grads = adam, None

    def init(self, params):
        return self.adam.init(params)

    def update(self, grads, state):
        self.grads = grads.clone()
        return self.adam.update(grads, state)


@pytest.mark.parametrize("name", ["c4", "c5"])
def test_gradient_and_adam_step_match_the_port(name, tmp_path):
    from tpuvr_torch.config import TrainConfig
    from tpuvr_torch.train.fit import Adam, fit_grid

    cfg = tiny_config(name)
    inp = fitjob.Inputs(cfg, {}, 11, CPU)
    rcfg, lcfg = fitjob.program_configs(cfg)
    p0 = RT.initial_params(cfg, CPU)
    rec = _Recorder(Adam(cfg["lr"]))
    tcfg = TrainConfig(lr=cfg["lr"], steps=1,
                       views_per_batch=cfg["views_per_batch"], ckpt_every=0,
                       seed=inp.draw.fit_seed,
                       density_softplus=cfg["density_softplus"],
                       steps_per_call=cfg["steps_per_call"])
    _, p1, hist = fit_grid(inp.targets, fitjob.program_cameras(inp.cams),
                           inp.shape, tcfg, rcfg, lighting=lcfg,
                           params_init=p0, opt=rec, run_dir=str(tmp_path),
                           device="cpu")
    pick = RT.draws(inp.views, cfg, 1, inp.draw.fit_seed)[0]
    loss, g = RT.loss_and_grad(p0, inp.views, inp.targets, pick, cfg, 5)
    assert abs(float(loss) - hist["loss"][0]) <= 1e-6 * abs(float(loss))
    scale = float(g.abs().max())
    assert scale > 0
    assert float((g - rec.grads).abs().max()) <= 1e-6 * scale
    p1_ref = RT.Adam(p0, cfg["lr"]).step(p0, g)
    assert float((p1 - p1_ref).abs().max()) <= 1e-6


def test_draws_follow_the_fit_schedule():
    cfg = tiny_config("c5")
    views = fitjob.Inputs(cfg, {}, 3, CPU).views
    groups = RT.groups(views)
    assert len(groups) == 4
    picks = RT.draws(views, cfg, 5, 1)
    # two steps a group, one view a step
    firsts = [g[1][0] for g in groups]
    assert picks == [[firsts[0]], [firsts[0]], [firsts[1]], [firsts[1]],
                     [firsts[2]]]


@pytest.mark.parametrize("rows", [None, (0, 64)])
def test_frozen_bounds_equal_the_ports(rows):
    from tpuvr_torch.bench import roofline

    cfg = Spec().config("c4")
    draw = scene.Draw(9, cfg["grid_n"])
    cams = fitjob.cameras(cfg, {}, draw)
    shape = (256, 256, 256, 4)
    views = [G.view(c, shape, CPU) for c in cams[:8]]
    views = [v for v in views if v.plan.axis == views[0].plan.axis
             and v.plan.reverse == views[0].plan.reverse]
    rng = np.random.default_rng(0)
    en = {a: rng.random(256) > 0.2 for a in range(3)}
    for batch in (views[:1], views):
        args, r0 = work.sweep_args(shape, batch, en, rows)
        real = (torch.zeros(args[0].shape),) + args[1:]
        assert work.sweep_fwd_bound(args, r0) == roofline.sweep_fwd_bound(
            real, r0)
        assert work.sweep_bwd_bound(args, r0) == roofline.sweep_bwd_bound(
            real, r0)
        assert work.support_samples(args, r0) == roofline.support_samples(
            real, r0)


def test_a_row_tile_reads_no_more_than_the_whole_view():
    cfg = Spec().config("c5")
    cams = fitjob.cameras(cfg, {}, scene.Draw(4, cfg["grid_n"]))
    shape = (cfg["grid_n"],) * 3 + (4,)
    v = G.view(cams[0], shape, CPU)
    en = {a: np.ones(cfg["grid_n"], bool) for a in range(3)}
    whole, r0 = work.sweep_args(shape, [v], en)
    assert work.tile_bound(whole, r0, False) == work.sweep_fwd_bound(whole, r0)
    assert work.tile_bound(whole, r0, True) == work.sweep_bwd_bound(whole, r0)
    n_v = v.plan.n_v
    for rank in range(4):
        tile, r0 = work.sweep_args(shape, [v], en, (rank * n_v // 4, n_v // 4))
        for bwd, bound in ((False, work.sweep_fwd_bound),
                           (True, work.sweep_bwd_bound)):
            mine, frozen = work.tile_bound(tile, r0, bwd), bound(tile, r0)
            assert mine[1] == frozen[1] and mine[0] <= frozen[0]
