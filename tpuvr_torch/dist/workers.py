"""Cases run on every rank of a :func:`tpuvr_torch.dist.launch.spawn`.

``spawn`` pickles its function by reference, so what a rank runs must be
importable from the package: a rank then imports only ``torch`` and
``tpuvr_torch``. :func:`run_suite` runs a list of the cases below in one
start of the ranks (each case gets the mesh first) and returns their
results by name; the inputs are numpy arrays and the package's own
configs and cameras, the same on every rank.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from tpuvr_torch.dist.init import all_reduce, bucketed_all_reduce, data_mesh


def run_suite(cases, device="cpu"):
    """Run ``[(name, fn, kwargs, env), ...]`` in order on this rank, each
    as ``fn(mesh, device=device, **kwargs)`` with the environment
    variables of ``env`` set (None unsets one) for its duration; returns
    ``{name: result}``."""
    mesh = data_mesh()
    out = {}
    for name, fn, kwargs, env in cases:
        saved = {k: os.environ.get(k) for k in env}
        try:
            for k, v in env.items():
                _set_env(k, v)
            out[name] = fn(mesh, device=device, **kwargs)
        finally:
            for k, v in saved.items():
                _set_env(k, v)
    return out


def _set_env(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _t(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


def all_reduce_case(mesh, *, device, per_rank, n_buckets):
    """Rank r contributes ``per_rank[r]``: its bucketed all-reduce and one
    all-reduce of the same tensor."""
    x = _t(per_rank[mesh.rank], device)
    one = x.clone()
    all_reduce(one, mesh)
    return bucketed_all_reduce(x.clone(), mesh, n_buckets), one


def render_case(mesh, *, device, grid, cam, cfg):
    """``render_view_dp`` of a numpy grid."""
    from tpuvr_torch.dist.replicated import render_view_dp

    return render_view_dp(_t(grid, device), cam, mesh, cfg, device=device)


def scaling_case(mesh, *, device, grid, cam, cfg, min_wall):
    """``bench.sweep.scaling_table`` of a numpy grid over the mesh."""
    from tpuvr_torch.bench.sweep import scaling_table

    return scaling_table(_t(grid, device), cam, cfg, min_wall=min_wall,
                         mesh=mesh, device=device)


def sweep_grad_case(mesh, *, device, grid_sc, coeffs, enables, dt, d_rgb,
                    d_t, views, reverse, bwd_chunks=1, ring_chunks=None,
                    eps=0.0, softplus=False):
    """The gradient of ``sweep_op`` summed over the mesh, each rank
    sweeping rows [r V/n, (r + 1) V/n) of every view: ``dt`` is
    (views, V, U), the cotangents (3, views, V, U) and (views, V, U), the
    coefficients and enables (S,) for one view or (views, S). With
    ``ring_chunks`` through the ring backward, else slab by slab
    (``bwd_chunks`` slabs) in stream order; ``eps`` is the early-stop
    threshold, ``softplus`` the op's raw-density switch."""
    from tpuvr_torch.ops.vjp import sweep_op

    n_v = dt.shape[1]
    v_l = n_v // mesh.world
    rows = slice(mesh.rank * v_l, (mesh.rank + 1) * v_l)
    if ring_chunks is None:
        kw = dict(bwd_chunks=bwd_chunks, mesh=mesh)
    else:
        kw = dict(ring=(mesh, mesh.world, ring_chunks))
    op = sweep_op(reverse, 1.0, eps, "torch", views=views, row0=rows.start,
                  softplus=softplus, **kw)
    g = _t(grid_sc, device).requires_grad_(True)
    rgb, trans = op(g, tuple(_t(c, device) for c in coeffs),
                    _t(enables, device),
                    _t(dt[:, rows], device).flatten(0, 1))
    d_rgb = _t(d_rgb[:, :, rows], device).flatten(1, 2)
    d_t = _t(d_t[:, rows], device).flatten(0, 1)
    (grad,) = torch.autograd.grad((rgb, trans), g, (d_rgb, d_t))
    return grad


def row_tile(args, views, mesh):
    """This rank's rows [r V/n, (r + 1) V/n) of every view of a sweep's
    inputs (grid, coefficients, enables, dt planes stacked along V): the
    inputs with the dt planes cut to the rows, and the first row (the
    sweeps' ``row0``)."""
    grid_sc, coeffs, enables, dt = args
    v_pv = dt.shape[0] // views
    v_l = v_pv // mesh.world
    r0 = mesh.rank * v_l
    dt = dt.reshape(views, v_pv, -1)[:, r0:r0 + v_l].flatten(0, 1)
    return (grid_sc, coeffs, enables, dt.contiguous()), r0


def ring_case(mesh, *, device, grid_sc, coeffs, enables, dt, views, reverse,
              ring_chunks, seed=0, eps=0.0, softplus=False):
    """The ring backward of this rank's row tile (``dt`` (views * V, U),
    the coefficients and enables (S,) or (views, S)) against the backward
    in one call then one all-reduce, on random cotangents, with early ray
    termination at ``eps`` and the raw-density ``softplus`` switch: (ring
    gradient, reference, {"k6": backward kernel launches, "ring": ring
    launches, "all_reduce": all-reduces} of the ring call)."""
    from tpuvr_torch.dist import init
    from tpuvr_torch.kernels import ring_bwd
    from tpuvr_torch.kernels import sweep as ksweep
    from tpuvr_torch.kernels import sweep_bwd as kbwd

    args, row0 = row_tile((_t(grid_sc, device),
                           tuple(_t(c, device) for c in coeffs),
                           _t(enables, device), _t(dt, device)), views, mesh)
    kw = dict(reverse=reverse, views=views, row0=row0, early_stop_eps=eps,
              softplus=softplus)
    rgb, trans = ksweep.sweep_fwd(*args, **kw)
    gen = torch.Generator(device=device).manual_seed(seed + mesh.rank)
    d_rgb = torch.randn(rgb.shape, generator=gen, device=device)
    d_t = torch.randn(trans.shape, generator=gen, device=device)
    ref = kbwd.sweep_bwd(*args, rgb, trans, d_rgb, d_t, **kw)
    init.all_reduce(ref, mesh)
    k6, ring, reduced = (sum(kbwd.launches.values()), ring_bwd.launches,
                         init.collectives["all_reduce"])
    got = ring_bwd.sweep_bwd_ring(*args, rgb, trans, d_rgb, d_t, mesh=mesh,
                                  ring_size=mesh.world,
                                  ring_chunks=ring_chunks, **kw)
    return got, ref, {
        "k6": sum(kbwd.launches.values()) - k6,
        "ring": ring_bwd.launches - ring,
        "all_reduce": init.collectives["all_reduce"] - reduced}


class CaptureGrad:
    """An optimizer whose state after a step is the step's gradient."""

    def init(self, params):
        return None

    def update(self, grads, state):
        return torch.zeros_like(grads), grads


def step_case(mesh, *, device, key, n_views, render_cfg, params, stacked,
              targets, pick, r0s, density_softplus=True, **step_kw):
    """One ``make_train_step`` step on the mesh from raw ``params``, with
    density through softplus or not: (loss, gradient)."""
    from tpuvr_torch.train.fit import make_train_step

    step = make_train_step(key, n_views, CaptureGrad(), render_cfg,
                           density_softplus, None, mesh=mesh, **step_kw)
    geom = {k: _t(v, device) for k, v in stacked.items()}
    _, grad, loss = step(_t(params, device), None, geom,
                         _t(targets, device), pick, r0s)
    return float(loss), grad


def fit_case(mesh, *, device, targets, cams, grid_shape, cfg, render_cfg,
             run_dir, **fit_kw):
    """``fit_grid`` on the mesh (rank 0 writes to ``run_dir``): the loss
    history and the final raw parameters."""
    from tpuvr_torch.train.fit import fit_grid

    _, params, hist = fit_grid(targets, cams, grid_shape, cfg, render_cfg,
                               mesh=mesh, run_dir=run_dir, device=device,
                               **fit_kw)
    return hist["loss"], params


def traced_case(mesh, *, device, fn, **kwargs):
    """``fn(mesh, device=device, **kwargs)`` with spans on
    (``tpuvr_torch.utils.trace.recording``): (its result, this rank's
    snapshot)."""
    from tpuvr_torch.utils import trace

    with trace.recording():
        out = fn(mesh, device=device, **kwargs)
    return out, trace.snapshot()


def resume_case(mesh, *, device, run_dirs, **fit_kw):
    """:func:`fit_case` with ``resume=True``, rank r reading and writing
    ``run_dirs[r]`` (ranks on hosts that share no directory)."""
    return fit_case(mesh, device=device, run_dir=run_dirs[mesh.rank],
                    resume=True, **fit_kw)


def fog_params(grid_shape, device):
    """c5's starting raw parameters (``tools/c5_train.py``): a faint
    uniform fog, every emission channel 0.5 and density 0.01. With
    ``density_softplus=False`` the raw density is the density, and from
    zeros its relu would pass no gradient."""
    params = torch.full(tuple(grid_shape), 0.5, dtype=torch.float32,
                        device=device)
    params[..., 0] = 0.01
    return params


def launch_counts():
    """This process's kernel launches and counted collectives so far
    (:func:`tpuvr_torch.utils.trace.launch_counts`) without the row warp's
    and the ring's, as a flat Counter: one-view sweeps ("sweep_fwd",
    "sweep_bwd"), view batches ("sweep_fwd_views", "sweep_bwd_views"), the
    light bake's launches by cluster size ("tau_sweep_c<size>",
    "tau_adj_c<size>"; size 0 counts the plane loop's planes) and the
    directions they swept ("tau_sweep_dirs", "tau_adj_dirs"), the lit
    grid's assembly ("light_apply_fwd", "light_apply_bwd", and
    "light_apply_fallback" for the ATen route), and each collective
    ("collective_<kind>"). Subtract two of them for what ran
    between."""
    from tpuvr_torch.utils import trace

    out = trace.launch_counts()
    for k in ("warp_rows_fwd", "warp_rows_bwd", "sweep_bwd_ring"):
        del out[k]
    return out


def _digest(t):
    """SHA-256 of a tensor's float32 bytes after ``+ 0.0`` (the sign of a
    zero does not count)."""
    arr = (t.detach() + 0.0).float().contiguous().cpu().numpy()
    return hashlib.sha256(arr.reshape(-1).view(np.uint8)).hexdigest()


def c5_case(mesh, *, device, scene_dir, cams, grid_shape, cfg, render_cfg,
            lighting, step_cfg, run_dir):
    """c5's lit fit on the data mesh (``tools/c5_train.py``'s shape) from
    the files of ``scene_dir``: ``targets.npy`` (the lit targets of
    ``cams``) and ``grad.pt`` (the first step's gradient on one device).
    Every rank calls it with the same arguments. Returns a dict:

    - the first step from the fog (:func:`fog_params`), the first view
      group's first view through ``make_train_step`` on the mesh at
      ``step_cfg`` with a capturing optimizer, the gradient summed in 4
      all-reduces (c5's ``mesh_cfg.grad_buckets``): its loss
      ("step_loss"), its largest difference from ``grad.pt`` as a share of
      max|grad.pt| ("grad_err_of_max"), its SHA-256 ("grad_digest"), and
      this rank's launches and collectives in it ("step_counts");
    - ``fit_grid`` on the mesh from the fog with ``cfg``, ``render_cfg``
      and ``lighting``, its gradient in 4 all-reduces (rank 0 writes to
      ``run_dir``): "loss", "step_ms", the final raw parameters' SHA-256
      ("params_digest"), this rank's launches and collectives
      ("fit_counts") and, on the card, its peak memory ("peak_gib") and
      what the rank held before it ("held_gib": the targets and the
      fog).
    """
    from tpuvr_torch.train.fit import fit_grid, group_views, make_train_step

    on_card = torch.device(device).type == "cuda"
    targets = torch.as_tensor(np.load(os.path.join(scene_dir, "targets.npy")),
                              device=device)
    params = fog_params(grid_shape, device)
    key, (idxs, stacked, _, plan) = sorted(group_views(
        cams, grid_shape, n_shards=mesh.world).items())[0]
    step = make_train_step(key, 1, CaptureGrad(), step_cfg,
                           cfg.density_softplus, None, lighting=lighting,
                           warp_tiling=plan, mesh=mesh)
    geom = {k: v.to(device) for k, v in stacked.items()}
    before = launch_counts()
    _, grad, loss = step(params, None, geom, targets[idxs], np.zeros(1, int),
                         np.zeros(1, np.int32))
    out = {"step_loss": float(loss), "step_counts": dict(launch_counts()
                                                         - before)}
    ref = torch.load(os.path.join(scene_dir, "grad.pt"), mmap=True,
                     weights_only=True).to(device)
    out["grad_err_of_max"] = (float((grad - ref).abs().max())
                              / float(ref.abs().max()))
    out["grad_digest"] = _digest(grad)
    del grad, ref, geom, step
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["held_gib"] = torch.cuda.memory_allocated() / 2**30
    before = launch_counts()
    _, params, hist = fit_grid(targets, cams, grid_shape, cfg, render_cfg,
                               mesh=mesh, run_dir=run_dir, device=device,
                               lighting=lighting, params_init=params)
    if on_card:
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out.update(loss=hist["loss"], step_ms=hist["step_ms"],
               fit_counts=dict(launch_counts() - before),
               finite=bool(torch.isfinite(params).all()),
               params_digest=_digest(params))
    return out


# The z-sharded grid. Each ('data', 'z') layout's mesh is made once per
# rank (making process groups is collective, and every rank runs the same
# cases in the same order).
_GRID_MESHES = {}


def _grid_mesh(layout):
    from tpuvr_torch.dist.init import grid_mesh

    if layout not in _GRID_MESHES:
        _GRID_MESHES[layout] = grid_mesh(*layout)
    return _GRID_MESHES[layout]


def zrender_case(mesh, *, device, layout, grid, cam, cfg, fold):
    """The z-sharded render of a numpy grid on the ``layout`` mesh with
    ``fold``: "all_gather" or "ring" (``render_view_zsharded``), or
    "retile" (``render_view_retiled``)."""
    return zrender(_grid_mesh(tuple(layout)), cam, cfg, fold,
                   device)(_t(grid, device))


def zstep_case(mesh, *, device, layout, key, n_views, render_cfg, params,
               stacked, targets, pick, r0s, rows=None):
    """One ``make_train_step_zsharded`` step on the ``layout`` mesh from
    raw (Z, Y, X, 4) ``params``, each rank passing its slab: (loss, the
    slab's gradient, the rank's part of it before the sum over
    ``'data'``)."""
    from tpuvr_torch.train.fit import make_train_step_zsharded

    from tpuvr_torch.train import fit

    zmesh = _grid_mesh(tuple(layout))
    sz = params.shape[0] // zmesh.shape["z"]
    slab = params[zmesh.z.rank * sz:(zmesh.z.rank + 1) * sz]
    step = make_train_step_zsharded(key, n_views, CaptureGrad(), render_cfg,
                                    True, None, zmesh, rows=rows)
    geom = {k: _t(v, device) for k, v in stacked.items()}
    # The rank's own gradient before its sum over 'data', for the sum's
    # roundoff bound.
    partial, reduce = [], fit.bucketed_all_reduce

    def record(grads, data, n_buckets):
        partial.append(grads.clone())
        return reduce(grads, data, n_buckets)

    fit.bucketed_all_reduce = record
    try:
        _, grad, loss = step(_t(slab, device), None, geom,
                             _t(targets, device), pick, r0s)
    finally:
        fit.bucketed_all_reduce = reduce
    return float(loss), grad, partial[0]


def zfit_case(mesh, *, device, layout, **fit_kw):
    """:func:`fit_case` on the ``layout`` mesh: the loss history and this
    rank's slab of the final raw parameters."""
    return fit_case(_grid_mesh(tuple(layout)), device=device, **fit_kw)


def zcollectives_case(mesh, *, device, layout):
    """The z mesh's exchanges on small tensors of this rank's values: a
    halo ``exchange`` over the flat ring (b -> b - 1), an ``all_to_all``
    over ``'z'``, ``all_gather`` over ``'z'`` and over ``'data'``, and the
    collectives they counted."""
    from tpuvr_torch.dist import init

    zmesh = _grid_mesh(tuple(layout))
    before = init.collectives.copy()
    x = torch.arange(6.0, device=device).reshape(2, 3) + 10 * zmesh.rank
    halo = init.exchange(x, [(b, b - 1) for b in range(1, zmesh.world)],
                         zmesh.flat)
    chunks = (torch.arange(2.0 * zmesh.n_z, device=device).reshape(
        zmesh.n_z, 2) + 100 * zmesh.rank)
    return (halo, init.all_to_all(chunks, zmesh.z),
            init.all_gather(x, zmesh.z), init.all_gather(x, zmesh.data),
            dict(init.collectives - before))


# Gradients of the distributed renders (the contract of
# ``tpuvr_torch.dist.init``: every rank differentiates the same loss of the
# same image).


def image_loss(rgb, trans):
    """The gradient tests' loss of an image: sum(rgb^2) + sum(T) (the JAX
    package's z render gradient tests)."""
    return (rgb * rgb).sum() + trans.sum()


def render_grad(render, grid, sum_mesh):
    """One forward and backward of ``image_loss(*render(g))`` for ``g`` a
    leaf copy of ``grid``: (rgb, trans, loss, the gradient, and the
    gradient's part on this rank before the backward's all-reduce over
    ``sum_mesh``: the tensor that all-reduce was handed, or the gradient
    itself when none ran), for the reduction's roundoff bound."""
    from tpuvr_torch.dist import init

    g = grid.detach().requires_grad_(True)
    rgb, trans = render(g)
    loss = image_loss(rgb, trans)
    partial, reduce = [], init.all_reduce

    def record(t, mesh, async_op=False):
        if mesh is sum_mesh:
            partial.append(t.clone())
        return reduce(t, mesh, async_op)

    init.all_reduce = record  # the backward's only all-reduces
    try:
        (grad,) = torch.autograd.grad(loss, g)
    finally:
        init.all_reduce = reduce
    return (rgb.detach(), trans.detach(), loss.detach(), grad,
            partial[0] if partial else grad)


def zrender(zmesh, cam, cfg, fold, device):
    """The z render with ``fold`` ("all_gather", "ring" or "retile") as a
    function of the grid."""
    from tpuvr_torch.dist.retile import render_view_retiled
    from tpuvr_torch.dist.sharded_grid import render_view_zsharded

    if fold == "retile":
        return lambda g: render_view_retiled(g, cam, zmesh, cfg,
                                             device=device)
    return lambda g: render_view_zsharded(g, cam, zmesh, cfg, device=device,
                                          fold=fold)


def _grad_case(render, grid, sum_mesh):
    """A forward-only call of ``render`` (a grid that needs no gradient),
    then one forward and backward (``render_grad``), each with this rank's
    launches and collectives."""
    before = launch_counts()
    with torch.no_grad():
        rgb, trans = render(grid)
    mid = launch_counts()
    g_rgb, g_t, loss, grad, partial = render_grad(render, grid, sum_mesh)
    return dict(fwd_rgb=rgb, fwd_t=trans, fwd_counts=dict(mid - before),
                rgb=g_rgb, t=g_t, loss=float(loss), grad=grad,
                partial=partial, counts=dict(launch_counts() - mid))


def zgrad_case(mesh, *, device, layout, grid, cam, cfg, fold):
    """The z render of a numpy grid on the ``layout`` mesh with ``fold``:
    a forward-only frame, then the gradient of ``image_loss`` with respect
    to the grid this rank passed (its slab's, zeros elsewhere) and its part
    before the sum over ``'data'`` (in the slab's sweep layout); the
    images, loss, and the launches and collectives of each call."""
    zmesh = _grid_mesh(tuple(layout))
    return _grad_case(zrender(zmesh, cam, cfg, fold, device),
                      _t(grid, device), zmesh.data)


def dpgrad_case(mesh, *, device, grid, cam, cfg):
    """``render_view_dp`` of a numpy grid over every rank: as
    :func:`zgrad_case`, the gradient the whole grid's, summed over the
    mesh, and its part the rank's own before that sum."""
    from tpuvr_torch.dist.replicated import render_view_dp

    return _grad_case(
        lambda g: render_view_dp(g, cam, mesh, cfg, device=device),
        _t(grid, device), mesh)


def geomgrad_case(mesh, *, device, grid, cam, cfg):
    """``render_with_geom`` of a numpy grid over every rank, from the
    camera's ``view_geometry`` at ``cfg.oversample``: as
    :func:`dpgrad_case`."""
    from tpuvr_torch.ops.geometry import view_geometry
    from tpuvr_torch.ops.render import render_with_geom

    axis, reverse, geom, band = view_geometry(cam, tuple(grid.shape),
                                              oversample=cfg.oversample)
    return _grad_case(
        lambda g: render_with_geom(g, geom, axis, reverse, cfg, mesh=mesh,
                                   band=band, device=device),
        _t(grid, device), mesh)


def fit_refusal_case(mesh, *, device, render_cfg):
    """``fit_grid`` on the mesh with a render config it must refuse: the
    ValueError's message (None if it ran) and the collectives this rank
    issued before it."""
    from tpuvr_torch.config import TrainConfig
    from tpuvr_torch.configs import front_ortho
    from tpuvr_torch.dist import init
    from tpuvr_torch.train.fit import fit_grid

    before = sum(init.collectives.values())
    try:
        fit_grid(np.zeros((1, 8, 8, 3), np.float32), [front_ortho(8, 8)],
                 (8, 8, 8, 4), TrainConfig(steps=1, ckpt_every=0),
                 render_cfg, mesh=mesh, device=device)
        message = None
    except ValueError as e:
        message = str(e)
    return message, sum(init.collectives.values()) - before


def grad_collectives_case(mesh, *, device, layout):
    """Each differentiable collective of ``tpuvr_torch.dist.init`` in f64,
    forward and backward, on small tensors of this rank's values and
    cotangents that differ from rank to rank (the same on every rank for
    ``gather_tiles``, as the gradient contract has it): {name: (output,
    the input's gradient, the cotangent, the collectives of the
    backward)}, over the
    ``layout`` mesh's ``'z'`` group and, for the rest, the flat mesh."""
    from tpuvr_torch.dist import init

    zmesh = _grid_mesh(tuple(layout))
    r = zmesh.rank
    f64 = dict(dtype=torch.float64, device=device)

    def run(fn, x, cot):
        x = x.requires_grad_(True)
        y = fn(x)
        before = init.collectives.copy()
        (grad,) = torch.autograd.grad(y, x, cot)
        return y.detach(), grad, cot, dict(init.collectives - before)

    def base(*shape):
        return torch.arange(float(np.prod(shape)), **f64).reshape(shape)

    n_z, n = zmesh.z.world, zmesh.world
    halo = [(b, b - 1) for b in range(1, n)]
    return {
        "all_gather": run(lambda x: init.all_gather(x, zmesh.z),
                          base(2, 3) + 10 * r,
                          base(n_z, 2, 3) * (r + 1) + 1000 * r),
        "all_to_all": run(lambda x: init.all_to_all(x, zmesh.z),
                          base(n_z, 2) + 100 * r,
                          base(n_z, 2) * (r + 2) - 7 * r),
        "exchange": run(lambda x: init.exchange(x, halo, zmesh.flat),
                        base(2, 3) + 10 * r, base(2, 3) * (r + 3) + 50 * r),
        "gather_tiles": run(lambda x: init.gather_tiles(x, zmesh.flat, 0),
                            base(2, 3) + 10 * r, base(2 * n, 3) * 3 + 1),
        "replicated": run(lambda x: init.replicated(x, zmesh.flat),
                          base(2, 3), base(2, 3) * (r + 1) + r),
    }
