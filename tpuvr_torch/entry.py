"""Two whole-program checks: a forward render for a compile check, and one
training step on a multi-rank mesh.

``entry()`` returns a forward render of the 64^3 smoke sphere at 256^2
(the sweep kernel's main path) with its example argument.

``dryrun_multichip(n)`` starts ``n`` ranks and takes one Adam step on a
``('data', 'z')`` mesh (rays row-sharded over ``'data'``, the grid
slab-sharded over ``'z'``, the segments folded across ranks), with the
loss through the differentiable ``render_view_zsharded``; then the ring
backward on a ``'data'`` mesh of every rank. It returns what each rank
computed, for holding against one process.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvr_torch.config import RenderConfig

DRYRUN_GRID = 8
DRYRUN_VIEWS = 2
DRYRUN_LR = 1e-2


def entry(device=None):
    """(fn, (grid,)): ``fn(grid)`` renders the front orthographic view of
    the 64^3 smoke sphere at 256^2 and returns its rgb (256, 256, 3).
    ``device`` is the entry points' (None: the card)."""
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops.render import render_view
    from tpuvr_torch.ref.camera import OrthoCamera

    n = 64
    grid = smoke_sphere(n, device=device)
    c = (n - 1) / 2.0
    cam = OrthoCamera(
        center=(c, c, -2.0 * n),
        forward=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
        width=1.4 * n,
        height=1.4 * n,
        res_x=256,
        res_y=256,
    )
    cfg = RenderConfig()

    def fn(grid):
        rgb, _ = render_view(grid, cam, cfg, device=device)
        return rgb

    return fn, (grid,)


def dryrun_layout(n_ranks: int):
    """(n_data, n_z): two z slabs when the ranks are even, else one."""
    n_z = 2 if n_ranks % 2 == 0 else 1
    return n_ranks // n_z, n_z


def dryrun_scene(n_data: int):
    """The step's grid edge, its views (orbit cameras whose rows the
    'data' ranks divide) and render config."""
    from tpuvr_torch.io.synth import orbit_cameras

    res = max(8, n_data)
    res = res if res % n_data == 0 else res * n_data
    cams = orbit_cameras(DRYRUN_VIEWS, DRYRUN_GRID, res=res)
    return DRYRUN_GRID, cams, RenderConfig(early_stop_eps=0.0)


def dryrun_start(grid_shape, device):
    """The step's starting parameters: a faint fog (density 0.01, emission
    0.5). From zeros, as the JAX package's dry run starts, every slice is
    empty and skipped by occupancy, and the step moves nothing."""
    from tpuvr_torch.dist.workers import fog_params

    return fog_params(grid_shape, device)


def image_loss(render, params, cams, targets):
    """The mean over views of ``mean((rgb - target)^2)``."""
    total = 0.0
    for cam, target in zip(cams, targets):
        rgb, _ = render(params, cam)
        total = total + torch.mean((rgb - target) ** 2)
    return total / len(cams)


def ring_inputs(grid, cam, device):
    """The ring leg's sweep: (plan, grid_sc, coeffs, enables, dt) of
    ``cam`` over ``grid``, occupancy on, eps 0."""
    from tpuvr_torch.ops.geometry import (
        plan_sweep,
        plan_valid_mask,
        ray_dt,
        slice_coeffs,
    )
    from tpuvr_torch.ops.render import grid_to_sweep_layout, slice_enables
    from tpuvr_torch.ref.camera import dominant_axis

    axis = dominant_axis(cam)
    plan, _ = plan_sweep(cam, tuple(grid.shape[:3]), axis)
    grid_sc = grid_to_sweep_layout(grid, axis)
    enables = slice_enables(grid_sc, plan.reverse, True)
    enables = enables * plan_valid_mask(plan, grid.dtype, device)
    return (plan, grid_sc, slice_coeffs(plan, grid.dtype, device), enables,
            ray_dt(plan, grid.dtype, device))


def dryrun_rank(n_ranks: int, device_type: str):
    """One rank of :func:`dryrun_multichip` (``torch.distributed`` is up;
    ``device_type`` "cuda" runs on the rank's current card).

    Every rank holds the whole parameter grid and takes the same loss;
    the z render's gradient is the rank's slab's, summed over its
    ``'data'`` ranks, so one all-reduce over ``'z'`` gives every rank the
    whole gradient before Adam. Returns {"loss", "slab" (the rank's z
    slab of the updated parameters, rows of Z), "z", "digest" (SHA-256 of
    the slab), "grad" (the step's whole gradient), "ring_grad" (the ring
    backward's gradient in sweep layout, None when the rows or the grid do
    not split over the ranks), "launches" (this rank's kernel launches
    and collectives, by name)}.
    """
    from tpuvr_torch.dist import workers
    from tpuvr_torch.dist.init import all_reduce, grid_mesh
    from tpuvr_torch.dist.sharded_grid import render_view_zsharded
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops.vjp import resolve_impl, sweep_op
    from tpuvr_torch.train.fit import Adam

    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    before = workers.launch_counts()
    n_data, n_z = dryrun_layout(n_ranks)
    mesh = grid_mesh(n_data, n_z)
    n, cams, cfg = dryrun_scene(n_data)

    def render(g, cam):
        return render_view_zsharded(g, cam, mesh, cfg, device=device)

    grid_true = smoke_sphere(n, device=device)
    with torch.no_grad():
        targets = [render(grid_true, cam)[0] for cam in cams]
    params = dryrun_start(grid_true.shape, device).requires_grad_(True)
    opt = Adam(DRYRUN_LR)
    state = opt.init(params)
    loss = image_loss(render, params, cams, targets)
    (grad,) = torch.autograd.grad(loss, params)
    all_reduce(grad, mesh.z)
    updates, state = opt.update(grad, state)
    new = params.detach() + updates
    sz = n // n_z
    d = mesh.z.rank
    slab = new[d * sz:(d + 1) * sz]
    out = {"loss": float(loss.detach()), "z": d, "slab": slab,
           "digest": workers._digest(slab), "grad": grad,
           "ring_grad": None}

    # Second leg: the ring backward over every rank, each sweeping its
    # rows of the first view, the gradient of sum(rgb^2) summed in slabs.
    plan, grid_sc, coeffs, enables, dt = ring_inputs(grid_true, cams[0],
                                                     device)
    if n % n_ranks == 0 and plan.n_v % n_ranks == 0:
        rows = plan.n_v // n_ranks
        r0 = mesh.rank * rows
        op = sweep_op(plan.reverse, 1.0, 0.0, resolve_impl(None, grid_sc),
                      row0=r0, ring=(mesh.flat, n_ranks, 1))
        g = grid_sc.clone().requires_grad_(True)
        rgb, _ = op(g, coeffs, enables, dt[r0:r0 + rows])
        (out["ring_grad"],) = torch.autograd.grad(torch.sum(rgb**2), g)
    out["launches"] = dict(workers.launch_counts() - before)
    return out


def dryrun_reference(n_ranks: int, device=None):
    """What :func:`dryrun_multichip` computes, on one process: the step's
    loss, whole gradient and updated parameters through ``render_view``
    and the port's Adam, and the ring leg's gradient through one backward
    over every row. Tensors as numpy arrays."""
    from tpuvr_torch.device import resolve_device
    from tpuvr_torch.io.synth import smoke_sphere
    from tpuvr_torch.ops.render import render_view
    from tpuvr_torch.ops.vjp import resolve_impl, sweep_op
    from tpuvr_torch.train.fit import Adam

    dev = resolve_device(device)
    n, cams, cfg = dryrun_scene(dryrun_layout(n_ranks)[0])

    def render(g, cam):
        return render_view(g, cam, cfg, device=dev)

    truth = smoke_sphere(n, device=dev)
    with torch.no_grad():
        targets = [render(truth, cam)[0] for cam in cams]
    params = dryrun_start(truth.shape, dev).requires_grad_(True)
    opt = Adam(DRYRUN_LR)
    loss = image_loss(render, params, cams, targets)
    (grad,) = torch.autograd.grad(loss, params)
    updates, _ = opt.update(grad, opt.init(params))
    plan, grid_sc, coeffs, enables, dt = ring_inputs(truth, cams[0], dev)
    op = sweep_op(plan.reverse, 1.0, 0.0, resolve_impl(None, grid_sc))
    g = grid_sc.clone().requires_grad_(True)
    rgb, _ = op(g, coeffs, enables, dt)
    (ring_grad,) = torch.autograd.grad(torch.sum(rgb**2), g)
    return {"loss": float(loss.detach()), "grad": grad.cpu().numpy(),
            "params": (params.detach() + updates).cpu().numpy(),
            "ring_grad": ring_grad.cpu().numpy()}


def dryrun_multichip(n_ranks: int, device=None, timeout_s: float = 600.0):
    """One training step over ``n_ranks`` ranks, then the ring backward
    (see the module docstring). ``device`` None is the card: NCCL with a
    card a rank when there are at least ``n_ranks`` cards, else gloo ranks
    sharing them (card r modulo the count); "cpu" is gloo on the CPU.
    Returns each rank's :func:`dryrun_rank` result (tensors as numpy
    arrays), in rank order; raises if a rank fails or its loss, update or
    gradients are not finite."""
    from tpuvr_torch.device import resolve_device
    from tpuvr_torch.dist.launch import spawn

    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_ranks else "gloo")
    out = spawn(dryrun_rank, n_ranks, backend, dev.type, (n_ranks, dev.type),
                timeout_s=timeout_s)
    for r, res in enumerate(out):
        finite = [np.isfinite(res["loss"]), np.isfinite(res["slab"]).all(),
                  np.isfinite(res["grad"]).all()]
        if res["ring_grad"] is not None:
            finite.append(np.isfinite(res["ring_grad"]).all())
        if not all(finite):
            raise FloatingPointError(f"rank {r}: non-finite loss, update "
                                     f"or gradient in the dry run")
    return out
