"""The render configs c1-c3, the 256^3 @ 512^2 headline frame, the
training config c4 and the lit 512^3 config c5.

Each entry has the fields of the JAX package's ``configs/c1.py``-``c5.py``
and of its benchmark frame (``bench.py``: front ortho, ERT 1e-4, the bf16
'default' resample tier). c4 recovers a 256^3 grid from 64 orbit views at
256^2; it has no single camera (:func:`cameras` gives its views). c5 is a
512^3 grid at 1024^2, lit by 16 sky directions, on a ``'data'`` mesh of
every rank (``mesh_cfg.data`` 0); like the JAX config it has no training
entry (``tools/c5_train.py`` holds its training shape).
"""

from __future__ import annotations

from tpuvr_torch.config import (
    LightingConfig,
    MeshConfig,
    RenderConfig,
    TrainConfig,
)
from tpuvr_torch.ref.camera import OrthoCamera


def front_ortho(n: int, res: int) -> OrthoCamera:
    """Axis-aligned orthographic view along +z covering the grid."""
    c = (n - 1) / 2.0
    return OrthoCamera(
        center=(c, c, -2.0 * n), forward=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0), width=1.4 * n, height=1.4 * n,
        res_x=res, res_y=res,
    )


def orbit_persp(n: int, res: int):
    """The first orbit camera: perspective, 20 degrees above the grid."""
    from tpuvr_torch.io.synth import orbit_cameras

    return orbit_cameras(1, n, res=res)[0]


CAMERAS = {"front_ortho": front_ortho, "orbit_persp": orbit_persp}

CONFIGS = {
    "c1": {
        "name": "c1",
        "grid_n": 64,
        "res": 256,
        "camera": "front_ortho",
        "render": RenderConfig(early_stop_eps=0.0, use_occupancy=False),
        "lighting": None,
    },
    "c2": {
        "name": "c2",
        "grid_n": 128,
        "res": 256,
        "camera": "orbit_persp",
        "render": RenderConfig(early_stop_eps=1e-4, use_occupancy=True),
        "lighting": None,
    },
    "c3": {
        "name": "c3",
        "grid_n": 256,
        "res": 512,
        "camera": "orbit_persp",
        "render": RenderConfig(early_stop_eps=1e-4, use_occupancy=True),
        "lighting": LightingConfig(mode="lightvolume", n_samples=16),
    },
    "headline": {
        "name": "headline",
        "grid_n": 256,
        "res": 512,
        "camera": "front_ortho",
        "render": RenderConfig(early_stop_eps=1e-4, precision="default"),
        "lighting": None,
    },
    "c4": {
        "name": "c4",
        "grid_n": 256,
        "res": 256,
        "n_views": 64,
        "camera": None,
        "render": RenderConfig(early_stop_eps=0.0, use_occupancy=True),
        "lighting": None,
        "train": TrainConfig(lr=5e-2, steps=2000, views_per_batch=8,
                             ckpt_every=200),
        # Ray data parallelism over every rank, one rank per card:
        # fit_grid(mesh=tpuvr_torch.dist.data_mesh()) on each; one card
        # trains without a mesh.
        "mesh": "data",
    },
    "c5": {
        "name": "c5",
        "grid_n": 512,
        "res": 1024,
        "camera": "orbit_persp",
        "render": RenderConfig(early_stop_eps=1e-4, use_occupancy=True),
        "lighting": LightingConfig(mode="lightvolume", n_samples=16),
        # Rays sharded over every rank (data=0: all of them), the grid
        # replicated on each: fit_grid(mesh=tpuvr_torch.dist.data_mesh(),
        # grad_buckets=mesh_cfg.grad_buckets).
        "mesh_cfg": MeshConfig(data=0, zshard=1, grad_buckets=4),
        "multihost": True,
        "scaling_sweep": True,
    },
}


def camera(cfg: dict, n: int | None = None, res: int | None = None):
    """The config's camera, optionally at a reduced grid size and
    resolution."""
    if cfg["camera"] is None:
        raise ValueError(f"{cfg['name']} has no single camera; use cameras()")
    return CAMERAS[cfg["camera"]](n or cfg["grid_n"], res or cfg["res"])


def cameras(cfg: dict, n: int | None = None, res: int | None = None,
            n_views: int | None = None):
    """A training config's posed views: ``n_views`` orbit cameras,
    optionally at a reduced grid size, resolution and count."""
    from tpuvr_torch.io.synth import orbit_cameras

    return orbit_cameras(n_views or cfg["n_views"], n or cfg["grid_n"],
                         res=res or cfg["res"])
