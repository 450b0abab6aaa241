"""Hand-over of data from the JAX package.

A renderer's parameters are its voxel grid, so a grid, a camera and a
trainer's state are what cross over. They arrive as plain data: a
(Z, Y, X, 4) array (for example ``np.asarray`` of a JAX array), a
camera's dataclass fields, and the arrays of an Adam state.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvr_torch.device import resolve_device
from tpuvr_torch.ref.camera import OrthoCamera, PerspectiveCamera


def grid_from_numpy(arr, device=None, dtype=torch.float32):
    """(Z, Y, X, 4) array -> a contiguous copy on ``device`` (``None``
    means the card). Copying leaves the source (often a read-only view of
    a JAX array) untouched."""
    a = np.asarray(arr)
    if a.ndim != 4 or a.shape[-1] != 4:
        raise ValueError(f"expected a (Z, Y, X, 4) grid, got {a.shape}")
    return torch.tensor(a, dtype=dtype, device=resolve_device(device))


_CAMERAS = {"OrthoCamera": OrthoCamera,
            "PerspectiveCamera": PerspectiveCamera}


def camera_from_fields(kind: str, **fields):
    """Build a camera from another camera's dataclass fields.

    ``kind`` is the camera's class name ('OrthoCamera' or
    'PerspectiveCamera'). Vector fields become tuples of floats so the
    camera stays hashable.
    """
    if kind not in _CAMERAS:
        raise ValueError(f"unknown camera kind {kind!r}")
    out = {}
    for k, v in fields.items():
        if isinstance(v, (tuple, list, np.ndarray)):
            v = tuple(float(x) for x in v)
        out[k] = v
    return _CAMERAS[kind](**out)


def train_state_from_numpy(params, mu, nu, count, device=None):
    """The JAX trainer's state -> this package's ``fit_grid`` state.

    ``params``: raw (Z, Y, X, 4) parameters; ``mu``, ``nu``, ``count``:
    the fields of optax's ``ScaleByAdamState`` (as numpy). Returns
    (params, (mu, nu, count)) with the tensors on ``device`` (``None``
    means the card), for ``fit_grid(params_init=...)`` or an Adam step.
    """
    params, mu, nu = (grid_from_numpy(a, device) for a in (params, mu, nu))
    return params, (mu, nu, int(np.asarray(count)))
