"""What a run makes from its seed: the scene, the orbit's offset and the
fit's seed. The same seed gives the same inputs; every seed gives the same
amount of work (the scene's lobes move by a few voxels, the orbit turns by
a few degrees, and no view crosses to another sweep axis).
"""

from __future__ import annotations

import numpy as np
import torch

JITTER = 0.006  # the lobes' centres move within this share of the grid
AZIMUTH_DEG = (0.5, 5.0)  # the orbit's offset: no view changes sweep axis


class Draw:
    """The seeded numbers of one run."""

    def __init__(self, seed: int, grid_n: int):
        rng = np.random.default_rng(seed)
        j = JITTER * grid_n
        self.centre_shift = rng.uniform(-j, j, size=(2, 3))
        self.radius_scale = rng.uniform(0.98, 1.02, size=2)
        self.azimuth_deg = float(rng.uniform(*AZIMUTH_DEG))
        self.fit_seed = int(rng.integers(0, 2**31))
        self.rng = rng


def smoke_scene(n: int, draw: Draw, device) -> torch.Tensor:
    """(n, n, n, 4) smoke sphere: two Gaussian density lobes (one off
    centre; optical depth about 3.3 through the core) and an emission ramp,
    the lobes' centres and radii moved by the seed."""
    c = (n - 1) / 2.0
    ax = torch.arange(n, dtype=torch.float32, device=device)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    lobes = ((c, c, c, 0.3 * n, 6.0 / n),
             (c + 0.18 * n, c - 0.1 * n, c + 0.12 * n, 0.15 * n, 3.0 / n))
    sigma = torch.zeros_like(x)
    for (cx, cy, cz, r, amp), d, s in zip(lobes, draw.centre_shift,
                                          draw.radius_scale):
        cx, cy, cz = cx + d[0], cy + d[1], cz + d[2]
        r2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        sigma += amp * torch.exp(-r2 / (2.0 * (r * s) ** 2))
    ramp = (x + y + z) / (3.0 * max(n - 1, 1))
    return torch.stack([sigma, 0.9 * ramp + 0.1, 0.5 * torch.ones_like(ramp),
                        1.0 - 0.8 * ramp], dim=-1)
