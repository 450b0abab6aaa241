"""Frozen config dataclasses: the same fields and defaults as the JAX
package's ``RenderConfig``, ``LightingConfig``, ``MeshConfig`` and
``TrainConfig``.

Fields that select paths this package does not run yet are kept so that a
config moves across unchanged; the render path raises on the values it
cannot honour instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Ray-march discretization and termination.

    Attributes:
      mode: 'plane_sweep' samples where rays cross the integer planes of
        the dominant axis (one grid slice per step). 'fixed_dt' is the
        per-pixel oracle marcher (``render_view`` only).
      precision: resample arithmetic. 'highest' is true f32; 'high' is the
        3-term bf16 split (about 1e-6 relative); 'default' rounds weights,
        values and the row-stage partial to bf16 and sums in f32 (about
        5e-3 image error).
      step_dt, max_steps: 'fixed_dt' parameters.
      early_stop_eps: transmittance threshold for early ray termination;
        0 disables it.
      ert_chunks: slab chunks of the slice axis for whole-slab early
        termination (with early_stop_eps > 0); 1 disables it.
      use_occupancy: skip slices whose maximum density is <= 0 (lossless).
      occupancy_brick: brick edge of the occupancy grid (unused by the
        slice-level skip).
      sigma_scale: multiplier on density before alpha conversion.
      tmin: 'fixed_dt' ray start.
      max_rows_per_call: intermediate rows per sweep call; larger frames
        are row-chunked. None disables chunking.
      oversample: intermediate-lattice density for non-separable cameras.
    """

    mode: str = "plane_sweep"
    precision: str = "highest"
    step_dt: float = 0.5
    max_steps: Optional[int] = None
    early_stop_eps: float = 1e-4
    ert_chunks: int = 1
    use_occupancy: bool = True
    occupancy_brick: int = 8
    sigma_scale: float = 1.0
    tmin: float = 0.0
    max_rows_per_call: Optional[int] = 512
    oversample: float = 1.0


@dataclasses.dataclass(frozen=True)
class LightingConfig:
    """Hemisphere-sampled single-scatter lighting.

    Attributes:
      mode: 'none', or 'lightvolume' (a sky-transmittance volume from
        ``n_samples`` directional tau sweeps, multiplied into the emission
        channels), or 'persample' (the exact oracle: true secondary
        marches from every voxel centre).
      n_samples: hemisphere directions.
      sky_intensity: radiance of the sky dome.
      up: world up axis (x, y, z) of the hemisphere.
      secondary_dt: step of the 'persample' marcher.
      detach: True stops gradients at the light volume; False
        differentiates the shadows too (through the tau sweeps' adjoint).
    """

    mode: str = "none"
    n_samples: int = 16
    sky_intensity: float = 1.0
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    secondary_dt: float = 1.0
    detach: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Rank layout of the distributed paths (``tpuvr_torch.dist``).

    Attributes:
      data: ranks sharding rays (the replicated-grid data-parallel path).
      zshard: ranks sharding the grid in z-slabs (the ``'z'`` axis of
        ``tpuvr_torch.dist.grid_mesh(data, zshard)``); 1 disables grid
        sharding.
      grad_buckets: all-reduces the grid gradient is cut into after the
        backward (the reduction that does not overlap it).
      bwd_chunks: slabs the backward sweep is cut into; > 1 all-reduces
        each slab's gradient as it comes out, in stream order. 1 disables
        chunking.
      grad_ring: the ring backward (``tpuvr_torch.kernels.ring_bwd``):
        each slab's all-reduce overlaps the next slab's backward kernel.
        ``bwd_chunks`` doubles as its slab count.
    """

    data: int = 1
    zshard: int = 1
    grad_buckets: int = 4
    bwd_chunks: int = 1
    grad_ring: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Inverse-rendering loop (``tpuvr_torch.train.fit.fit_grid``).

    Attributes:
      lr: Adam learning rate on the voxel grid.
      steps: optimization steps.
      views_per_batch: posed views per minibatch.
      rays_per_view: if set, render only a row band of about this many
        rays per view per step.
      ckpt_every: checkpoint interval in steps (0 disables).
      ckpt_dir: checkpoint (and metrics) directory when ``fit_grid`` gets
        no ``run_dir``.
      ckpt_bf16: store f32 state as bf16 in checkpoints (half the bytes;
        restore casts back, one bf16 rounding per resume).
      seed: seed of the minibatch draws.
      density_softplus: parameterize density through softplus.
      steps_per_call: steps of one view group run back to back before the
        next group; > 1 also lets ``fit_grid`` keep the training state in
        the group's sweep layout (the fused-softplus mode). Metrics and
        checkpoints land at block boundaries.
    """

    lr: float = 1e-1
    steps: int = 500
    views_per_batch: int = 8
    rays_per_view: Optional[int] = None
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/tpuvr_ckpt"
    ckpt_bf16: bool = False
    seed: int = 0
    density_softplus: bool = True
    steps_per_call: int = 1
