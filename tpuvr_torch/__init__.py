"""tpuvr_torch: the tpuvr plane-sweep volume renderer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It renders a (Z, Y, X, 4) density/emission voxel grid with the same plane
sweep, cameras, configs and outputs as the JAX package ``tpuvr``, which it
does not import, and fits one to posed views with the same gradients. The
entry points (``render_view``, ``prepare_grid``, ``render_prepared`` and
``render_with_geom`` in ``tpuvr_torch.ops.render``, ``light_volume`` in
``tpuvr_torch.ops.lighting``, ``fit_grid`` in ``tpuvr_torch.train.fit``, the
command line ``python -m tpuvr_torch.cli``) run on the card unless called
with ``device="cpu"``, which runs the plain PyTorch versions of the
kernels. The CUDA sources in ``csrc/`` are compiled at first use
(``tpuvr_torch.kernels._build``); ``io`` holds the volume and image files
(``native/volcodec.cpp``, built with g++ at first use) and the synthetic
scenes; ``entry`` a compile check and a multi-rank dry run.

Layering (bottom-up): ref -> kernels -> ops -> dist -> train -> bench/cli.
"""

__version__ = "0.1.0"

from tpuvr_torch.config import (  # noqa: F401
    LightingConfig,
    MeshConfig,
    RenderConfig,
    TrainConfig,
)
