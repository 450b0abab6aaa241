"""tpuvr_torch: the tpuvr plane-sweep volume renderer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It renders a (Z, Y, X, 4) density/emission voxel grid with the same plane
sweep, cameras, configs and outputs as the JAX package ``tpuvr``, which it
does not import, and fits one to posed views with the same gradients. The
entry points (``render_view``, ``prepare_grid`` and ``render_prepared`` in
``tpuvr_torch.ops.render``, ``light_volume`` in ``tpuvr_torch.ops.lighting``,
``fit_grid`` in ``tpuvr_torch.train.fit``) run on the card unless called
with ``device="cpu"``, which runs the plain PyTorch versions of the
kernels. The CUDA sources in ``csrc/`` are compiled at first use
(``tpuvr_torch.kernels._build``).

Layering (bottom-up): ref -> kernels -> ops -> train.
"""

__version__ = "0.1.0"

from tpuvr_torch.config import (  # noqa: F401
    LightingConfig,
    RenderConfig,
    TrainConfig,
)
