"""Distribution over ranks: one process per card, ``torch.distributed``.

- :mod:`tpuvr_torch.dist.init`: :func:`initialize`, the meshes of ranks
  (:class:`DataMesh`, :func:`data_mesh`; the ``('data', 'z')``
  :class:`GridMesh`, :func:`grid_mesh`) and the counted collectives
  (:func:`bucketed_all_reduce` among them), differentiable where the
  renders need them, with the gradient contract of the distributed
  renders;
- :mod:`tpuvr_torch.dist.replicated`: ray data parallelism over a
  replicated grid (``render_view_dp``, differentiable; the trainer's mesh
  step is in ``tpuvr_torch.train.fit``);
- :mod:`tpuvr_torch.dist.sharded_grid` and :mod:`tpuvr_torch.dist.retile`:
  the z-sharded grid's differentiable render and its segment folds (the
  trainer's z step is in ``tpuvr_torch.train.fit``);
- :mod:`tpuvr_torch.dist.launch`: ``spawn``, ranks on one host.
"""

from tpuvr_torch.dist.init import (  # noqa: F401
    DataMesh,
    GridMesh,
    bucketed_all_reduce,
    data_mesh,
    grid_mesh,
    initialize,
)
