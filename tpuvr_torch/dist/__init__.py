"""Distribution over ranks: one process per card, ``torch.distributed``.

- :mod:`tpuvr_torch.dist.init`: :func:`initialize`, the mesh of ranks
  (:class:`DataMesh`, :func:`data_mesh`) and the counted collectives
  (:func:`bucketed_all_reduce` among them);
- :mod:`tpuvr_torch.dist.replicated`: ray data parallelism over a
  replicated grid (``render_view_dp``; the trainer's mesh step is in
  ``tpuvr_torch.train.fit``);
- :mod:`tpuvr_torch.dist.launch`: ``spawn``, ranks on one host.
"""

from tpuvr_torch.dist.init import (  # noqa: F401
    DataMesh,
    bucketed_all_reduce,
    data_mesh,
    initialize,
)
