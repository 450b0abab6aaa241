"""The roofline model, the scaling table and the benchmark's judged core
(``tpuvr_torch.bench.judged``)."""

from tpuvr_torch.bench.roofline import (  # noqa: F401
    CHIPS,
    roofline_report,
    sweep_cost,
)
