"""Share of the sweeps' least time in their device time, in a fit's
profiled call (:func:`vrbench.readers.sweep_roofline_fit`)."""

from vrbench.readers import sweep_roofline_fit as read  # noqa: F401
