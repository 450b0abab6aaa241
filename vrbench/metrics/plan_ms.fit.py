"""Host ms of one profiled ``fit_grid`` call's planning span over the
window's steps: what a call's planning adds to each step of ``step_ms``
(:func:`vrbench.spans.plan_ms_fit`)."""

from vrbench.spans import plan_ms_fit as read  # noqa: F401
