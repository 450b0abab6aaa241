"""Host ms of one profiled c4 ``fit_grid`` call's planning span over the
window's steps: what a call's planning adds to each step of
``step_ms.c4`` (:func:`vrbench.spans.plan_ms_fit`)."""

from vrbench.spans import plan_ms_fit as read  # noqa: F401
