"""Mean host ms a profiled frame spends in ``render_prepared``'s planning
span, before its sweep is issued (:func:`vrbench.spans.plan_ms_view`)."""

from vrbench.spans import plan_ms_view as read  # noqa: F401
