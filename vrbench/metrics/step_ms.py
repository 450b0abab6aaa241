"""The fit window's wall time on the host clock, ended by a synchronize,
over its steps: every step and all the time between them."""

from vrbench.readers import step_ms as read  # noqa: F401
