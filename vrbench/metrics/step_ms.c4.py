"""c4's step_ms, apart from the device-bound cells' because its
host-bound step spreads more from run to run: the fit window's wall time
over its steps."""

from vrbench.readers import step_ms as read  # noqa: F401
