"""Share of a shadow fit's traced span in which no kernel ran on the
card."""

from vrbench.readers import idle_share as read  # noqa: F401
