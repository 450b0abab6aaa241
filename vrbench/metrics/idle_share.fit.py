"""Share of a fit's traced span in which no kernel ran on the card
(rank 0's, on a mesh)."""

from vrbench.readers import idle_share as read  # noqa: F401
