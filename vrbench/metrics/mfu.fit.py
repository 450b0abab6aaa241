"""The whole fit step's share of the card's peak: the least time of its
stages over the untraced window's step_ms
(:func:`vrbench.readers.mfu_fit`)."""

from vrbench.readers import mfu_fit as read  # noqa: F401
