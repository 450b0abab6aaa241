"""Mean host ms of a profiled fit step from its entry to its return,
waits on the card included, read from the system's own step records
(:func:`vrbench.spans.issue_ms`)."""

from vrbench.spans import issue_ms as read  # noqa: F401
