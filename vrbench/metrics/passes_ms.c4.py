"""Device ms per profiled fit step in every kernel that is neither the
system's own nor NCCL's (:func:`vrbench.readers.passes_ms_fit`)."""

from vrbench.readers import passes_ms_fit as read  # noqa: F401
