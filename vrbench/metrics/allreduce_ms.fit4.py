"""Rank 0's device ms per profiled step in NCCL's kernels (the gradient's
bucketed all-reduces and the tiles' gather), on a mesh."""

from vrbench.trace import is_nccl


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if is_nccl(name))
    if ctx["kind"] != "fit" or t <= 0:
        return None
    return t * 1e3 / ctx["trace_steps"]
