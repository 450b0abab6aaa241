"""``torch.cuda.max_memory_allocated()`` from the inputs' end to the
run's, the largest rank's on a mesh."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
