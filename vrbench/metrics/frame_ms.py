"""The viewer window's wall time over all its frames."""


def read(ctx):
    return ctx["window_s"] / ctx["frames"] * 1e3
