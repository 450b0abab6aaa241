"""Process start to the window: imports, the build where a checkout has
none, the inputs, the reference's targets and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
