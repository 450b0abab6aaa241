"""Mean host ms from a frame's request to ``render_prepared``'s return,
before the image is copied out, over the untraced window's frames (a span
in the benchmark's own loop)."""


def read(ctx):
    if ctx["kind"] != "view" or ctx.get("issue_s") is None:
        return None
    return 1e3 * float(sum(ctx["issue_s"])) / len(ctx["issue_s"])
