"""Device ms per profiled shadow-fit step in every kernel that is neither
the system's own (``tpuvr_torch/csrc``) nor NCCL's: Adam's passes and the
undetached light's ATen passes (the light volume's exponentials and sum,
the lit grid's multiply and their backward, the adjoint's copies, relu
masks and sum), memcpy and memset. It reads against ``passes_ms.fit``."""

from vrbench.trace import is_nccl


def read(ctx):
    if ctx["kind"] != "shadowfit" or not ctx.get("trace_steps"):
        return None
    t = sum(s for name, s in ctx["trace"]["by_kernel"].items()
            if name not in ctx["kernels"] and not is_nccl(name))
    return t * 1e3 / ctx["trace_steps"]
