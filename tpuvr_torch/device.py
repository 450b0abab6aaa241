"""Device selection for the entry points.

Every entry point takes ``device``; ``None`` means the card. The plain
PyTorch versions of the kernels run only for an explicit ``device="cpu"``:
a missing card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_grad_requested(t: torch.Tensor) -> bool:
    """True where a CUDA kernel would be asked for a gradient it cannot
    give: the kernels have no backward yet, and a ctypes launch is
    invisible to autograd."""
    return t.is_cuda and torch.is_grad_enabled() and t.requires_grad


def check_no_cuda_grad(t: torch.Tensor, what: str) -> None:
    if cuda_grad_requested(t):
        raise NotImplementedError(
            f"{what} on the card has no gradient: backward lands with the "
            "training slice (run under torch.no_grad() or detach the input)"
        )
