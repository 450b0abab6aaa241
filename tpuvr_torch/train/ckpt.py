"""Checkpoint and resume with ``torch.save``.

A checkpoint is ``<dir>/step_<N>.pt`` holding ``{"step": N, "state": ...}``
with the state's tensors on the CPU; the trainer saves its state in the
canonical (Z, Y, X, 4) layout, so a resume does not depend on the layout
a run kept its state in.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

_NAME = re.compile(r"step_(\d+)\.pt$")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn, tree, like):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, a, b) for a, b in zip(tree, like))
    return fn(tree, like)


class Checkpointer:
    """Saves ``{params, opt_state}`` trees every few steps and restores the
    latest; keeps the newest ``max_to_keep`` files."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def save(self, step: int, state: Any, cast_bf16: bool = False):
        """Save ``state``; ``cast_bf16`` stores f32 tensors as bf16 (half
        the bytes; restore casts back to the target's dtype)."""
        def host(x):
            if not torch.is_tensor(x):
                return x
            x = x.detach()
            if cast_bf16 and x.dtype == torch.float32:
                x = x.to(torch.bfloat16)
            return x.cpu()

        path = self.dir / f"step_{step}.pt"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save({"step": step, "state": _map(host, state)}, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self.max_to_keep]:
            (self.dir / f"step_{old}.pt").unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, like: Any) -> Tuple[int, Any]:
        """The latest checkpoint as ``(step, state)``, each tensor cast to
        the dtype and device of its counterpart in ``like``."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        saved = torch.load(self.dir / f"step_{step}.pt", weights_only=True)

        def cast(x, ref):
            if torch.is_tensor(ref):
                return torch.as_tensor(x).to(dtype=ref.dtype,
                                             device=ref.device)
            return x

        return saved["step"], _zip_map(cast, saved["state"], like)

