"""What a run's process may not hold once its window has closed: JAX, its
libraries and the JAX package (``tpuvr``; ``tpuvr_torch`` is another
name), compared by whole top-level module names."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvr")


def forbidden_modules() -> list:
    """Top-level names of this process's loaded modules that the benchmark
    may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
