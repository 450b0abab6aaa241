"""Structured metrics: one JSON object per step in ``<run_dir>/metrics.jsonl``,
and PSNR."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger("tpuvr_torch")


def psnr(pred, target, peak: float = 1.0):
    """Peak signal-to-noise ratio in dB (a 0-d tensor)."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(peak**2 / torch.clamp_min(mse, 1e-12))


class MetricsLogger:
    """Appends one JSON object per step to ``<run_dir>/metrics.jsonl``
    (nothing is written without a ``run_dir``)."""

    def __init__(self, run_dir: Optional[str] = None, echo_every: int = 50):
        self.path = None
        self.echo_every = echo_every
        self._t0 = time.time()
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, "metrics.jsonl")
            with open(self.path, "w"):  # one file per run
                pass

    def write(self, step: int, **metrics):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        rec.update({
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                else v)
            for k, v in metrics.items()
        })
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo_every and step % self.echo_every == 0:
            log.info("step %d: %s", step, rec)
