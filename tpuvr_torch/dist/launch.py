"""Start ranks on one host and collect what they return.

The JAX package needs no launcher: XLA simulates its devices in one
process. The port runs one process per rank, so the tests (gloo on the
CPU) and ``chip_smoke.py`` (on the card) start theirs with :func:`spawn`.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch


def to_numpy(x):
    """Tensors, nested in tuples, lists and dicts, as numpy arrays."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x


def _rank_main(rank, world, backend, device, store_path, timeout_s, fn, args,
               results):
    from tpuvr_torch.dist.init import initialize

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        store = torch.distributed.FileStore(store_path, world)
        initialize(backend, rank=rank, world_size=world, store=store,
                   device=device, timeout_s=timeout_s)
        try:
            out = to_numpy(fn(*args))
        finally:
            torch.distributed.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: str, device: str,
          args: Sequence[Any] = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks and return each rank's result
    (tensors as numpy arrays), in rank order.

    Each rank is a process of the ``spawn`` start method, so ``fn`` must
    be importable (a module-level function) and ``args`` picklable. The
    ranks meet through a ``FileStore`` in a fresh temporary directory (no
    port is taken, so concurrent runs cannot collide) and bring up
    ``backend`` (see :func:`tpuvr_torch.dist.init.initialize`): on the
    card (``device="cuda"``) rank r takes card r modulo the cards it sees;
    on the CPU each rank runs one torch thread. ``fn`` builds its mesh
    with :func:`tpuvr_torch.dist.init.data_mesh`.

    Raises RuntimeError with the rank's traceback as soon as a rank fails,
    and TimeoutError when the ranks have not all returned within
    ``timeout_s`` (which also bounds each collective); either way every
    rank is stopped first.
    """
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tpuvr_dist_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, device, store_path,
                                   timeout_s, fn, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out = [None] * world
        try:
            deadline = time.monotonic() + timeout_s
            pending = set(range(world))
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} did not finish within "
                        f"{timeout_s:g} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r in pending
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
                pending.discard(rank)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return out

