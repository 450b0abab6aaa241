"""Build the CUDA sources under ``tpuvr_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``tpuvr_torch/_build/lib<name>-<digest>.so`` with a plain C interface and
loaded with ``ctypes``. The digest covers the source, every header in
``csrc`` and the flags, so an edit rebuilds. Nothing is compiled or loaded
at import: the first use builds, and :func:`build` compiles several sources
at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("sweep_fwd", "tau_sweep", "sweep_bwd", "tau_adj", "warp_rows",
           "light_apply")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all at
    once. Returns each compiled source's compiler output (``-Xptxas -v``
    lists registers and spills); raises if any compile fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        logs = {}
        for name, (proc, tmp, out) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{text}")
            os.replace(tmp, out)
            logs[name] = text
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def entry(lib: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<lib>.cu``, resolved and typed once
    per process: ``argtypes`` and then the stream (``c_void_p``),
    returning an int."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def launch(fn, dev, *args):
    """Call the C entry ``fn`` with ``args`` and ``dev``'s current stream,
    making ``dev`` current only when it is not; raises on a CUDA error.
    The raw stream and the current device come from PyTorch's C bindings,
    which skip building a ``torch.cuda.Stream`` at every launch."""
    c = torch._C
    if dev.index == c._cuda_getDevice():
        err = fn(*args, c._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, c._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__[6:]} kernel launch failed: CUDA "
                           f"error {err}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
