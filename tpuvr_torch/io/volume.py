"""Volume file IO: TVOL (a native codec), raw dumps, TIFF stacks.

``native/volcodec.cpp`` (the zero-RLE TVOL codec and a PPM writer) is
built with g++ into ``tpuvr_torch/_build/`` at first use and bound with
ctypes; where it cannot be built, a numpy codec writes and reads the same
bytes, with a warning. The TVOL layout (little-endian): ``TVOL0001``, u32
z, y, x, channels, u32 codec (0 raw f32, 1 zero-RLE f32), u64 payload
bytes, the payload; zero-RLE stores runs of exact 0.0f as (0xFFFFFFFF,
length) and literal spans as (count, count f32). It is the JAX package's
format, so files cross between the packages bit for bit.

Arrays come back as numpy; inputs may be numpy arrays or tensors.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

from tpuvr_torch.io.image import host_array

log = logging.getLogger("tpuvr_torch")

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "volcodec.cpp"
_LIB_PATH = _PKG / "_build" / "libvolcodec.so"

_MAGIC = b"TVOL0001"
_RUN = 0xFFFFFFFF

_P_FLOAT = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = {
    "tvol_write": [ctypes.c_char_p, _P_FLOAT, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_int],
    "tvol_read_header": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32)],
    "tvol_read": [ctypes.c_char_p, _P_FLOAT, ctypes.c_uint64],
    "ppm_write": [ctypes.c_char_p, _P_FLOAT, ctypes.c_uint32,
                  ctypes.c_uint32, ctypes.c_float],
}


@lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native codec; None if unavailable.
    The library is compiled under a temporary name and moved into place,
    so processes that build at once never load a half-written file."""
    try:
        if (not _LIB_PATH.exists()
                or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime):
            _LIB_PATH.parent.mkdir(exist_ok=True)
            tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                     "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native volcodec unavailable (%s); numpy fallback", e)
        return None


def save_tvol(path: str, volume, rle: bool = True):
    """Write a (Z, Y, X, C) or (Z, Y, X) float32 volume as TVOL."""
    arr = np.ascontiguousarray(host_array(volume))
    if arr.ndim == 3:
        arr = arr[..., None]
    z, y, x, c = arr.shape
    lib = _lib()
    if lib is not None:
        rc = lib.tvol_write(str(path).encode(), arr.ctypes.data_as(_P_FLOAT),
                            z, y, x, c, 1 if rle else 0)
        if rc != 0:
            raise IOError(f"tvol_write failed with code {rc}")
        return
    _save_tvol_numpy(path, arr, rle)


def load_tvol(path: str) -> np.ndarray:
    """Read a TVOL file -> (Z, Y, X, C) float32."""
    lib = _lib()
    if lib is not None:
        dims = (ctypes.c_uint32 * 4)()
        rc = lib.tvol_read_header(str(path).encode(), dims)
        if rc != 0:
            raise IOError(f"tvol_read_header failed with code {rc}")
        z, y, x, c = (int(d) for d in dims)
        out = np.empty((z, y, x, c), dtype=np.float32)
        rc = lib.tvol_read(str(path).encode(), out.ctypes.data_as(_P_FLOAT),
                           out.size)
        if rc != 0:
            raise IOError(f"tvol_read failed with code {rc}")
        return out
    return _load_tvol_numpy(path)


def write_ppm_native(path: str, rgb, gamma: float = 2.2) -> bool:
    """Native gamma-encoding PPM writer; returns False if lib missing."""
    lib = _lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(host_array(rgb))
    h, w = arr.shape[:2]
    rc = lib.ppm_write(str(path).encode(), arr.ctypes.data_as(_P_FLOAT),
                       h, w, 1.0 / gamma)
    if rc != 0:
        raise IOError(f"ppm_write failed with code {rc}")
    return True


def load_raw(path: str, shape, dtype=np.uint8, normalize: bool = True):
    """Load a raw volume dump.

    Args:
      shape: (Z, Y, X).
      dtype: on-disk scalar type (uint8/uint16/float32).
      normalize: scale integer types to [0, 1].

    Returns (Z, Y, X) float32 density.
    """
    data = np.fromfile(path, dtype=dtype).reshape(shape)
    data = data.astype(np.float32)
    if normalize and np.issubdtype(dtype, np.integer):
        data /= float(np.iinfo(dtype).max)
    return data


def load_tiff_stack(paths, normalize: bool = True,
                    scale: Optional[float] = None) -> np.ndarray:
    """Load a TIFF slice stack (one image per Z plane) into (Z, Y, X).

    Accepts a list of file paths or a glob pattern; slices are sorted
    lexicographically and must share one (Y, X) shape and one sample
    dtype (a mixed uint8/uint16 stack would otherwise be silently
    mis-scaled). Integer samples are scaled to [0, 1] when ``normalize``;
    ``scale`` overrides the divisor (useful for mode 'I' int32 TIFFs whose
    full scale is rarely 2^31-1). Needs PIL, imported here only.
    """
    from PIL import Image

    if isinstance(paths, (str, bytes)):
        import glob as _glob

        paths = sorted(_glob.glob(paths))
    if not paths:
        raise ValueError("load_tiff_stack: no slice files found")
    planes = []
    for p in paths:
        with Image.open(p) as img:
            if img.mode not in ("F", "I", "I;16", "L"):
                img = img.convert("F")
            planes.append(np.asarray(img).copy())
    shapes = {pl.shape for pl in planes}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent slice shapes: {sorted(shapes)}")
    dtypes = {pl.dtype for pl in planes}
    if len(dtypes) != 1:
        raise ValueError(
            f"inconsistent slice dtypes: {sorted(str(d) for d in dtypes)}; "
            "normalization needs one sample type per stack"
        )
    vol = np.stack(planes).astype(np.float32)
    dtype = planes[0].dtype
    if scale is not None:
        vol /= float(scale)
    elif normalize and np.issubdtype(dtype, np.integer):
        vol /= float(np.iinfo(dtype).max)
    return vol


def density_to_grid(density, emission=(1.0, 1.0, 1.0)):
    """(Z, Y, X) density -> (Z, Y, X, 4) grid with constant emission."""
    d = host_array(density)
    rgb = np.broadcast_to(
        np.asarray(emission, dtype=np.float32), (*d.shape, 3)
    )
    return np.concatenate([d[..., None], rgb], axis=-1)


# ------------------------------------------------------------ numpy codec

def _save_tvol_numpy(path: str, arr: np.ndarray, rle: bool):
    z, y, x, c = arr.shape
    flat = arr.reshape(-1)
    chunks = [b""]
    if rle:
        codec = 1
        zero = flat == 0.0
        # Boundaries of equal-value runs of the zero mask.
        idx = np.flatnonzero(np.diff(zero.astype(np.int8))) + 1
        starts = np.concatenate([[0], idx])
        ends = np.concatenate([idx, [flat.size]])
        for s, e in zip(starts, ends):
            if zero[s]:
                run = e - s
                while run > 0:
                    chunk = min(run, 0xFFFFFFF0)
                    chunks.append(
                        np.asarray([_RUN, chunk], np.uint32).tobytes()
                    )
                    run -= chunk
            else:
                lit = flat[s:e]
                chunks.append(
                    np.asarray([lit.size], np.uint32).tobytes()
                    + lit.tobytes()
                )
        payload = b"".join(chunks)
    else:
        codec = 0
        payload = flat.tobytes()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.asarray([z, y, x, c, codec], np.uint32).tobytes())
        f.write(np.asarray([len(payload)], np.uint64).tobytes())
        f.write(payload)


def _load_tvol_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise IOError("bad TVOL magic")
        z, y, x, c, codec = np.frombuffer(f.read(20), np.uint32)
        (nbytes,) = np.frombuffer(f.read(8), np.uint64)
        payload = f.read(int(nbytes))
    n = int(z) * int(y) * int(x) * int(c)
    if codec == 0:
        flat = np.frombuffer(payload, np.float32, n).copy()
    else:
        out = np.empty(n, np.float32)
        pos = oi = 0
        buf = np.frombuffer(payload, np.uint8)
        while pos < len(payload):
            word = int(np.frombuffer(buf[pos:pos + 4], np.uint32)[0])
            pos += 4
            if word == _RUN:
                run = int(np.frombuffer(buf[pos:pos + 4], np.uint32)[0])
                pos += 4
                out[oi:oi + run] = 0.0
                oi += run
            else:
                out[oi:oi + word] = np.frombuffer(
                    buf[pos:pos + word * 4], np.float32
                )
                pos += word * 4
                oi += word
        flat = out
    return flat.reshape(int(z), int(y), int(x), int(c))
