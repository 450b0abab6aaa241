"""Image output: tone mapping and PNG/PPM writers, with no imaging
library (the card's machine has none)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def host_array(x, dtype=np.float32) -> np.ndarray:
    """A numpy array of ``dtype`` from an array or a tensor on any device
    (a tensor is detached and copied to the host)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def tonemap(rgb, gamma: float = 2.2):
    """Clamp + gamma-encode linear radiance to displayable [0, 1]."""
    rgb = np.clip(host_array(rgb), 0.0, 1.0)
    return rgb ** (1.0 / gamma)


def to_uint8(rgb) -> np.ndarray:
    """The 8-bit pixels both writers store: ``tonemap(rgb) * 255 + 0.5``,
    truncated."""
    return (tonemap(rgb) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, rgb):
    """Write an (H, W, 3) float image (linear radiance) as an 8-bit RGB
    PNG: one IHDR, one IDAT (each row behind filter byte 0), IEND."""
    arr = np.ascontiguousarray(to_uint8(rgb))
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_ppm(path: str, rgb):
    """Dependency-free PPM writer (binary P6)."""
    arr = to_uint8(rgb)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
