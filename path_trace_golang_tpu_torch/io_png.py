"""PNG output (engine.SavePNG analog, util.go:45-55).

Encoder preference, as the JAX package's: the native C++ tier
(``utils/native.py``: per-row filter selection + zlib), then a
dependency-free zlib writer (filter byte 0 per scanline).  No PIL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

__all__ = ["save_png", "encode_png", "encode_png_zlib"]


def _checked(img) -> np.ndarray:
    img = np.ascontiguousarray(np.asarray(img))
    if img.dtype != np.uint8:
        raise TypeError(f"save_png expects uint8, got {img.dtype}")
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"save_png expects [H,W,3|4], got {img.shape}")
    return img


def encode_png_zlib(img) -> bytes:
    """PNG bytes of an RGB(A) uint8 image [H,W,3|4] from the zlib writer."""
    img = _checked(img)
    h, w, ch = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        return struct.pack(">I", len(data)) + tag + data + crc

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def encode_png(img) -> bytes:
    """PNG bytes of an RGB(A) uint8 image [H,W,3|4] (NumPy or CPU tensor):
    the native encoder where the library loads, else the zlib writer."""
    from .utils import native

    img = _checked(img)
    data = native.encode_png(img)
    return data if data is not None else encode_png_zlib(img)


def save_png(path: Union[str, os.PathLike], img) -> None:
    """Write an RGB(A) uint8 image [H,W,3|4] (NumPy or CPU tensor) as PNG."""
    data = encode_png(img)
    with open(os.fspath(path), "wb") as f:
        f.write(data)
