"""ctypes bindings for the native runtime tier (``csrc/libpt_native.so``).

Counterpart of the JAX package's ``utils/native.py``: the same prebuilt
library of the repo (PNG encode with per-row filter selection, and the
byte-space post filters of ``csrc/pt_native.cpp``) behind its plain C ABI.
Everything here is optional: where the library is absent or does not load,
every function returns None and callers use the port's own versions
(``io_png``'s zlib writer, ``post``'s torch filters).  Nothing is built or
fetched for it; ``make -C csrc`` builds it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = ["lib", "available", "encode_png", "bilateral3x3", "box_smooth"]

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "csrc", "libpt_native.so"),
    os.path.join(os.path.dirname(__file__), "libpt_native.so"),
)


def _load() -> Optional[ctypes.CDLL]:
    for path in _LIB_PATHS:
        if not os.path.exists(path):
            continue
        try:
            found = ctypes.CDLL(os.path.abspath(path))
        except OSError:
            continue
        u8p, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32
        found.pt_encode_png.restype = ctypes.c_int64
        found.pt_encode_png.argtypes = [u8p, i32, i32, i32, i32, u8p, ctypes.c_int64]
        found.pt_bilateral3x3.restype = None
        found.pt_bilateral3x3.argtypes = [u8p, u8p, i32, i32, i32, ctypes.c_double, ctypes.c_double]
        found.pt_box_smooth.restype = None
        found.pt_box_smooth.argtypes = [u8p, u8p, i32, i32, i32, i32, ctypes.c_double]
        return found
    return None


lib: Optional[ctypes.CDLL] = _load()


def available() -> bool:
    return lib is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u8_image(img) -> np.ndarray:
    """A contiguous uint8 [H,W,C] NumPy array of an image (array or CPU tensor)."""
    img = np.ascontiguousarray(np.asarray(img))
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected a uint8 [H,W,C] image, got {img.dtype} {img.shape}")
    return img


def encode_png(img, compress_level: int = 6) -> Optional[bytes]:
    """Encode RGB(A) uint8 [H,W,C] to PNG bytes; None if unavailable/failed."""
    if lib is None:
        return None
    img = _u8_image(img)
    h, w, c = img.shape
    cap = w * h * c + (h * 16) + 4096
    out = np.empty(cap, np.uint8)
    n = lib.pt_encode_png(_u8ptr(img), w, h, c, compress_level, _u8ptr(out), cap)
    if n <= 0:
        return None
    return out[:n].tobytes()


def bilateral3x3(img, sigma_s: float, sigma_r: float) -> Optional[np.ndarray]:
    """The 3x3 bilateral filter of ``post.bilateral_denoise`` on uint8 [H,W,C]; None if unavailable."""
    if lib is None:
        return None
    img = _u8_image(img)
    h, w, c = img.shape
    dst = np.empty_like(img)
    lib.pt_bilateral3x3(_u8ptr(img), _u8ptr(dst), w, h, c, sigma_s, sigma_r)
    return dst


def box_smooth(img, radius: int, strength: float) -> Optional[np.ndarray]:
    """The blend of ``post.box_smooth`` on uint8 [H,W,C]; None if unavailable."""
    if lib is None:
        return None
    img = _u8_image(img)
    h, w, c = img.shape
    dst = np.empty_like(img)
    lib.pt_box_smooth(_u8ptr(img), _u8ptr(dst), w, h, c, radius, strength)
    return dst
