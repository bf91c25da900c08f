"""The port's native tier (utils/native.py, the repo's prebuilt
csrc/libpt_native.so through ctypes): the PNG codec and the byte-space
post filters against the port's own versions.

Tolerance: the filters within 1 of the port's torch filters (the library
computes in f64, the port in f32), as tests/test_native.py holds the JAX
package's.  The tests skip where the library does not load."""

import numpy as np
import pytest
import torch

from path_trace_golang_tpu_torch import io_png
from path_trace_golang_tpu_torch import post as tpost
from path_trace_golang_tpu_torch.utils import native

from torch_png import decode_png

pytestmark = pytest.mark.skipif(not native.available(), reason="libpt_native.so not built (make -C csrc)")


@pytest.mark.parametrize("shape", [(13, 17, 3), (32, 64, 4), (1, 1, 3)])
def test_native_png_roundtrip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    data = native.encode_png(img)
    assert data is not None and data[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(decode_png(data), img)


def test_save_png_uses_native(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (24, 32, 3), np.uint8)
    p = tmp_path / "x.png"
    io_png.save_png(p, torch.from_numpy(img))  # a CPU tensor is taken as well
    assert p.read_bytes() == native.encode_png(img)
    assert np.array_equal(decode_png(p.read_bytes()), img)
    # the zlib writer, the encoder where the library is missing, gives the same pixels
    assert np.array_equal(decode_png(io_png.encode_png_zlib(img)), img)


def test_native_bilateral_matches_torch():
    img = np.random.default_rng(2).integers(0, 256, (9, 11, 3), np.uint8)
    got = native.bilateral3x3(img, 1.0, 0.15)
    want = tpost.bilateral_denoise(torch.from_numpy(img)).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1  # f32 vs f64


def test_native_box_smooth_matches_torch():
    img = np.random.default_rng(3).integers(0, 256, (8, 10, 3), np.uint8)
    got = native.box_smooth(img, 2, 0.5)
    want = tpost.box_smooth(torch.from_numpy(img), 2, 0.5).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_native_matches_the_jax_packages_binding():
    """Both packages bind the same library: the same bytes and pixels."""
    from path_trace_golang_tpu.utils import native as jnative

    img = np.random.default_rng(4).integers(0, 256, (12, 20, 3), np.uint8)
    assert native.encode_png(img) == jnative.encode_png(img)
    assert np.array_equal(native.bilateral3x3(img, 1.0, 0.15), jnative.bilateral3x3(img, 1.0, 0.15))
    assert np.array_equal(native.box_smooth(img, 3, 0.25), jnative.box_smooth(img, 3, 0.25))
