"""A small PNG reader for the port's tests: 8-bit RGB(A), no interlace, all
five row filters (the native encoder picks one a row).  The card's machine
has no PIL, so the port's tests read their PNGs with this."""

import struct
import zlib

import numpy as np

__all__ = ["decode_png"]


def decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, f"bad CRC in {tag!r}"
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _comp, _filt, interlace = hdr
    assert depth == 8 and color in (2, 6) and interlace == 0, hdr
    ch = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    out = np.zeros((h, w * ch), np.int64)
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        row = np.zeros(w * ch, np.int64)
        for x in range(w * ch):
            a = row[x - ch] if x >= ch else 0
            b = prev[x]
            c = prev[x - ch] if x >= ch else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            row[x] = (line[x] + pred) & 0xFF
        out[y] = row
        prev = row
    return out.astype(np.uint8).reshape(h, w, ch)
