"""Image output: an 8-bit RGB PNG writer on zlib alone, and Radiance .hdr
through rgbe.py."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import rgbe


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def save_png(path: str, rgb: np.ndarray):
    """rgb: float [H, W, 3] in [0, 1] (already tonemapped + gamma)."""
    arr = np.clip(np.asarray(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1)   # filter 0 rows
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_hdr(path: str, rgb: np.ndarray):
    """rgb: float [H, W, 3] linear radiance."""
    rgbe.write_hdr(path, np.asarray(rgb, np.float32))
