"""Radiance RGBE (.hdr) writer: the writer half of the reference package's
rgbe.py (rgbe.cpp float2rgbe semantics), copied. The reader is not ported
yet (it serves env maps)."""

from __future__ import annotations

import numpy as np


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float32 -> [..., 4] uint8 (rgbe.cpp float2rgbe)."""
    v = rgb.max(axis=-1)
    mant, expo = np.frexp(v)
    scale = np.where(v >= 1e-32, mant * 256.0 / np.maximum(v, 1e-38), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    comp = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    valid = v >= 1e-32
    out[..., :3] = np.where(valid[..., None], comp, 0)
    out[..., 3] = np.where(valid, (expo + 128).astype(np.uint8), 0)
    return out


def write_hdr(path: str, rgb: np.ndarray):
    """Write a float32 [H, W, 3] image as flat (non-RLE) Radiance .hdr."""
    h, w = rgb.shape[:2]
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        ("-Y %d +X %d\n" % (h, w)).encode()
    body = _float_to_rgbe(np.asarray(rgb, np.float32)).tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(body)
