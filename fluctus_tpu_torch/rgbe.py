"""Radiance RGBE (.hdr) reader and writer: the port's copy of the
reference package's rgbe.py (src/rgbe/rgbe.cpp semantics): header
parsing, new-style per-component RLE scanlines, old-style flat RGBE, and
the rgbe <-> float conversions. Used for env-map loading and HDR image
export."""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> [..., 3] float32 (rgbe.cpp rgbe2float)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    f = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f[..., None]


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


def read_hdr(path: str):
    """Read a Radiance .hdr file. Returns (float32 [H, W, 3], width,
    height)."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance file (missing #? magic)")
    width = height = None
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"-Y") or line.startswith(b"+Y"):
            parts = line.split()
            if len(parts) != 4 or parts[0] != b"-Y" or parts[2] != b"+X":
                raise ValueError("unsupported scanline orientation: %r"
                                 % line)
            height = int(parts[1])
            width = int(parts[3])
            break
        # FORMAT / comments / blank lines are skipped
    buf = np.frombuffer(data, np.uint8, offset=pos)

    img = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[off] != 2 \
                or buf[off + 1] != 2 \
                or (int(buf[off + 2]) << 8 | int(buf[off + 3])) != width:
            # old-style flat scanlines for the rest of the image
            rest = buf[off:off + (height - y) * width * 4]
            img[y:] = rest.reshape(height - y, width, 4)
            off += rest.size
            break
        off += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[off])
                if count > 128:  # run
                    n = count - 128
                    img[y, x:x + n, c] = buf[off + 1]
                    off += 2
                    x += n
                else:            # literal dump
                    img[y, x:x + count, c] = buf[off + 1:off + 1 + count]
                    off += 1 + count
                    x += count
    return _rgbe_to_float(img), width, height


def write_hdr(path: str, rgb: np.ndarray):
    """Write a float32 [H, W, 3] image as flat (non-RLE) Radiance .hdr."""
    h, w = rgb.shape[:2]
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        ("-Y %d +X %d\n" % (h, w)).encode()
    body = _float_to_rgbe(np.asarray(rgb, np.float32)).tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(body)
