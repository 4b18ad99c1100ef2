"""Texture loading and atlas packing (the port's copy of the reference
package's scene/texture.py; src/clcontext.cpp:588-629, geom.h:145-150).

Every RGBA8 texture of a scene is packed into one table of texels, each
texel one 32-bit word 0xAABBGGRR, with per-texture (offset, width, height)
descriptors: a texel fetch is one gather and a bit unpack. The words are
stored as int32 (torch has few uint32 operations); the unpack masks each
byte, so the sign of the top byte is never read.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class HostTexture:
    """One texture file as RGBA8 rows, flipped vertically: OBJ/GL uv
    origin is bottom-left, images are stored top-left (the reference's
    DevIL IL_ORIGIN_LOWER_LEFT)."""

    def __init__(self, path: str, name: str):
        from PIL import Image
        with Image.open(path) as im:
            rgba = np.asarray(im.convert("RGBA"), np.uint8)
        # an own contiguous copy: torch.from_numpy refuses negative strides
        self.data = rgba[::-1].copy()
        self.name = name
        self.path = path
        self.height, self.width = rgba.shape[:2]


class TextureAtlas(NamedTuple):
    """Device atlas: the packed texels and per-texture descriptors.

    ``count`` is the number of textures (0: no fetch path runs).
    ``has_kd``/``has_ks``/``has_n`` say whether any material uses that map
    type (``with_material_usage``); a map type no material uses is never
    fetched. ``offset_t``/``width_t``/``height_t`` are the descriptors as
    host tuples, read by ``MXUScene.build`` to bake them per triangle
    without reading the device back. The descriptor tables are padded to
    at least 128 rows (offset 0, 1 x 1), as the reference's."""
    texels: torch.Tensor      # int32 [total] 0xAABBGGRR words
    offset: torch.Tensor      # int32 [n_pad]
    width: torch.Tensor       # int32 [n_pad]
    height: torch.Tensor      # int32 [n_pad]
    count: int = 0
    has_kd: bool = True
    has_ks: bool = True
    has_n: bool = True
    offset_t: tuple = ()
    width_t: tuple = ()
    height_t: tuple = ()

    def with_material_usage(self, materials) -> "TextureAtlas":
        return self._replace(
            has_kd=any(m.map_Kd >= 0 for m in materials),
            has_ks=any(m.map_Ks >= 0 for m in materials),
            has_n=any(m.map_N >= 0 for m in materials))


_MIN_ROWS = 128


def pack_rgba(data: np.ndarray) -> np.ndarray:
    """[h, w, 4] uint8 -> [h * w] uint32 words 0xAABBGGRR."""
    rgba = data.astype(np.uint32)
    return (rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16)
            | (rgba[..., 3] << 24)).reshape(-1)


def atlas_from_numpy(texels, offset, width, height, *, count: int,
                     device) -> TextureAtlas:
    """A TextureAtlas from host arrays: the texel words (uint32 or int32)
    and the padded descriptor tables, e.g. the reference package's atlas
    read back with ``np.asarray``. The usage flags start True."""
    t = np.array(texels)                     # an own, writable copy
    if t.dtype != np.int32:
        t = t.astype(np.uint32).view(np.int32)
    i32 = lambda a: np.array(a, np.int32)
    offset, width, height = i32(offset), i32(width), i32(height)
    up = lambda a: torch.from_numpy(a).to(device)
    return TextureAtlas(
        texels=up(t), offset=up(offset), width=up(width), height=up(height),
        count=int(count), offset_t=tuple(offset.tolist()),
        width_t=tuple(width.tolist()), height_t=tuple(height.tolist()))


def pack_atlas(textures: List[HostTexture], *, device) -> TextureAtlas:
    """Pack the textures in order: texture i's texels start at the sum of
    the earlier ones' sizes. No textures give a dummy table of 128 zero
    texels and count 0."""
    n_pad = max(_MIN_ROWS, len(textures))
    if not textures:
        return atlas_from_numpy(np.zeros(_MIN_ROWS, np.uint32),
                                np.zeros(n_pad), np.ones(n_pad),
                                np.ones(n_pad), count=0, device=device)
    offsets, ws, hs, chunks = [], [], [], []
    total = 0
    for t in textures:
        offsets.append(total)
        ws.append(t.width)
        hs.append(t.height)
        chunks.append(pack_rgba(t.data))
        total += chunks[-1].size
    pad = n_pad - len(textures)
    return atlas_from_numpy(np.concatenate(chunks), offsets + [0] * pad,
                            ws + [1] * pad, hs + [1] * pad,
                            count=len(textures), device=device)
