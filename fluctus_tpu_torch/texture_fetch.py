"""Texel fetch from the packed atlas (the reference package's
texture_fetch.py; readTexture/getTexelCoords, src/utils.cl:139-158):
nearest texel with wrap addressing, clamped to the texture's rectangle,
and matGetAlbedo's gamma 2.2 (utils.cl:161-166), which the reference
applies to the constant fallback colour too. One gather per texel: the
texel word itself, unpacked with masks and shifts.
"""

from __future__ import annotations

import numpy as np
import torch

from .scene.texture import TextureAtlas
from .vec import Vec3, where as vwhere

ONE_255 = float(np.float32(1.0 / 255.0))


def _fetch_texel(texels, off, w, h, u, v) -> Vec3:
    """Nearest-with-wrap fetch given per-lane descriptors (off, w, h):
    x = floor(u w) wraps by floor-mod (torch.remainder, as jnp.mod) into
    [0, w), and y likewise; the texel word at off + y w + x."""
    ws = torch.clamp_min(w, 1)
    hs = torch.clamp_min(h, 1)
    x = torch.floor(u * w.to(torch.float32)).to(torch.int32)
    y = torch.floor(v * h.to(torch.float32)).to(torch.int32)
    tx = torch.minimum(torch.remainder(x, ws), w - 1)
    ty = torch.minimum(torch.remainder(y, hs), h - 1)
    texel = texels[(off + ty * w + tx).long()]
    c = lambda s: ((texel >> s) & 0xFF).to(torch.float32) * ONE_255
    return Vec3(c(0), c(8), c(16))


def fetch_texture(atlas: TextureAtlas, tex_idx, u, v) -> Vec3:
    """Per-lane texture indices (-1 allowed: the caller masks those lanes)
    with the descriptors gathered from the atlas."""
    safe = torch.clamp_min(tex_idx, 0).long()
    return _fetch_texel(atlas.texels, atlas.offset[safe], atlas.width[safe],
                        atlas.height[safe], u, v)


def mat_get_float3(fallback: Vec3, u, v, tex_idx, atlas: TextureAtlas,
                   meta=None) -> Vec3:
    """utils.cl:168-171: the texture where the lane has one, else the
    constant; no gamma. Without textures the constant. ``meta`` = per-lane
    (off, w, h) baked by the resolve saves the descriptor gathers."""
    if atlas is None or atlas.count == 0:
        return fallback
    if meta is not None:
        off, w, h = meta
        tex = _fetch_texel(atlas.texels, off, w, h, u, v)
    else:
        tex = fetch_texture(atlas, tex_idx, u, v)
    return vwhere(tex_idx >= 0, tex, fallback)


def mat_get_albedo(fallback: Vec3, u, v, tex_idx, atlas: TextureAtlas,
                   meta=None) -> Vec3:
    """utils.cl:161-166: ``mat_get_float3`` raised to the power 2.2
    (clamped at 0), the fallback included, as the reference."""
    val = mat_get_float3(fallback, u, v, tex_idx, atlas, meta)
    p = lambda c: torch.pow(torch.clamp_min(c, 0.0), 2.2)
    return Vec3(p(val.x), p(val.y), p(val.z))
