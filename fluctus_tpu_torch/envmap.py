"""Environment map: loading, alias-table importance sampling, evaluation
(the port's copy of the reference package's envmap.py; src/envmap.cpp:
31-116 and src/env_map.cl).

Host side (numpy, as the reference): the sin-theta-weighted luminance pdf,
the stable Vose alias tables, the RGBE-packed texels and the packed alias
pairs. Device side (torch, vectorized over ray batches): the lat-long
mapping, the bilinear lookup, alias sampling and the MIS pdf, and the
"fast" forms that read one packed word per lookup (nearest texel, the pdf
re-derived from the decoded luminance). The reference packs those words
for its TPU's gather cost; the port keeps them because the card renders
as the TPU did (``RenderConfig.fast_env`` on CUDA), and reads them with a
plain gather from their int32 view.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import rgbe
from .vec import Vec3

PI = np.float32(np.pi)
TWO_PI = np.float32(2.0 * np.pi)
INV_2PI_PI = np.float32(1.0 / (2.0 * np.pi * np.pi))  # geom.h:33

# the reference's float32 constants, as Python floats (exact)
_U_SCALE = float(np.float32(0.5 / PI))
_V_SCALE = float(np.float32(1.0 / PI))
_PI = float(PI)
_TWO_PI = float(TWO_PI)
_INV_2PI_PI = float(INV_2PI_PI)
_LUM = (0.212671, 0.715160, 0.072169)


def build_alias_table(pdf: np.ndarray):
    """Stable Vose alias method (envmap.cpp:67-113).

    pdf: step-function pdf over n cells, mean 1 (already n-normalized).
    Returns (prob_table float32[n], alias_table int32[n]).
    """
    n = pdf.size
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)

    p = pdf.astype(np.float64).copy()
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        l = small.pop()
        g = large.pop()
        prob[l] = p[l]
        alias[l] = g
        p[g] = (p[g] + p[l]) - 1.0
        (small if p[g] < 1.0 else large).append(g)
    # leftovers keep prob 1 (self-alias)
    return prob, alias


class EnvMapTables(NamedTuple):
    """Device-resident env map tensors; ``width`` and ``height`` are Python
    ints. ``packed`` holds each texel RGBE-encoded in one 32-bit word and
    ``prob_alias`` the alias probability (14 bits) and alias index (18
    bits) in one word (None past 2^18 texels), both as int32 bit
    patterns."""
    image: Vec3                  # flattened [h*w] per channel
    packed: torch.Tensor         # int32 view of the uint32 RGBE words
    pdf_table: torch.Tensor
    prob_table: torch.Tensor
    alias_table: torch.Tensor
    prob_alias: Optional[torch.Tensor]
    inv_mean_lum: torch.Tensor   # 0-dim: 1 / mean(lum * sin)
    width: int
    height: int


class EnvironmentMap:
    """Loaded .hdr environment with importance-sampling tables (src/
    envmap.hpp, envmap.cpp:9-116): ``pdf_table`` holds the per-texel pdf
    ready for solid angle but for 1/sin(theta) (scaled by 1/(2 pi^2)),
    ``prob_table``/``alias_table`` drive O(1) sampling of the flat 1D
    distribution. Host arrays are numpy; ``device_tables`` uploads them."""

    def __init__(self, filename: str, scale: float = 1.0):
        data, w, h = rgbe.read_hdr(filename)
        self.name = filename
        self.width, self.height = w, h
        self.scale = scale
        self._build(data)

    @classmethod
    def from_array(cls, data: np.ndarray, name: str = "<array>"):
        self = cls.__new__(cls)
        self.name = name
        self.height, self.width = data.shape[:2]
        self.scale = 1.0
        self._build(np.asarray(data, np.float32))
        return self

    def _build(self, data: np.ndarray):
        w, h = self.width, self.height
        # sin-theta-weighted luminance scalars (envmap.cpp:35-52)
        v = (np.arange(h, dtype=np.float32) + 0.5) / h
        sin_th = np.sin(PI * v)[:, None]
        lum = (0.212671 * data[..., 0] + 0.715160 * data[..., 1]
               + 0.072169 * data[..., 2])
        scalars = (lum * sin_th).reshape(-1).astype(np.float64)

        # flat 1D pdf, n-normalized like the reference (envmap.cpp:54-65)
        integral = scalars.sum() / (w * h)
        if integral == 0:
            pdf = np.full(w * h, 1.0, np.float64)
        else:
            pdf = scalars / integral

        prob, alias = build_alias_table(pdf)

        # final pdf table includes the (u,v)->dir jacobian factor except
        # 1/sin(theta), which is applied at sample time (envmap.cpp:115)
        self.pdf_table = (pdf * INV_2PI_PI).astype(np.float32)
        self.prob_table = prob
        self.alias_table = alias
        self.image = tuple(np.ascontiguousarray(data[..., c].reshape(-1))
                           for c in range(3))

        # single-read variants: RGBE-packed radiance + packed alias pair
        rgbe8 = rgbe._float_to_rgbe(data.reshape(-1, 3)).astype(np.uint32)
        self.packed = (rgbe8[:, 0] | (rgbe8[:, 1] << 8)
                       | (rgbe8[:, 2] << 16) | (rgbe8[:, 3] << 24))
        if w * h <= (1 << 18):
            prob_q = np.clip(np.round(prob * 16383.0), 0,
                             16383).astype(np.uint32)
            self.prob_alias = (prob_q << 18) | alias.astype(np.uint32)
        else:
            self.prob_alias = None
        self.inv_mean_lum = np.float32(1.0 / max(integral, 1e-30))

    def device_tables(self, device) -> EnvMapTables:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        words = lambda a: t(a.view(np.int32))
        return EnvMapTables(
            image=Vec3(*(t(c) for c in self.image)),
            packed=words(self.packed), pdf_table=t(self.pdf_table),
            prob_table=t(self.prob_table), alias_table=t(self.alias_table),
            prob_alias=(None if self.prob_alias is None
                        else words(self.prob_alias)),
            inv_mean_lum=torch.tensor(self.inv_mean_lum, device=device),
            width=self.width, height=self.height)


# ---------------------------------------------------------------------------
# Device-side math (vectorized over ray batches)
# ---------------------------------------------------------------------------

def _gather3(image: Vec3, idx) -> Vec3:
    return Vec3(image.x[idx], image.y[idx], image.z[idx])


def _lum(c: Vec3):
    return _LUM[0] * c.x + _LUM[1] * c.y + _LUM[2] * c.z


def direction_to_uv(d: Vec3):
    """Lat-long direction -> uv in [0,1]^2 (env_map.cl:14-17)."""
    u = torch.atan2(d.x, -d.z) * _U_SCALE + 0.5
    v = torch.acos(torch.clamp(d.y, -1.0, 1.0)) * _V_SCALE
    return u, v


def uv_to_direction(u, v):
    """uv -> direction + sin(phi) (env_map.cl:21-35)."""
    phi = v * _PI
    theta = u * _TWO_PI - _PI
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    return Vec3(sin_phi * torch.sin(theta), cos_phi,
                -sin_phi * torch.cos(theta)), sin_phi


def eval_env_map_dir(env: EnvMapTables, d: Vec3) -> Vec3:
    """Bilinear lookup along a direction (env_map.cl:37-41): OpenCL's
    CLK_FILTER_LINEAR + CLK_ADDRESS_CLAMP_TO_EDGE with normalized coords,
    the sample point at uv*size - 0.5, clamped."""
    u, v = direction_to_uv(d)
    w, h = env.width, env.height
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = _gather3(env.image, y0i * w + x0i)
    c10 = _gather3(env.image, y0i * w + x1i)
    c01 = _gather3(env.image, y1i * w + x0i)
    c11 = _gather3(env.image, y1i * w + x1i)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def _alias_pick(env: EnvMapTables, rnd, prob_alias_of):
    """(i, uv_ind): the cell rnd falls in and the alias method's pick;
    ``prob_alias_of(i)`` gives the cell's (probability, alias)."""
    wh = env.width * env.height
    r = rnd * wh
    i = torch.clamp_max(torch.floor(r).to(torch.int32), wh - 1)
    m_prob, alias = prob_alias_of(i)
    uv_ind = torch.where(r - i.to(torch.float32) < m_prob, i, alias)
    return uv_ind


def _cell_direction(env: EnvMapTables, uv_ind):
    """The reference's uv of a picked cell, including its idiosyncratic
    v = (uvInd + 0.5)/(w*h) (env_map.cl:81), and its direction."""
    w = env.width
    u = (torch.remainder(uv_ind, w).to(torch.float32) + 0.5) / w
    v = (uv_ind.to(torch.float32) + 0.5) / (w * env.height)
    return uv_to_direction(u, v)


def sample_env_map_alias(env: EnvMapTables, rnd):
    """O(1) alias-method sample of the flat 1D distribution
    (env_map.cl:63-92). Returns (L: Vec3, pdf_w)."""
    uv_ind = _alias_pick(env, rnd, lambda i: (env.prob_table[i],
                                              env.alias_table[i]))
    L, sin_th = _cell_direction(env, uv_ind)
    pdf = torch.where(sin_th != 0.0,
                      env.pdf_table[uv_ind] / torch.clamp_min(sin_th, 1e-30),
                      0.0)
    return L, pdf


def env_map_pdf(env: EnvMapTables, d: Vec3):
    """MIS pdf of sampling direction d (env_map.cl:95-109)."""
    idx, _ = _texel_index(env, d)
    pdf = env.pdf_table[idx] * torch.rsqrt(
        torch.clamp_min(1.0 - d.y * d.y, 1e-12))
    return torch.where(d.y > 0.99, 0.0, pdf)


# ---------------------------------------------------------------------------
# Single-read ("fast") forms: radiance is RGBE-quantized (~0.4% relative);
# the pdf is re-derived from the decoded luminance instead of read.
# ---------------------------------------------------------------------------

def _decode_rgbe(texel) -> Vec3:
    """RGBE word (int32 bits) -> linear RGB (rgbe2float: value = comp *
    2^(e-136))."""
    e = ((texel >> 24) & 0xFF).to(torch.float32)
    f = torch.where(e > 0.0, torch.exp2(e - 136.0), 0.0)
    return Vec3((texel & 0xFF).to(torch.float32) * f,
                ((texel >> 8) & 0xFF).to(torch.float32) * f,
                ((texel >> 16) & 0xFF).to(torch.float32) * f)


def _texel_index(env: EnvMapTables, d: Vec3):
    w, h = env.width, env.height
    u, v = direction_to_uv(d)
    iu = torch.clamp_max(torch.floor(u * w).to(torch.int32), w - 1)
    iv = torch.clamp_max(torch.floor(v * h).to(torch.int32), h - 1)
    return iv * w + iu, iv


def _pdf_from_lum(env: EnvMapTables, lum, iv):
    """pdf_table value re-derived: lum * sin(theta_row) / mean *
    1/(2 pi^2)."""
    sin_row = torch.sin(_PI * (iv.to(torch.float32) + 0.5) / env.height)
    return lum * sin_row * env.inv_mean_lum * _INV_2PI_PI


def eval_env_map_dir_fast(env: EnvMapTables, d: Vec3) -> Vec3:
    """Nearest-texel RGBE lookup: one read."""
    idx, _ = _texel_index(env, d)
    return _decode_rgbe(env.packed[idx])


def eval_env_and_pdf_fast(env: EnvMapTables, d: Vec3):
    """Radiance + MIS pdf from the same single read."""
    idx, iv = _texel_index(env, d)
    li = _decode_rgbe(env.packed[idx])
    pdf = _pdf_from_lum(env, _lum(li), iv) * torch.rsqrt(
        torch.clamp_min(1.0 - d.y * d.y, 1e-12))
    return li, torch.where(d.y > 0.99, 0.0, pdf)


def sample_env_map_alias_fast(env: EnvMapTables, rnd):
    """Alias sample + radiance + pdf in two reads (prob_alias, packed),
    with 14-bit-quantized alias probabilities (distribution error <= 2^-14
    per cell)."""
    def prob_alias_of(i):
        pa = env.prob_alias[i]
        m_prob = ((pa >> 18) & 0x3FFF).to(torch.float32) * (1.0 / 16383.0)
        return m_prob, pa & 0x3FFFF
    uv_ind = _alias_pick(env, rnd, prob_alias_of)
    L, sin_th = _cell_direction(env, uv_ind)
    li = _decode_rgbe(env.packed[uv_ind])
    iv = torch.div(uv_ind, env.width, rounding_mode="floor")
    pdf = torch.where(sin_th != 0.0,
                      _pdf_from_lum(env, _lum(li), iv)
                      / torch.clamp_min(sin_th, 1e-30), 0.0)
    return L, pdf, li


# ---------------------------------------------------------------------------
# Route-selecting wrappers used by the integrators
# ---------------------------------------------------------------------------

def env_radiance_and_pdf(env: EnvMapTables, d: Vec3, fast: bool):
    """(radiance, MIS pdf) along d — one read when fast."""
    if fast and env.prob_alias is not None:
        return eval_env_and_pdf_fast(env, d)
    return eval_env_map_dir(env, d), env_map_pdf(env, d)


def env_sample(env: EnvMapTables, rnd, fast: bool):
    """NEE sample: (L, pdf, radiance)."""
    if fast and env.prob_alias is not None:
        return sample_env_map_alias_fast(env, rnd)
    L, pdf = sample_env_map_alias(env, rnd)
    return L, pdf, eval_env_map_dir(env, L)
