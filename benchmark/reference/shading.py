"""The reference's shading: the random numbers, the camera, the area
light, the textures, the environment map, the BSDF lobes and the
tonemap, written for the benchmark from the published formulas and the
semantics of fluctus's OpenCL kernels (the files cited are fluctus's),
on [n] and [n, 3] tensors in any float type (float64 for the reference,
a lower type for the control). It reads its inputs from the scene files
(``scene_files``) and shares no code with the program.

Where fluctus departs from the paper it cites, the reference follows
fluctus, and each such place is named here:

- GGX (Walter et al. 2007, eq. 33, 34, 35-36 and 24 with 14): as the
  paper. The rough dielectric (ggx.cl:159-305) refracts about the
  macro normal, not the sampled microfacet, and its refraction pdf and
  focus term square eta_i |i.h| + eta_o |o.h|, where the paper (eq. 17,
  21) squares eta_i (i.h) + eta_o (o.h) with i.h and o.h of opposite
  signs under transmission.
- The glossy lobe (glossy.cl:12-63) is a Lambertian base under a GGX
  coat, the coat picked with the Fresnel weight of the view direction.
- The env map's sampled direction takes v = (cell + 0.5) / (w h), not
  the cell's row centre (env_map.cl:81); its pdf takes sin(theta) of
  the texel's row centre in the table and of the direction at lookup.
- The camera's row coordinate is pixel * (1 / width), a fractional row
  (wf_raygen.cl:31).
- matGetAlbedo raises the constant colour to the power 2.2 as well as
  the texel (utils.cl:161-166).

Indices worked out from a float (a texel's column and row) are taken
from the product rounded to float32, as the renderer's float32 kernels
state it, so that the reference picks the same texel."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

M32 = 0xFFFFFFFF
LUM = (0.212671, 0.715160, 0.072169)
TINY = 1e-30

# BXDF type bits (bxdf_types.h) of the lobes the configurations use
DIFFUSE, GLOSSY, ROUGH_REFLECTION = 2, 4, 8
ROUGH_DIELECTRIC, IDEAL_DIELECTRIC = 32, 64
SHADERS = {"diffuse": DIFFUSE, "glossy": GLOSSY,
           "rough_reflection": ROUGH_REFLECTION,
           "rough_dielectric": ROUGH_DIELECTRIC,
           "ideal_dielectric": IDEAL_DIELECTRIC}


# -- vectors ------------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def unit(a):
    return a * torch.rsqrt(dot(a, a).clamp_min(TINY))[..., None]


def pick(m, a, b):
    """``a`` where ``m``, else ``b``; vectors take a per-lane mask."""
    return torch.where(m[..., None] if b.dim() > m.dim() else m, a, b)


def div0(a, b):
    """a / b, and 0 where b is 0."""
    return torch.where(b != 0, a / torch.where(b == 0, 1.0, b), 0.0)


def as_f32(x):
    """``x`` rounded to float32 (an index's product, as the renderer
    forms it)."""
    return x.to(torch.float32)


# -- random numbers (random.cl) -----------------------------------------------

class Rng:
    """Each lane's stream: Bob Jenkins' 32-bit integer hash of the seed,
    the next seed being the hash; a draw is the hash's top 23 bits over
    2^23. Seeds are int64 tensors holding 32-bit values."""

    def __init__(self, seed, dtype):
        self.seed = seed.to(torch.int64)
        self.dtype = dtype

    def __call__(self):
        s = self.seed
        s = (s ^ 61) ^ (s >> 16)
        s = (s * 9) & M32
        s = s ^ (s >> 4)
        s = (s * 0x27D4EB2D) & M32
        s = s ^ (s >> 15)
        self.seed = s
        return (s >> 9).to(self.dtype) * (2.0 ** -23)


# -- sampling (utils.cl) ------------------------------------------------------

def frame(n):
    """An orthonormal pair around unit ``n`` (Duff et al. 2017), the sign
    taken from n.z > 0."""
    x, y, z = n.unbind(-1)
    s = torch.where(z > 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + z)
    b = x * y * a
    t = torch.stack([1.0 + s * x * x * a, s * b, -s * x], -1)
    bt = torch.stack([b, s + y * y * a, -y], -1)
    return t, bt


def cosine_dir(n, u1, u2):
    """A cosine-weighted direction about ``n``, and its pdf cos/pi."""
    t, bt = frame(n)
    phi = 2.0 * math.pi * u1
    r = torch.sqrt(u2)
    d = (t * (torch.cos(phi) * r)[..., None]
         + bt * (torch.sin(phi) * r)[..., None]
         + n * torch.sqrt((1.0 - u2).clamp_min(0.0))[..., None])
    return d, dot(n, d) / math.pi


def area_to_solid_angle(pdf_a, dist, cosine):
    return pdf_a * dist * dist / cosine.abs()


def reflect(d, n):
    """The mirror image of the incoming ``d`` about ``n``."""
    return d - n * (2.0 * dot(d, n))[..., None]


def refract(d, n, eta, cos_i, cos_t):
    """The refracted direction of the incoming ``d`` (utils.cl:61-64)."""
    return d * eta[..., None] + n * (eta * cos_i - cos_t)[..., None]


# -- Fresnel (fresnel.cl) -----------------------------------------------------

def fresnel(cos_i, eta_i, eta_t):
    """Unpolarised dielectric reflectance and cos(theta_t); 1 under total
    internal reflection."""
    sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(0.0))
    sin_t = eta_i / eta_t * sin_i
    cos_t = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(0.0))

    def ratio(a, b):
        return (a - b) / torch.where(a + b == 0, 1.0, a + b)
    rp = ratio(eta_t * cos_i, eta_i * cos_t)
    rs = ratio(eta_i * cos_i, eta_t * cos_t)
    f = 0.5 * (rp * rp + rs * rs)
    return torch.where(sin_t >= 1.0, 1.0, f), cos_t


# -- GGX (Walter et al. 2007) -------------------------------------------------

def ggx_d(alpha, n, m):
    """Eq. 33: alpha^2 / (pi cos^4 (alpha^2 + tan^2)^2), 0 behind n."""
    c = dot(n, m)
    c2 = c * c
    tan2 = (1.0 - c2) / c2.clamp_min(TINY)
    a2 = alpha * alpha
    den = math.pi * c2 * c2 * (a2 + tan2) ** 2
    return torch.where(c <= 0, 0.0, a2 / den.clamp_min(TINY))


def ggx_g1(alpha, v, n, m):
    """Eq. 34: 2 / (1 + sqrt(1 + alpha^2 tan^2(theta_v))), 0 where v sees
    the microfacet from the other side of n."""
    c = dot(n, v)
    c2 = c * c
    tan2 = torch.where(c2 > 0, (1.0 - c2) / c2.clamp_min(TINY), 0.0)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(c * dot(m, v) <= 0, 0.0, g)


def ggx_g(alpha, i, o, n, m):
    return ggx_g1(alpha, i, n, m) * ggx_g1(alpha, o, n, m)


def ggx_normal(alpha, n, u1, u2):
    """Eq. 35-36: a microfacet normal drawn from D |n.m|."""
    t, bt = frame(n)
    theta = torch.atan2(alpha * torch.sqrt(u1),
                        torch.sqrt((1.0 - u1).clamp_min(0.0)))
    phi = 2.0 * math.pi * u2
    st = torch.sin(theta)
    return (t * (st * torch.cos(phi))[..., None]
            + bt * (st * torch.sin(phi))[..., None]
            + n * torch.cos(theta)[..., None])


def pdf_reflection(alpha, o, n, h):
    """Eq. 24 with 14: D |n.h| / (4 |o.h|)."""
    oh = dot(o, h)
    p = ggx_d(alpha, n, h) * (dot(n, h) * 0.25
                              / torch.where(oh == 0, 1.0, oh)).abs()
    return torch.where(oh == 0, 0.0, p)


def _eta_sum(eta_i, eta_o, i, o, h):
    return eta_i * dot(i, h).abs() + eta_o * dot(o, h).abs()


def pdf_transmission(alpha, eta_i, eta_o, i, o, n, h):
    """D |n.h| |o.h| eta_o^2 / (eta_i |i.h| + eta_o |o.h|)^2 (ggx.cl:
    150-157)."""
    s = _eta_sum(eta_i, eta_o, i, o, h)
    p = (ggx_d(alpha, n, h) * dot(n, h).abs() * dot(o, h).abs()
         * eta_o * eta_o / (s * s).clamp_min(TINY))
    return torch.where(s == 0, 0.0, p)


def _focus(eta_i, eta_o, i, o, n, h):
    s = _eta_sum(eta_i, eta_o, i, o, h)
    return div0(eta_o * eta_o * dot(i, h).abs() * dot(o, h).abs(),
                dot(i, n) * dot(o, n) * s * s)


def _coat(ks, alpha, ni, i, o, n, h):
    """The GGX reflection lobe: ks F G D / (4 (i.n)(o.n)), F from i.n
    with eta ni (1 where ni <= 1)."""
    f = torch.where(ni > 1.0, fresnel(dot(i, n), torch.ones_like(ni),
                                      ni.clamp_min(1.0 + 1e-6))[0], 1.0)
    v = div0(f * ggx_g(alpha, i, o, n, h) * ggx_d(alpha, n, h) * 0.25,
             dot(i, n) * dot(o, n))
    return ks * v[..., None]


# -- materials and textures (utils.cl:139-219) --------------------------------

def texel(tex, u, v):
    """Nearest texel with wrap addressing: column floor(u w) mod w, row
    floor(v h) mod h, rows counted from the image's bottom; [0, 1]."""
    img = tex.rgb
    h, w = img.shape[:2]
    x = torch.floor(as_f32(u * w)).long().remainder(w)
    y = torch.floor(as_f32(v * h)).long().remainder(h)
    return img[y, x].to(u.dtype) / 255.0


def fetch(table, maps, u, v, fallback):
    """Each lane's texel of its texture ``maps`` (-1: ``fallback``)."""
    out = fallback.clone()
    for k, tex in enumerate(table):
        m = maps == k
        if m.any():
            out[m] = texel(tex, u[m], v[m])
    return out


def material_params(scene, mat_id, u, v, dt):
    """Each lane's material row, Kd with its map raised to 2.2 and Ks
    with its map (getMaterialParameters)."""
    m = scene.mats
    i = mat_id.clamp_min(0).long()
    g = lambda a: a[i].to(dt)
    kd = fetch(scene.textures, m.map_kd[i], u, v, g(m.kd))
    ks = fetch(scene.textures, m.map_ks[i], u, v, g(m.ks))
    return SimpleNamespace(
        kd=kd.clamp_min(0.0) ** 2.2, ks=ks, alpha=g(m.alpha), ni=g(m.ni),
        type=m.type[i], map_n=m.map_n[i])


def shading_normal(scene, hit_n, tri, u, v, map_n, dt):
    """The normal map's texel (2c - 1) in the hit triangle's tangent
    frame (utils.cl:174-207), where the material has one."""
    half = torch.full_like(hit_n, 0.5)
    half[:, 2] = 1.0
    t = fetch(scene.textures, map_n, u, v, half) * 2.0 - 1.0
    i = tri.clamp_min(0).long()
    e1, e2 = scene.e1[i].to(dt), scene.e2[i].to(dt)
    tuv = scene.uv[i].to(dt)                   # [n, 3, 2]
    d1, d2 = tuv[:, 1] - tuv[:, 0], tuv[:, 2] - tuv[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = (1.0 / torch.where(det == 0, 1.0, det))[..., None]
    tang = unit((e1 * d2[:, 1:] - e2 * d1[:, 1:]) * inv)
    btan = unit((e2 * d1[:, :1] - e1 * d2[:, :1]) * inv)
    nm = unit(tang * t[:, :1] + btan * t[:, 1:2] + hit_n * t[:, 2:])
    ok = (map_n >= 0) & (tri >= 0) & (det != 0)
    return pick(ok, nm, hit_n)


# -- the lobes (bxdf.cl) ------------------------------------------------------

def _glossy_ks_ni(mp):
    """The glossy coat's Ks and eta, each filled in from the other where
    unset (glossy.cl:12-35)."""
    k = (mp.ks.mean(-1)).clamp(0.0, 0.99).sqrt()
    ni = torch.where(mp.ni > 0, mp.ni, (1.0 + k) / (1.0 - k))
    r = torch.where(ni > 0, (ni - 1.0) / (ni + 1.0), 0.0)
    unset = (mp.ks == 0).all(-1)
    return pick(unset, (r * r)[..., None].expand_as(mp.ks), mp.ks), ni


def _dielectric_etas(mp, back):
    one = torch.ones_like(mp.ni)
    return torch.where(back, mp.ni, one), torch.where(back, one, mp.ni)


def bsdf_eval(mp, n, back, d_in, d_out):
    """f(d_in -> d_out) of each lane's lobe; the ideal dielectric gives
    0."""
    t = mp.type
    i = -d_in
    out = pick(t == DIFFUSE, mp.kd / math.pi, torch.zeros_like(n))
    h_r = unit(d_out - d_in)
    if (t == GLOSSY).any():
        ks, ni = _glossy_ks_ni(mp)
        fr = fresnel(dot(i, n), torch.ones_like(ni), ni)[0]
        g = (mp.kd / math.pi * (1.0 - fr)[..., None]
             + _coat(ks, mp.alpha, ni, i, d_out, n, h_r))
        out = pick(t == GLOSSY, g, out)
    if (t == ROUGH_REFLECTION).any():
        out = pick(t == ROUGH_REFLECTION,
                   _coat(mp.ks, mp.alpha, mp.ni, i, d_out, n, h_r), out)
    if (t == ROUGH_DIELECTRIC).any():
        eta_i, eta_o = _dielectric_etas(mp, back)
        f = fresnel(dot(i, n), eta_i, eta_o)[0]
        refl = div0(f * ggx_g(mp.alpha, i, d_out, n, h_r)
                    * ggx_d(mp.alpha, n, h_r) * 0.25,
                    dot(i, n) * dot(d_out, n))
        h_t = unit(d_in * eta_i[..., None] - d_out * eta_o[..., None])
        eta = eta_i / eta_o
        refr = mp.ks * ((1.0 - f) * eta * eta
                        * ggx_d(mp.alpha, -n, h_t)
                        * ggx_g(mp.alpha, i, d_out, -n, h_t)
                        * _focus(eta_i, eta_o, i, d_out, n, h_t)
                        )[..., None]
        out = pick(t == ROUGH_DIELECTRIC,
                   pick(back, refr, refl[..., None].expand_as(n)), out)
    return out


def bsdf_pdf(mp, n, back, d_in, d_out):
    """The solid-angle pdf with which ``bsdf_sample`` picks d_out; the
    ideal dielectric gives 0."""
    t = mp.type
    i = -d_in
    out = torch.where(t == DIFFUSE, dot(n, d_out) / math.pi,
                      torch.zeros_like(mp.alpha))
    h_r = unit(d_out - d_in)
    if (t == GLOSSY).any():
        _, ni = _glossy_ks_ni(mp)
        fr = fresnel(dot(i, n), torch.ones_like(ni), ni)[0]
        p = ((1.0 - fr) * dot(n, d_out) / math.pi
             + fr * pdf_reflection(mp.alpha, d_out, n, h_r))
        out = torch.where(t == GLOSSY, p, out)
    if (t == ROUGH_REFLECTION).any():
        out = torch.where(t == ROUGH_REFLECTION,
                          pdf_reflection(mp.alpha, d_out, n, h_r), out)
    if (t == ROUGH_DIELECTRIC).any():
        eta_i, eta_o = _dielectric_etas(mp, back)
        h_t = unit(d_in * eta_i[..., None] - d_out * eta_o[..., None])
        p = torch.where(back, pdf_transmission(mp.alpha, eta_i, eta_o, i,
                                               d_out, -n, h_t),
                        pdf_reflection(mp.alpha, d_out, n, h_r))
        out = torch.where(t == ROUGH_DIELECTRIC, p, out)
    return out


def bsdf_sample(mp, n, back, d_in, rng):
    """(d_out, pdf, f) of each lane's lobe from three draws, which every
    lobe takes."""
    ra, rb, rc = rng(), rng(), rng()
    t = mp.type
    i = -d_in
    d_out = torch.zeros_like(n)
    pdf = torch.zeros_like(mp.alpha)
    f = torch.zeros_like(n)

    def put(m, d, p, v):
        return pick(m, d, d_out), torch.where(m, p, pdf), pick(m, v, f)

    if (t == DIFFUSE).any():
        d, p = cosine_dir(n, ra, rb)
        d_out, pdf, f = put(t == DIFFUSE, d, p, mp.kd / math.pi)

    if (t == GLOSSY).any():
        ks, ni = _glossy_ks_ni(mp)
        fr = fresnel(dot(i, n), torch.ones_like(ni), ni)[0]
        spec = ra < fr
        h = ggx_normal(mp.alpha, n, rb, rc)
        d_s = reflect(d_in, h)
        d_d, _ = cosine_dir(n, rb, rc)
        d = pick(spec, d_s, d_d)
        h_d = unit(d - d_in)
        coat_p = torch.where(spec, pdf_reflection(mp.alpha, d, n, h),
                             pdf_reflection(mp.alpha, d, n, h_d))
        coat_f = pick(spec, _coat(ks, mp.alpha, ni, i, d, n, h),
                      _coat(ks, mp.alpha, ni, i, d, n, h_d))
        p = (1.0 - fr) * dot(n, d) / math.pi + fr * coat_p
        v = mp.kd / math.pi * (1.0 - fr)[..., None] + coat_f
        v = pick(dot(n, d) < 1e-5, torch.zeros_like(v), v)
        d_out, pdf, f = put(t == GLOSSY, d, p, v)

    if (t == ROUGH_REFLECTION).any():
        h = ggx_normal(mp.alpha, n, ra, rb)
        d = reflect(d_in, h)
        d_out, pdf, f = put(t == ROUGH_REFLECTION, d,
                            pdf_reflection(mp.alpha, d, n, h),
                            _coat(mp.ks, mp.alpha, mp.ni, i, d, n, h))

    if (t == ROUGH_DIELECTRIC).any():
        eta_i, eta_o = _dielectric_etas(mp, back)
        cos_i = dot(i, n)
        h = ggx_normal(mp.alpha, n, ra, rb)
        fr, cos_t = fresnel(cos_i, eta_i, eta_o)
        refl = rc < fr
        d_r = reflect(d_in, h)
        p_r = pdf_reflection(mp.alpha, d_r, n, h)
        v_r = div0(fr * ggx_g(mp.alpha, i, d_r, n, h)
                   * ggx_d(mp.alpha, n, h) * 0.25, cos_i * dot(d_r, n))
        eta = eta_i / eta_o
        d_t = refract(d_in, n, eta, cos_i, cos_t)
        n_t = pick(back, -n, n)
        h_t = unit(d_in * eta_i[..., None] - d_t * eta_o[..., None])
        p_t = pdf_transmission(mp.alpha, eta_i, eta_o, i, d_t, n_t, h_t)
        v_t = mp.ks * ((1.0 - fr) * eta * eta * ggx_d(mp.alpha, n_t, h_t)
                       * ggx_g(mp.alpha, i, d_t, n_t, h_t)
                       * _focus(eta_i, eta_o, i, d_t, n, h_t))[..., None]
        d_out, pdf, f = put(t == ROUGH_DIELECTRIC, pick(refl, d_r, d_t),
                            torch.where(refl, p_r, p_t),
                            pick(refl, v_r[..., None].expand_as(n), v_t))

    if (t == IDEAL_DIELECTRIC).any():
        eta_i, eta_o = _dielectric_etas(mp, back)
        cos_i = -dot(d_in, n)
        eta = eta_i / eta_o
        fr, cos_t = fresnel(cos_i, eta_i, eta_o)
        refl = ra < fr
        d = pick(refl, d_in + n * (2.0 * cos_i)[..., None],
                 refract(d_in, n, eta, cos_i, cos_t))
        c = dot(unit(d), n)
        v = pick(refl, torch.ones_like(n), mp.ks * (eta * eta)[..., None])
        d_out, pdf, f = put(t == IDEAL_DIELECTRIC, d, torch.ones_like(pdf),
                            v * div0(torch.ones_like(c), c)[..., None])
    return d_out, pdf, f


# -- the environment map (envmap.cpp, env_map.cl) -----------------------------

class EnvMap:
    """The lat-long env map from its .hdr file: the texels, and the stable
    Vose alias table (envmap.cpp:67-113) over the texels' luminance times
    sin(theta) of their row, which fluctus forms in float32. ``fast``:
    the route the renderer takes on the card, the radiance of the texel
    a direction falls in; otherwise bilinear between texel centres,
    clamped to the edge (OpenCL's CLK_FILTER_LINEAR,
    CLK_ADDRESS_CLAMP_TO_EDGE)."""

    def __init__(self, rgb: np.ndarray, device, fast: bool):
        h, w = rgb.shape[:2]
        self.w, self.h = w, h
        # the card's single-read route covers maps of up to 2^18 texels
        self.nearest = fast and w * h <= 1 << 18
        rows = np.sin(np.float32(np.pi)
                      * ((np.arange(h, dtype=np.float32) + 0.5) / h))
        lum = (np.float32(LUM[0]) * rgb[..., 0]
               + np.float32(LUM[1]) * rgb[..., 1]
               + np.float32(LUM[2]) * rgb[..., 2])
        weights = (lum * rows[:, None]).reshape(-1).astype(np.float64)
        mean = weights.sum() / (w * h)
        cells = weights / mean if mean > 0 else np.ones(w * h)
        self.prob, self.alias = _vose(cells)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.rgb = t(rgb.reshape(-1, 3).astype(np.float64))
        self.inv_mean = 1.0 / max(mean, 1e-30)
        self.prob_t, self.alias_t = t(self.prob), t(self.alias)

    def _lum(self, c):
        return c[:, 0] * LUM[0] + c[:, 1] * LUM[1] + c[:, 2] * LUM[2]

    def _cell_pdf(self, c, row, sin_theta):
        """Solid-angle pdf of the alias method's pick in the texel of
        radiance ``c`` in ``row``: its weight over the mean, over
        2 pi^2 sin(theta)."""
        sin_row = torch.sin(math.pi * (row.to(c.dtype) + 0.5) / self.h)
        return (self._lum(c) * sin_row * self.inv_mean
                / (2.0 * math.pi * math.pi)) / sin_theta

    def _uv(self, d):
        u = torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi) + 0.5
        v = torch.acos(d[:, 1].clamp(-1.0, 1.0)) / math.pi
        return u, v

    def radiance_pdf(self, d):
        """(radiance, MIS pdf) along the directions ``d`` (env_map.cl:
        37-41, 95-109); the pdf is 0 above d.y = 0.99."""
        dt = d.dtype
        u, v = self._uv(d)
        x = torch.floor(as_f32(u * self.w)).long().clamp_max(self.w - 1)
        y = torch.floor(as_f32(v * self.h)).long().clamp_max(self.h - 1)
        cell = self.rgb[y * self.w + x].to(dt)
        if self.nearest:
            c = cell
        else:
            fx, fy = u * self.w - 0.5, v * self.h - 0.5
            x0, y0 = torch.floor(fx), torch.floor(fy)
            tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
            cx = lambda k: (x0.long() + k).clamp(0, self.w - 1)
            cy = lambda k: (y0.long() + k).clamp(0, self.h - 1)
            at = lambda a, b: self.rgb[cy(b) * self.w + cx(a)].to(dt)
            c = ((at(0, 0) * (1 - tx) + at(1, 0) * tx) * (1 - ty)
                 + (at(0, 1) * (1 - tx) + at(1, 1) * tx) * ty)
        sin_theta = torch.sqrt((1.0 - d[:, 1] * d[:, 1]).clamp_min(1e-12))
        pdf = self._cell_pdf(cell, y, sin_theta)
        return c, torch.where(d[:, 1] > 0.99, 0.0, pdf)

    def sample(self, r):
        """(direction, pdf, radiance) of the alias method's pick for the
        draw ``r`` (env_map.cl:63-92)."""
        dt = r.dtype
        n = self.w * self.h
        x = r * n
        i = torch.floor(x).long().clamp_max(n - 1)
        keep = (x - i.to(dt)) < self.prob_t[i].to(dt)
        cell = torch.where(keep, i, self.alias_t[i].long())
        u = (cell.remainder(self.w).to(dt) + 0.5) / self.w
        v = (cell.to(dt) + 0.5) / n
        phi, theta = v * math.pi, u * (2.0 * math.pi) - math.pi
        s = torch.sin(phi)
        d = torch.stack([s * torch.sin(theta), torch.cos(phi),
                         -s * torch.cos(theta)], -1)
        c = self.rgb[cell].to(dt)
        pdf = torch.where(s != 0, self._cell_pdf(c, cell // self.w,
                                                 torch.where(s == 0, 1.0, s)),
                          0.0)
        if not self.nearest:
            c = self.radiance_pdf(d)[0]
        return d, pdf, c


def _vose(p: np.ndarray):
    """The stable Vose alias table of the cell weights ``p`` (mean 1):
    cells below 1 and the rest on two stacks in index order, each step
    pairing the top of both, the large cell going back on the stack its
    remainder belongs to; leftovers keep probability 1."""
    n = p.size
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    q = p.astype(np.float64).copy()
    small = [i for i in range(n) if q[i] < 1.0]
    large = [i for i in range(n) if q[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s], alias[s] = q[s], g
        q[g] = (q[g] + q[s]) - 1.0
        (small if q[g] < 1.0 else large).append(g)
    return prob, alias


# -- the camera (wf_raygen.cl) ------------------------------------------------

def camera_rays(cam, pixel, width, height, rng):
    """Each lane's pinhole camera ray through a jittered point of its
    pixel (the configurations' aperture is closed)."""
    dt = rng.dtype
    x = pixel.remainder(width).to(dt) + rng()
    y = pixel.to(dt) * (1.0 / width) + rng()
    sx = (2.0 * x / width - 1.0) * (width / height) * cam.fov_scale
    sy = (2.0 * y / height - 1.0) * cam.fov_scale
    d = unit(cam.right * sx[:, None] + cam.up * sy[:, None] + cam.dir)
    return cam.pos.expand_as(d), d


# -- the tonemap (mk_postprocess.cl, tonemap.cl) ------------------------------

# Hable's filmic curve with fluctus's constants, white point 11.2, and
# an exposure bias of 2
_A, _B, _C, _D, _E, _F, _W = 0.22, 0.30, 0.10, 0.20, 0.01, 0.30, 11.2


def _hable(x):
    return ((x * (_A * x + _C * _B) + _D * _E)
            / (x * (_A * x + _B) + _D * _F)) - _E / _F


def tonemap(color, weight, exposure, operator):
    """The displayed value of each film pixel ([n, 3] colour over its
    weight): exposure, the operator (0 linear, 1 Reinhard, 2 filmic,
    3 raw) and gamma 1/2.2 but for raw."""
    inv = torch.where(weight > 0, 1.0 / weight.clamp_min(TINY), 1.0)
    c = color * (inv * exposure)[:, None]
    if operator == 1:
        c = c / (1.0 + c)
    elif operator == 2:
        c = _hable(2.0 * c) / _hable(torch.tensor(_W, dtype=c.dtype))
    if operator == 3:
        return c
    return c.clamp_min(0.0) ** (1.0 / 2.2)
