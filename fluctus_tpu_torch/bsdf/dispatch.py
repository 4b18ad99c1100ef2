"""BSDF dispatcher: every lobe present in the scene (the static
``scene_types`` bitmask) is evaluated over the whole batch and selected per
lane, as the reference package's masked superkernel (bsdf/dispatch.py).

Ported lobes: diffuse (and mixed, which the reference short-circuits to
diffuse, bxdf.cl:30-32), ideal mirror, ideal dielectric and emissive. A
scene naming glossy, GGX rough reflection or rough dielectric raises
``NotImplementedError`` (see ``check_lobes``).

Conventions follow src/bxdf.cl: dir_in points toward the surface; sample
returns (dir_out, pdf_w, bsdf). Emissive sampling gives pdf = 0, which ends
the path (its emission is added by the integrator's implicit hit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bxdf_types as bx
from ..rng import rand_n
from ..sampling import INV_PI, cos_sample_hemisphere_uv
from ..vec import Vec3, dot, normalize, reflect0, refract1
from ..vec import where as vwhere
from .fresnel import fresnel_dielectric_cos_t

PORTED_LOBES = (bx.BXDF_DIFFUSE | bx.BXDF_MIXED | bx.BXDF_IDEAL_REFLECTION
                | bx.BXDF_IDEAL_DIELECTRIC | bx.BXDF_EMISSIVE)


def check_lobes(scene_types: int):
    """Raise for BXDF lobes the port does not have yet."""
    for t in bx.ALL_TYPES:
        if scene_types & t and not t & PORTED_LOBES:
            raise NotImplementedError(
                f"BXDF lobe '{bx.type_name(t)}' is not ported to "
                "fluctus_tpu_torch yet")


class ShadingParams(NamedTuple):
    """Per-lane resolved material parameters."""
    Kd: Vec3      # albedo, gamma-linearized (matGetAlbedo)
    Ks: Vec3
    Ke: Vec3
    Kt: Vec3
    alpha: torch.Tensor   # GGX alpha (Ns post-remap)
    Ni: torch.Tensor
    d: torch.Tensor
    type: torch.Tensor    # int32 bxdf bits
    map_N: torch.Tensor
    map_Kd: torch.Tensor
    map_Ks: torch.Tensor


def apply_textures(sp: ShadingParams, uv_u, uv_v):
    """Overlay Kd/Ks textures onto the baked material parameters. The port
    has no texture atlas yet (scenes with textures are refused at load),
    so this is the reference's empty-atlas branch: the identity
    (dispatch.py:76)."""
    return sp


def _sel(t, *types):
    m = t == types[0]
    for ty in types[1:]:
        m |= t == ty
    return m


def refract_reflect(d: Vec3, n: Vec3, cos_i):
    """reflect(dir, n, &cosI) = dir + 2 cosI n (utils.cl:46-49)."""
    return d + n * (cos_i + cos_i)


def _inv_cos(cos_o):
    return torch.where(cos_o != 0.0,
                       1.0 / torch.where(cos_o == 0.0, 1.0, cos_o), 0.0)


def bxdf_sample(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3, seed,
                scene_types: int):
    """Sample the continuation direction. Returns (dir_out, pdf_w, bsdf,
    seed). Always consumes exactly 3 RNG draws."""
    check_lobes(scene_types)
    (ra, rb, rc), seed = rand_n(seed, 3)
    t = sp.type
    shp = n.x.shape
    dev = n.x.device
    d_out = Vec3.zeros(shp, dev)
    pdf = torch.zeros(shp, dtype=torch.float32, device=dev)
    bsdf = Vec3.zeros(shp, dev)

    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED | bx.BXDF_EMISSIVE):
        d, p = cos_sample_hemisphere_uv(n, ra, rb)
        f = sp.Kd * INV_PI
        m = _sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED)
        d_out = vwhere(m, d, d_out)
        pdf = torch.where(m, p, pdf)
        bsdf = vwhere(m, f, bsdf)
        me = _sel(t, bx.BXDF_EMISSIVE)
        bsdf = vwhere(me, Vec3.ones(shp, dev), bsdf)

    if scene_types & bx.BXDF_IDEAL_REFLECTION:
        # ideal_reflection.cl:9-21
        d = reflect0(dir_in, n)
        cos_o = dot(normalize(d), n)
        f = sp.Ks * _inv_cos(cos_o)
        m = _sel(t, bx.BXDF_IDEAL_REFLECTION)
        d_out = vwhere(m, d, d_out)
        pdf = torch.where(m, 1.0, pdf)
        bsdf = vwhere(m, f, bsdf)

    if scene_types & bx.BXDF_IDEAL_DIELECTRIC:
        # ideal_dielectric.cl:10-45
        cos_i = -dot(dir_in, n)
        n1 = torch.where(backface, sp.Ni, 1.0)
        n2 = torch.where(backface, 1.0, sp.Ni)
        eta = n1 / n2
        fr, cos_t = fresnel_dielectric_cos_t(cos_i, n1, n2)
        refl = ra < fr
        d_refl = refract_reflect(dir_in, n, cos_i)
        d_refr = refract1(dir_in, n, eta, cos_i, cos_t)
        d = vwhere(refl, d_refl, d_refr)
        absorb = sp.Ks * (eta * eta)
        f3 = vwhere(refl, Vec3.ones(shp, dev), absorb)
        cos_o = dot(normalize(d), n)
        f3 = f3 * _inv_cos(cos_o)
        m = _sel(t, bx.BXDF_IDEAL_DIELECTRIC)
        d_out = vwhere(m, d, d_out)
        pdf = torch.where(m, 1.0, pdf)
        bsdf = vwhere(m, f3, bsdf)

    return d_out, pdf, bsdf, seed


def bxdf_eval(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3,
              dir_out: Vec3, scene_types: int) -> Vec3:
    """bxdfEval (bxdf.cl:112-203); singular lobes evaluate to 0."""
    check_lobes(scene_types)
    t = sp.type
    out = Vec3.zeros(n.x.shape, n.x.device)
    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED):
        m = _sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED)
        out = vwhere(m, sp.Kd * INV_PI, out)
    if scene_types & bx.BXDF_EMISSIVE:
        m = _sel(t, bx.BXDF_EMISSIVE)
        out = vwhere(m, sp.Ke, out)
    return out


def bxdf_pdf(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3,
             dir_out: Vec3, scene_types: int):
    """bxdfPdf (bxdf.cl:206-296); singular lobes have pdf 0."""
    check_lobes(scene_types)
    t = sp.type
    out = torch.zeros(n.x.shape, dtype=torch.float32, device=n.x.device)
    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED):
        m = _sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED)
        out = torch.where(m, dot(n, dir_out) * INV_PI, out)
    return out
