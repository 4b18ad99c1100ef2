"""BSDF dispatcher: every lobe present in the scene (the static
``scene_types`` bitmask) is evaluated over the whole batch and selected per
lane, as the reference package's masked superkernel (bsdf/dispatch.py).

The lobes: diffuse (and mixed, which the reference short-circuits to
diffuse, bxdf.cl:30-32), glossy (a diffuse base under a GGX coat), GGX
rough reflection, GGX rough dielectric, ideal mirror, ideal dielectric
and emissive.

Conventions follow src/bxdf.cl: dir_in points toward the surface; sample
returns (dir_out, pdf_w, bsdf). Emissive sampling gives pdf = 0, which ends
the path (its emission is added by the integrator's implicit hit).

``bsdf_shade`` is a wavefront segment's BSDF work in one call: the NEE
ray's bsdf and pdf, the continuation sample and the path's new throughput
and origin, the three masked functions above and their epilogue, on any
device. It is the BSDF of ``surface_shade_plain`` (core/integrator_wf.py);
on the card the segment's kernel, csrc/surface_shade.cu, does the same
work per lane through csrc/bsdf_device.cuh, each lane its own lobe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bxdf_types as bx
from ..rng import rand_n
from ..sampling import INV_PI, cos_sample_hemisphere_uv
from ..texture_fetch import mat_get_albedo, mat_get_float3
from ..vec import Vec3, dot, is_zero, normalize, reflect0, refract1
from ..vec import where as vwhere
from . import ggx
from .fresnel import fresnel_dielectric, fresnel_dielectric_cos_t


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
    # per-lane atlas descriptors (off, w, h) baked into the tables (the
    # resolve's ATTR_T*_WH/OFF rows), or None: then each fetch gathers
    # them from the atlas
    kd_meta: tuple = None
    ks_meta: tuple = None
    n_meta: tuple = None


def resolve_material(mats, mat_id, uv_u, uv_v, atlas) -> ShadingParams:
    """Each lane's material row from ``mats`` (a MaterialsSoA) with its Kd
    (gamma-linearized) and Ks textures fetched (getMaterialParameters,
    utils.cl:209-219; the reference's dispatch.py:59-68): the shading
    parameters of tables that resolve nothing."""
    m = mats.gather(mat_id)
    return ShadingParams(
        Kd=mat_get_albedo(m.Kd, uv_u, uv_v, m.map_Kd, atlas),
        Ks=mat_get_float3(m.Ks, uv_u, uv_v, m.map_Ks, atlas),
        Ke=m.Ke, Kt=m.Kt, alpha=m.Ns, Ni=m.Ni, d=m.d, type=m.type,
        map_N=m.map_N, map_Kd=m.map_Kd, map_Ks=m.map_Ks)


def apply_textures(sp: ShadingParams, uv_u, uv_v, atlas) -> ShadingParams:
    """Overlay the Kd (gamma-linearized) and Ks textures onto the baked
    material parameters on the lanes whose material has the map
    (dispatch.py:67-86). The identity without textures; a map type no
    material uses is not fetched."""
    if atlas is None or atlas.count == 0:
        return sp
    z = Vec3.zeros(sp.alpha.shape, sp.alpha.device)
    if atlas.has_kd:
        kd = mat_get_albedo(z, uv_u, uv_v, sp.map_Kd, atlas,
                            meta=sp.kd_meta)
        sp = sp._replace(Kd=vwhere(sp.map_Kd >= 0, kd, sp.Kd))
    if atlas.has_ks:
        ks = mat_get_float3(z, uv_u, uv_v, sp.map_Ks, atlas,
                            meta=sp.ks_meta)
        sp = sp._replace(Ks=vwhere(sp.map_Ks >= 0, ks, sp.Ks))
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


# ---------------------------------------------------------------------------
# Glossy helpers (glossy.cl:12-35)
# ---------------------------------------------------------------------------

def _eta_to_ks(eta):
    r = torch.where(eta > 0.0, (eta - 1.0) / (eta + 1.0), 0.0)
    return r * r


def _ks_to_eta(ks: Vec3):
    k = torch.clamp((ks.x + ks.y + ks.z) / 3.0, 0.0, 0.99)
    s = torch.sqrt(k)
    return (s + 1.0) / (1.0 - s)


def _glossy_params(sp: ShadingParams):
    """Ks and Ni, each filled in from the other where unset (glossy.cl:
    30-35)."""
    ni = torch.where(sp.Ni > 0.0, sp.Ni, _ks_to_eta(sp.Ks))
    ks_auto = _eta_to_ks(ni)
    ks = vwhere(is_zero(sp.Ks), Vec3(ks_auto, ks_auto, ks_auto), sp.Ks)
    return ks, ni


def bxdf_sample(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3, seed,
                scene_types: int):
    """Sample the continuation direction. Returns (dir_out, pdf_w, bsdf,
    seed). Always consumes exactly 3 RNG draws, whatever the lobe."""
    (ra, rb, rc), seed = rand_n(seed, 3)
    t = sp.type
    shp = n.x.shape
    dev = n.x.device
    d_out = Vec3.zeros(shp, dev)
    pdf = torch.zeros(shp, dtype=torch.float32, device=dev)
    bsdf = Vec3.zeros(shp, dev)

    def put(m, d, p, f):
        return vwhere(m, d, d_out), torch.where(m, p, pdf), vwhere(m, f, bsdf)

    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED | bx.BXDF_EMISSIVE):
        d, p = cos_sample_hemisphere_uv(n, ra, rb)
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED), d, p,
                               sp.Kd * INV_PI)
        bsdf = vwhere(_sel(t, bx.BXDF_EMISSIVE), Vec3.ones(shp, dev), bsdf)

    if scene_types & bx.BXDF_GLOSSY:
        # both sub-lobes sampled, one picked by Fresnel and their pdfs and
        # values blended (glossy.cl:37-63)
        ks, ni = _glossy_params(sp)
        fr = fresnel_dielectric(-dot(dir_in, n), 1.0, ni)
        pick_spec = ra < fr
        d_spec, p_spec, f_spec = ggx.sample_reflect(n, ks, sp.alpha, ni,
                                                    dir_in, rb, rc)
        d_diff, _ = cos_sample_hemisphere_uv(n, rb, rc)
        d = vwhere(pick_spec, d_spec, d_diff)
        base_pdf = dot(n, d) * INV_PI
        coat_pdf = torch.where(pick_spec, p_spec,
                               ggx.pdf_reflect(n, sp.alpha, dir_in, d))
        coat_f = vwhere(pick_spec, f_spec,
                        ggx.eval_reflect(n, ks, sp.alpha, ni, dir_in, d))
        p = (1.0 - fr) * base_pdf + fr * coat_pdf
        f = sp.Kd * INV_PI * (1.0 - fr) + coat_f  # the coat has its Fresnel
        f = vwhere(dot(n, d) < 1e-5, Vec3.zeros(shp, dev), f)
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_GLOSSY), d, p, f)

    if scene_types & bx.BXDF_GGX_ROUGH_REFLECTION:
        d, p, f = ggx.sample_reflect(n, sp.Ks, sp.alpha, sp.Ni, dir_in, ra,
                                     rb)
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_GGX_ROUGH_REFLECTION), d, p,
                               f)

    if scene_types & bx.BXDF_GGX_ROUGH_DIELECTRIC:
        d, p, f = ggx.sample_refract(n, sp.Ks, sp.alpha, sp.Ni, backface,
                                     dir_in, ra, rb, rc)
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_GGX_ROUGH_DIELECTRIC), d, p,
                               f)

    if scene_types & bx.BXDF_IDEAL_REFLECTION:
        # ideal_reflection.cl:9-21
        d = reflect0(dir_in, n)
        f = sp.Ks * _inv_cos(dot(normalize(d), n))
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_IDEAL_REFLECTION), d, 1.0, f)

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
        f3 = vwhere(refl, Vec3.ones(shp, dev), sp.Ks * (eta * eta))
        f3 = f3 * _inv_cos(dot(normalize(d), n))
        d_out, pdf, bsdf = put(_sel(t, bx.BXDF_IDEAL_DIELECTRIC), d, 1.0, f3)

    return d_out, pdf, bsdf, seed


def bxdf_eval(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3,
              dir_out: Vec3, scene_types: int) -> Vec3:
    """bxdfEval (bxdf.cl:112-203); singular lobes evaluate to 0."""
    t = sp.type
    out = Vec3.zeros(n.x.shape, n.x.device)
    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED):
        m = _sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED)
        out = vwhere(m, sp.Kd * INV_PI, out)
    if scene_types & bx.BXDF_GLOSSY:
        ks, ni = _glossy_params(sp)
        coat = ggx.eval_reflect(n, ks, sp.alpha, ni, dir_in, dir_out)
        fr = fresnel_dielectric(-dot(dir_in, n), 1.0, ni)
        out = vwhere(_sel(t, bx.BXDF_GLOSSY),
                     sp.Kd * INV_PI * (1.0 - fr) + coat, out)
    if scene_types & bx.BXDF_GGX_ROUGH_REFLECTION:
        out = vwhere(_sel(t, bx.BXDF_GGX_ROUGH_REFLECTION),
                     ggx.eval_reflect(n, sp.Ks, sp.alpha, sp.Ni, dir_in,
                                      dir_out), out)
    if scene_types & bx.BXDF_GGX_ROUGH_DIELECTRIC:
        out = vwhere(_sel(t, bx.BXDF_GGX_ROUGH_DIELECTRIC),
                     ggx.eval_refract(n, sp.Ks, sp.alpha, sp.Ni, backface,
                                      dir_in, dir_out), out)
    if scene_types & bx.BXDF_EMISSIVE:
        m = _sel(t, bx.BXDF_EMISSIVE)
        out = vwhere(m, sp.Ke, out)
    return out


def bxdf_pdf(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3,
             dir_out: Vec3, scene_types: int):
    """bxdfPdf (bxdf.cl:206-296); singular lobes have pdf 0."""
    t = sp.type
    out = torch.zeros(n.x.shape, dtype=torch.float32, device=n.x.device)
    if scene_types & (bx.BXDF_DIFFUSE | bx.BXDF_MIXED):
        m = _sel(t, bx.BXDF_DIFFUSE, bx.BXDF_MIXED)
        out = torch.where(m, dot(n, dir_out) * INV_PI, out)
    if scene_types & bx.BXDF_GLOSSY:
        _, ni = _glossy_params(sp)
        base = dot(n, dir_out) * INV_PI
        coat = ggx.pdf_reflect(n, sp.alpha, dir_in, dir_out)
        fr = fresnel_dielectric(-dot(dir_in, n), 1.0, ni)
        out = torch.where(_sel(t, bx.BXDF_GLOSSY),
                          (1.0 - fr) * base + fr * coat, out)
    if scene_types & bx.BXDF_GGX_ROUGH_REFLECTION:
        out = torch.where(_sel(t, bx.BXDF_GGX_ROUGH_REFLECTION),
                          ggx.pdf_reflect(n, sp.alpha, dir_in, dir_out), out)
    if scene_types & bx.BXDF_GGX_ROUGH_DIELECTRIC:
        out = torch.where(_sel(t, bx.BXDF_GGX_ROUGH_DIELECTRIC),
                          ggx.pdf_refract(n, sp.alpha, sp.Ni, backface,
                                          dir_in, dir_out), out)
    return out


# ---------------------------------------------------------------------------
# A segment's BSDF work in one call
# ---------------------------------------------------------------------------

class Shaded(NamedTuple):
    """What ``bsdf_shade`` gives each lane."""
    nee_bsdf: Vec3            # the NEE ray's bsdf (bxdf_eval)
    nee_pdf: torch.Tensor     # its pdf (bxdf_pdf), clamped at 0
    dir: Vec3                 # the continuation ray's direction
    pdf: torch.Tensor         # and its pdf
    seed: torch.Tensor        # after the sample's three draws
    T: Vec3                   # the path's new throughput (0 when the
                              # sample has pdf 0 or bsdf 0)
    orig: Vec3                # the continuation ray's origin


def bsdf_shade(n: Vec3, sp: ShadingParams, backface, dir_in: Vec3,
               dir_nee: Vec3, seed, T: Vec3, P: Vec3,
               scene_types: int) -> Shaded:
    """A segment's BSDF work for every lane: ``bxdf_eval`` and ``bxdf_pdf``
    of the NEE direction, ``bxdf_sample`` of the continuation, then the
    new throughput T f cos / pdf and the origin P + 1e-4 d. n the shading
    normal (flipped to the side of dir_in), sp the lane's material,
    dir_nee the NEE ray's direction, seed the lane's RNG state, T its
    throughput, P its hit point."""
    nee_bsdf = bxdf_eval(n, sp, backface, dir_in, dir_nee, scene_types)
    nee_pdf = torch.clamp_min(bxdf_pdf(n, sp, backface, dir_in, dir_nee,
                                       scene_types), 0.0)
    d, pdf_w, f, seed = bxdf_sample(n, sp, backface, dir_in, seed,
                                    scene_types)
    bad = (pdf_w == 0.0) | is_zero(f)
    new_T = vwhere(bad, Vec3.zeros(seed.shape, seed.device),
                   T * f * (dot(n, d) / torch.where(bad, 1.0, pdf_w)))
    return Shaded(nee_bsdf, nee_pdf, d, pdf_w, seed, new_T, P + d * 1e-4)
