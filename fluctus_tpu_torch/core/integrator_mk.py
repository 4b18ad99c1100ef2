"""Exact-spp "megastep" integrator (the reference package's
core/integrator_mk.py; the reference's microkernel path mk_raygen /
mk_next_vertex / mk_sample_bsdf / mk_splat, driven by Tracer::renderSingle,
tracer.cpp:108-182), plus the Film, FeatureFilm and RenderStats types
both integrators use.

One ``render_sample`` call renders exactly one sample for every pixel:
camera rays, then ``max_bounces + 1`` bounces of a Python loop, each
fusing nextVertex (trace + implicit env and area-light hits with MIS,
mk_next_vertex.cl:72-117) and sampleBsdf (NEE toward the env map and
toward the area light, each with its own shadow ray; BSDF continuation,
mk_sample_bsdf.cl:68-187). The per-pixel phase machine becomes an
``alive`` mask; every lane is traced every bounce. The env map and the
area light are each on or off, implicit light hits and NEE each on or off
(MIS between them when both are), Russian roulette past MIN_PATH_LENGTH
when ``config.use_roulette`` (``Renderer.render_single`` turns it off, as
the reference's), textures and normal maps, and with ``config.denoiser``
the denoiser's guide features (``FeatureFilm``). MIS weights,
offsets (1e-3 shadow origin, 1e-4 continuation origin) and the
lightPickProb = 1 convention are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import bxdf_types as bx
from ..bsdf import apply_textures, bxdf_eval, bxdf_pdf, bxdf_sample
from ..envmap import env_radiance_and_pdf, env_sample
from ..geom import MIN_PATH_LENGTH, RenderConfig, RenderParams
from ..rng import rand
from ..sampling import pdf_area_to_solid_angle, sample_area_light
from ..vec import Vec3, dot, is_zero, length, luminance, where as vwhere
from .camera import generate_camera_rays
from .trace import tangent_space_normal, trace_extension, trace_shadow


class Film(NamedTuple):
    color: Vec3            # [num_pixels] accumulated radiance
    weight: torch.Tensor   # [num_pixels] sample counts

    @staticmethod
    def zeros(num_pixels: int, device) -> "Film":
        return Film(Vec3.zeros(num_pixels, device),
                    torch.zeros(num_pixels, dtype=torch.float32,
                                device=device))


class FeatureFilm(NamedTuple):
    """Denoiser guide buffers (the reference's denoiserAlbedo /
    denoiserNormal PBOs, clcontext.cpp:337-402): per pixel the accumulated
    albedo of the first non-singular hit and the camera-space normal of
    the first hit, each with its own accumulation weight."""
    albedo: Vec3
    albedo_w: torch.Tensor
    normal: Vec3
    normal_w: torch.Tensor

    @staticmethod
    def zeros(num_pixels: int, device) -> "FeatureFilm":
        z = torch.zeros(num_pixels, dtype=torch.float32, device=device)
        return FeatureFilm(Vec3.zeros(num_pixels, device), z,
                           Vec3.zeros(num_pixels, device), z)


class RenderStats(NamedTuple):
    """Ray and sample counters (geom.h:279-285 analogue)."""
    primary_rays: int
    extension_rays: int
    shadow_rays: int
    samples: int

    @staticmethod
    def zeros():
        return RenderStats(0, 0, 0, 0)

    def __add__(self, o):
        return RenderStats(self.primary_rays + o.primary_rays,
                           self.extension_rays + o.extension_rays,
                           self.shadow_rays + o.shadow_rays,
                           self.samples + o.samples)


def _bounce(scene, params: RenderParams, cfg: RenderConfig, b: int, s: dict):
    """One bounce of every lane (integrator_mk.py:114-283)."""
    use_env = cfg.use_env_map and scene.env is not None
    light = params.area_light if cfg.use_area_light else None
    path_len = b + 1      # nextVertex increments before the implicit logic
    alive, seed, T, Ei = s["alive"], s["seed"], s["T"], s["Ei"]
    orig, d = s["orig"], s["dir"]
    use_mis = (path_len > 1) & ~s["last_specular"]

    hit, sp = trace_extension(orig, d, scene, light, cfg.sample_impl,
                              want_shading=True)
    ext_count = s["ext_count"] + alive.sum()
    n = alive.shape[0]

    # ---- implicit environment hit (mk_next_vertex.cl:72-95): the camera
    # ray's always, later ones with implicit sampling, MIS-weighted when
    # NEE is on too
    miss = alive & (hit.i < 0)
    if use_env:
        bg_raw, direct_pdf = env_radiance_and_pdf(scene.env, d, cfg.fast_env)
        bg = bg_raw * params.env_map_strength
        if not cfg.sample_impl and path_len != 1:
            bg = Vec3.zeros(n, d.x.device)
        w = 1.0
        if cfg.sample_impl and cfg.sample_expl:
            w_mis = s["last_pdf_w"] / torch.clamp_min(
                s["last_pdf_w"] + direct_pdf, 1e-30)
            w = torch.where(use_mis, w_mis, 1.0)
        Ei = vwhere(miss, Ei + T * bg * w, Ei)
    alive = alive & ~miss

    # ---- implicit area light hit (mk_next_vertex.cl:96-117), MIS-weighted
    # when NEE is on (the trace only reports it with implicit sampling)
    if light is not None:
        al_hit = alive & (hit.area_light_hit > 0)
        mis_w = 1.0
        if cfg.sample_expl:
            pdf_a = 1.0 / (4.0 * light.size_x * light.size_y)
            dist = length(hit.P - orig)
            pdf_w = pdf_area_to_solid_angle(pdf_a, dist, -dot(d, hit.N))
            w_mis = s["last_pdf_w"] / torch.clamp_min(
                s["last_pdf_w"] + pdf_w, 1e-30)
            mis_w = torch.where(use_mis, w_mis, 1.0)
        Ei = vwhere(al_hit, Ei + T * light.E * mis_w, Ei)
        alive = alive & ~al_hit

    # ---- surface shading (mk_sample_bsdf.cl) -----------------------------
    sp = apply_textures(sp, hit.uv_u, hit.uv_v, scene.atlas)
    nrm = tangent_space_normal(hit, scene.tri_frames, sp.map_N, scene.atlas,
                               meta=sp.n_meta)
    backface = dot(nrm, d) > 0.0
    nrm = vwhere(backface, -nrm, nrm)
    nee_orig = hit.P - d * 1e-3

    # implicit triangle emission (weight 1; emissive surfaces are never
    # NEE-sampled), which ends the path
    em = alive & (sp.type == bx.BXDF_EMISSIVE)
    Ei = vwhere(em, Ei + T * sp.Ke, Ei)
    alive = alive & ~em
    singular = (sp.type & bx.BXDF_SINGULAR_MASK) != 0

    # ---- denoiser guide features (wf_logic.cl:214-237): the first hit's
    # normal in camera space (rows right, up, -dir) and the first
    # non-singular hit's albedo
    feat = {}
    if cfg.denoiser:
        cam = params.camera
        nm = alive & (path_len == 1)
        cs = Vec3(dot(cam.right, nrm), dot(cam.up, nrm), -dot(cam.dir, nrm))
        am = alive & ~singular & ~s["first_diffuse"]
        feat = dict(
            first_diffuse=s["first_diffuse"] | (alive & ~singular),
            feat_albedo=vwhere(am, s["feat_albedo"] + sp.Kd,
                               s["feat_albedo"]),
            feat_albedo_w=s["feat_albedo_w"] + am.to(torch.float32),
            feat_normal=vwhere(nm, s["feat_normal"] + cs, s["feat_normal"]),
            feat_normal_w=s["feat_normal_w"] + nm.to(torch.float32))

    # ---- NEE with explicit sampling, lightPickProb = 1: toward the env
    # map (a shadow ray of 2 world radii that the area light's body also
    # blocks), then toward the area light (mk_sample_bsdf.cl:68-147)
    do_nee = alive & ~singular
    shadow_count = s["shadow_count"]
    impl = 1.0 if cfg.sample_impl else 0.0
    if cfg.sample_expl and use_env:
        u_env, seed = rand(seed)
        L, direct_pdf, env_raw = env_sample(scene.env, u_env, cfg.fast_env)
        len_l = params.world_radius + params.world_radius
        occluded = trace_shadow(nee_orig, L, torch.ones_like(u_env) * len_l,
                                scene, light, True)
        shadow_count = shadow_count + do_nee.sum()
        brdf = bxdf_eval(nrm, sp, backface, d, L, cfg.material_types)
        cos_th = torch.clamp_min(dot(L, nrm), 0.0)
        bsdf_pdf = torch.clamp_min(bxdf_pdf(nrm, sp, backface, d, L,
                                            cfg.material_types), 0.0)
        env_li = env_raw * params.env_map_strength
        denom = direct_pdf + impl * bsdf_pdf
        contrib = brdf * T * env_li * (cos_th / torch.clamp_min(denom,
                                                                1e-30))
        ok = do_nee & ~occluded & (direct_pdf != 0.0)
        Ei = vwhere(ok, Ei + contrib, Ei)

    if cfg.sample_expl and light is not None:
        pdf_a, pos_l, seed = sample_area_light(light, seed)
        L = pos_l - nee_orig
        len_l = length(L)
        L = L * (1.0 / torch.clamp_min(len_l, 1e-30))
        occluded = trace_shadow(nee_orig, L, len_l, scene, None, False)
        shadow_count = shadow_count + do_nee.sum()
        cos_light = torch.clamp_min(dot(light.N, -L), 0.0)
        brdf = bxdf_eval(nrm, sp, backface, d, L, cfg.material_types)
        cos_th = torch.clamp_min(dot(L, nrm), 0.0)
        direct_pdf = pdf_area_to_solid_angle(pdf_a, len_l, cos_light)
        bsdf_pdf = torch.clamp_min(bxdf_pdf(nrm, sp, backface, d, L,
                                            cfg.material_types), 0.0)
        denom = direct_pdf + impl * bsdf_pdf
        contrib = brdf * T * light.E * (cos_th / torch.clamp_min(denom,
                                                                 1e-30))
        ok = do_nee & ~occluded & (cos_light > 0.0)
        Ei = vwhere(ok, Ei + contrib, Ei)

    # ---- Russian roulette (mk_sample_bsdf.cl:148-157): its draw before
    # the BSDF sample's, the continuation pdf scaled by contProb
    terminate = ~alive
    cont_prob = 1.0
    if cfg.use_roulette:
        u_rr, seed = rand(seed)
        cp = torch.clamp(luminance(T), 0.01, 0.5)
        rr_active = path_len > MIN_PATH_LENGTH
        cont_prob = cp if rr_active else 1.0
        if rr_active:
            terminate = terminate | (u_rr > cp)

    # ---- continuation (mk_sample_bsdf.cl:159-187) ------------------------
    d_new, pdf_w, f, seed = bxdf_sample(nrm, sp, backface, d, seed,
                                        cfg.material_types)
    pdf_w = pdf_w * cont_prob
    terminate = terminate | (pdf_w == 0.0) | is_zero(f)
    new_T = T * f * (dot(nrm, d_new) / torch.where(pdf_w == 0.0, 1.0, pdf_w))
    new_orig = hit.P + d_new * 1e-4
    alive = alive & ~terminate
    return dict(
        orig=vwhere(alive, new_orig, orig), dir=vwhere(alive, d_new, d),
        seed=seed, T=vwhere(alive, new_T, T), Ei=Ei, alive=alive,
        last_pdf_w=torch.where(alive, pdf_w, s["last_pdf_w"]),
        last_specular=torch.where(alive, singular, s["last_specular"]),
        shadow_count=shadow_count, ext_count=ext_count, **feat)


def render_sample(scene, params: RenderParams, film: Film, seed,
                  config: RenderConfig, features: FeatureFilm = None):
    """One sample per pixel. seed: [num_pixels] int64 holding uint32.
    Returns (film, seed, stats), and with ``config.denoiser`` also
    ``features`` (zeros when None) plus this sample's guide features.
    Extension rays count the lanes alive at each bounce, minus the
    primary rays, as the reference."""
    cfg = config
    n = cfg.num_pixels
    dev = seed.device
    pixel_idx = torch.arange(n, dtype=torch.int32, device=dev)
    orig, d, seed = generate_camera_rays(
        pixel_idx, params.camera, cfg.width, cfg.height,
        params.world_radius, seed)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    s = dict(orig=orig, dir=d, seed=seed,
             T=Vec3.ones(n, dev), Ei=Vec3.zeros(n, dev),
             alive=torch.ones(n, dtype=torch.bool, device=dev),
             last_pdf_w=torch.ones(n, dtype=torch.float32, device=dev),
             last_specular=torch.ones(n, dtype=torch.bool, device=dev),
             shadow_count=zero, ext_count=zero)
    if cfg.denoiser:
        fz = torch.zeros(n, dtype=torch.float32, device=dev)
        s.update(first_diffuse=torch.zeros(n, dtype=torch.bool, device=dev),
                 feat_albedo=Vec3.zeros(n, dev), feat_albedo_w=fz,
                 feat_normal=Vec3.zeros(n, dev), feat_normal_w=fz)
    for b in range(cfg.max_bounces + 1):
        s = _bounce(scene, params, cfg, b, s)

    # ---- splat (mk_splat.cl:35-47): every path adds its Ei ---------------
    film = Film(color=film.color + s["Ei"], weight=film.weight + 1.0)
    counts = torch.stack([s["ext_count"], s["shadow_count"]]).tolist()
    stats = RenderStats(primary_rays=n, extension_rays=counts[0] - n,
                        shadow_rays=counts[1], samples=n)
    if cfg.denoiser:
        f = features or FeatureFilm.zeros(n, dev)
        features = FeatureFilm(
            albedo=f.albedo + s["feat_albedo"],
            albedo_w=f.albedo_w + s["feat_albedo_w"],
            normal=f.normal + s["feat_normal"],
            normal_w=f.normal_w + s["feat_normal_w"])
        return film, s["seed"], stats, features
    return film, s["seed"], stats
