"""One wavefront segment's logic, lane by lane: what each path does with
the hit it was handed (implicit env and area-light hits with MIS, the
next-event shadow ray's result, the splat of a terminated path, the
textures, the normal map, the next-event ray and the material's sample,
and a new camera ray for a path that ended), after fluctus's wavefront
logic kernel, with the group-level steps (the film splat and the pixel
ring's cursor) left to ``checks``. It runs on any subset of lanes, since
every step here is per lane, in the float type it is given.

Inputs are the program's pool before the segment, its hit record and
shadow result, and the new pixel a lane that ended was given; everything
the scene supplies (materials, textures, the triangles' tangent frames,
the env map, camera and light) comes from the reference's own scene
(``scene_ref``) and its shading (``shading``). Roulette is off in every
cell, so it is not written out."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .shading import (IDEAL_DIELECTRIC, Rng, area_to_solid_angle,
                      bsdf_eval, bsdf_pdf, bsdf_sample, camera_rays, dot,
                      material_params, pick, shading_normal)


def intersect_area_light(o, d, light, t_prev):
    """Hits of the rays ``o, d`` [n, 3] on the quad light's front before
    ``t_prev`` (intersect.cl:124-155), and their distance."""
    denom = dot(d, light.N)
    t = dot(light.pos - o, light.N) / torch.where(denom == 0, 1.0, denom)
    rel = o + d * t[:, None] - light.pos
    inside = ((dot(rel, light.right).abs() <= light.size_x)
              & (dot(rel, light.up).abs() <= light.size_y))
    return (denom < 0) & inside & (t > 0) & (t < t_prev), t


def cast(ns, dt):
    """A namespace with its float tensors in ``dt``."""
    return SimpleNamespace(**{
        k: (v.to(dt) if torch.is_tensor(v) and v.is_floating_point()
            else cast(v, dt) if isinstance(v, SimpleNamespace) else v)
        for k, v in vars(ns).items()})


def segment_lanes(pool, hit, occluded, new_pixel, scene, params, cfg, dt):
    """The segment's per-lane outcome, computed in ``dt``. ``pool`` holds
    the lanes' fields before the segment (names as the program's pool;
    vectors [n, 3]), ``hit`` their hit records (P, N, u, v, i, light,
    mat_id), ``occluded`` their shadow rays' result, ``new_pixel`` the
    true pixel a lane that ends starts on. ``scene``: a ``RefScene``;
    ``params``: its ``params()``; ``cfg``: ``width``, ``height``,
    ``max_bounces``, ``sample_impl``, ``sample_expl``. Returns a
    namespace of the lanes' splat record and new pool fields."""
    pool, hit, params = cast(pool, dt), cast(hit, dt), cast(params, dt)
    n = pool.seed.shape[0]
    zeros3 = torch.zeros(n, 3, dtype=dt, device=pool.seed.device)
    env, light = scene.env, params.light
    T, Ei = pool.T, pool.Ei
    plen = pool.path_len + 1
    shadow_blocked = torch.where(pool.shadow_pending, occluded, True)

    terminate = plen <= 0
    if cfg.max_bounces > 0:
        terminate |= plen >= cfg.max_bounces + 1
    terminate |= (T == 0).all(-1) | (pool.last_pdf_w == 0)
    use_mis = (plen > 1) & ~pool.last_specular

    if env is not None:
        miss = (hit.i < 0) & ~terminate & (plen > 0)
        bg, direct_pdf = env.radiance_pdf(pool.dir)
        bg = bg * params.env_strength
        if not cfg.sample_impl:
            bg = pick(plen == 1, bg, zeros3)
        w = torch.ones_like(direct_pdf)
        if cfg.sample_impl and cfg.sample_expl:
            actual = pool.last_pdf_w * pool.last_light_pick
            w = torch.where(use_mis, actual
                            / (actual + direct_pdf).clamp_min(1e-30), 1.0)
        Ei = pick(miss, Ei + T * bg * w[:, None], Ei)
    terminate |= hit.i < 0

    if light is not None:
        al = hit.light & ~terminate
        mis_w = torch.ones_like(pool.last_pdf_w)
        if cfg.sample_expl:
            pdf_a = 1.0 / (4.0 * light.size_x * light.size_y)
            dist = (hit.P - pool.orig).norm(dim=-1)
            pdf_w = area_to_solid_angle(pdf_a, dist, -dot(pool.dir, hit.N))
            w_mis = pool.last_pdf_w / (
                pool.last_pdf_w + pdf_w * pool.last_light_pick
            ).clamp_min(1e-30)
            mis_w = torch.where(use_mis, w_mis, 1.0)
        Ei = pick(al, Ei + T * light.E * mis_w[:, None], Ei)
        terminate |= al

    if cfg.sample_expl:
        denom = (pool.last_light_pick * pool.last_pdf_direct
                 + float(cfg.sample_impl) * pool.last_pdf_implicit)
        contrib = pool.last_bsdf * pool.last_T * pool.last_emission * (
            pool.last_cos_th / denom.clamp_min(1e-30))[:, None]
        Ei = pick(~shadow_blocked, Ei + contrib, Ei)

    splat = terminate & (plen > 0)
    splat_rgb = pick(splat, Ei, zeros3)

    alive = ~terminate
    mp = material_params(scene, hit.mat_id, hit.u, hit.v, dt)
    nrm = shading_normal(scene, hit.N, hit.i, hit.u, hit.v, mp.map_n, dt)
    back = dot(nrm, pool.dir) > 0
    nrm = pick(back, -nrm, nrm)
    nee_orig = hit.P - pool.dir * 1e-3
    singular = mp.type == IDEAL_DIELECTRIC
    rng = Rng(pool.seed, dt)

    shadow_orig, shadow_dir = pool.shadow_orig, pool.shadow_dir
    shadow_len = pool.shadow_len
    l_pdf_direct, l_cos_th = pool.last_pdf_direct, pool.last_cos_th
    l_pick, l_emission = pool.last_light_pick, pool.last_emission
    pending = torch.zeros_like(terminate)
    if cfg.sample_expl:
        do_nee = alive & ~singular
        env_prob = float(env is not None) / max(
            1, int(env is not None) + int(light is not None))
        pick_env = rng() < env_prob
        if env is not None:
            L, pdf_l, rad = env.sample(rng())
            m = do_nee & pick_env
            shadow_orig = pick(m, nee_orig, shadow_orig)
            shadow_dir = pick(m, L, shadow_dir)
            shadow_len = torch.where(m, params.world_radius * 2.0,
                                     shadow_len)
            l_pdf_direct = torch.where(m, pdf_l, l_pdf_direct)
            l_cos_th = torch.where(m, dot(L, nrm).clamp_min(0.0), l_cos_th)
            l_pick = torch.where(m, env_prob, l_pick)
            l_emission = pick(m, rad * params.env_strength, l_emission)
            pending |= m
        if light is not None:
            pdf_a = 1.0 / (4.0 * light.size_x * light.size_y)
            r1, r2 = rng(), rng()
            pos = (light.pos + light.right * ((2.0 * r1 - 1.0)
                                              * light.size_x)[:, None]
                   + light.up * ((2.0 * r2 - 1.0) * light.size_y)[:, None])
            Lv = pos - nee_orig
            dist = Lv.norm(dim=-1)
            inv = 1.0 / dist.clamp_min(1e-30)
            Ln = Lv * inv[:, None]
            cos_l = dot(light.N, -Lv).clamp_min(0.0)
            ok = do_nee & ~pick_env & (cos_l > 0)
            dist_s = dist * 0.995
            shadow_orig = pick(ok, nee_orig, shadow_orig)
            shadow_dir = pick(ok, Ln, shadow_dir)
            shadow_len = torch.where(ok, dist_s, shadow_len)
            l_pdf_direct = torch.where(ok, area_to_solid_angle(
                pdf_a, dist_s, cos_l * inv), l_pdf_direct)
            l_cos_th = torch.where(ok, dot(Ln, nrm).clamp_min(0.0), l_cos_th)
            l_pick = torch.where(ok, 1.0 - env_prob, l_pick)
            l_emission = pick(ok, light.E.expand(n, 3), l_emission)
            pending |= ok

    nee_bsdf = bsdf_eval(mp, nrm, back, pool.dir, shadow_dir)
    nee_pdf = bsdf_pdf(mp, nrm, back, pool.dir, shadow_dir).clamp_min(0.0)
    d_new, pdf_w, f = bsdf_sample(mp, nrm, back, pool.dir, rng)
    bad = (pdf_w == 0) | (f == 0).all(-1)
    new_T = pick(bad, zeros3, T * f * (
        dot(nrm, d_new) / torch.where(bad, 1.0, pdf_w))[:, None])
    cont_orig = hit.P + d_new * 1e-4

    cam_o, cam_d = camera_rays(params.camera, new_pixel, cfg.width,
                               cfg.height, rng)
    ones3 = torch.ones_like(zeros3)
    pending &= ~terminate
    return SimpleNamespace(
        splat=splat, splat_rgb=splat_rgb, terminate=terminate,
        orig=pick(terminate, cam_o, cont_orig),
        dir=pick(terminate, cam_d, d_new),
        T=pick(terminate, ones3, new_T),
        Ei=pick(terminate, zeros3, Ei),
        path_len=torch.where(terminate, 0, plen),
        last_pdf_w=torch.where(terminate, 1.0, pdf_w),
        last_specular=terminate | singular,
        last_T=pick(terminate, zeros3, T),
        shadow_pending=pending,
        shadow_orig=shadow_orig, shadow_dir=shadow_dir,
        shadow_len=shadow_len,
        last_pdf_direct=torch.where(terminate, 0.0, l_pdf_direct),
        last_pdf_implicit=torch.where(terminate, 0.0, nee_pdf),
        last_cos_th=torch.where(terminate, 0.0, l_cos_th),
        last_light_pick=torch.where(terminate, 1.0, l_pick),
        last_emission=pick(terminate, zeros3, l_emission),
        last_bsdf=pick(terminate, zeros3, nee_bsdf),
        seed=rng.seed)
