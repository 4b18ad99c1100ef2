"""Wavefront (throughput) integrator — the port of the reference package's
core/integrator_wf.py with the block-bound pool, the area light and the
env map (each on or off; NEE picking either light with probability 1/2
when both are on), implicit light hits and NEE each on or off (MIS
between them when both are), Russian roulette past MIN_PATH_LENGTH when
``config.use_roulette``, textures and normal maps, and with
``config.denoiser`` the denoiser's guide features (a second K4 splat, of
8 channels, after the film's). With ``config.max_spp == 0`` the splat
runs free (K4); with ``max_spp > 0`` the exact spp cap (CHECK_SPP) is on:
each segment reads the per-pixel spp of every path's pixel (K8), ends the
paths of full pixels unsplatted, and splats through the capped kernel
(K7), which admits exactly the pixels' remaining budgets.

A fixed pool of paths is an SoA of [num_tasks] tensors. Each segment runs
two phases: ``wf_trace_phase`` (extension + shadow trace of the rays staged
last segment under one shared sort) and ``wf_shade_phase`` (winner
resolve, then ``wf_logic_phase``: implicit light hits with MIS, NEE
resolve, the film splat of terminated paths, then ``surface_shade``: the
surviving paths' textures, shading normal, NEE generation and BSDF work,
the guide features and per-group pixel-ring raygen, one launch of
csrc/surface_shade.cu on the card). Queues are masks; queue lengths are
mask popcounts (``WfCounters``).

The pixel ring (which pixel a lane renders next, and where its samples
land: the block ring of G groups over a padded film, or the reference's
flat ring) is core/pixel_ring.py's; a segment asks its ring and does not
branch on it.

Both rings render a scene without cluster tables too: its extension and
shadow rays are traced through its BVH (accel/traverse.py), and the
materials are resolved from the hits, as on tables that resolve nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import bxdf_types as bx
from .. import envmap, flags
from .. import kernel_build as kb
from ..bsdf import apply_textures, resolve_material
from ..bsdf import dispatch as bd
from ..envmap import env_radiance_and_pdf, env_sample
from ..geom import MIN_PATH_LENGTH, RenderConfig, RenderParams
from ..profiling import span
from ..rng import burtle_hash, rand
from ..sampling import pdf_area_to_solid_angle, sample_area_light
from ..texture_fetch import ONE_255
from ..vec import Vec3, dot, is_zero, length, luminance, where as vwhere
from . import pixel_ring
from .camera import generate_camera_rays
from .integrator_mk import FeatureFilm, Film
from .trace import (DeviceScene, has_resolve_tables, tangent_space_normal,
                    trace_extension, trace_extension_raw, trace_pair,
                    trace_shadow)


class WfPool(NamedTuple):
    """Path pool SoA (GPUTaskState, geom.h:222-259) as [num_tasks] tensors.
    Seeds are int64 holding uint32 values (rng.py)."""
    orig: Vec3
    dir: Vec3
    shadow_orig: Vec3
    shadow_dir: Vec3
    T: Vec3
    Ei: Vec3
    last_bsdf: Vec3
    last_emission: Vec3
    last_T: Vec3
    last_pdf_w: torch.Tensor
    path_len: torch.Tensor       # int32; -1 = freshly reset (pre-birth)
    seed: torch.Tensor
    last_specular: torch.Tensor
    shadow_blocked: torch.Tensor
    shadow_pending: torch.Tensor
    pixel_index: torch.Tensor
    last_pdf_direct: torch.Tensor
    last_pdf_implicit: torch.Tensor
    last_cos_th: torch.Tensor
    last_light_pick: torch.Tensor
    shadow_len: torch.Tensor
    first_diffuse_hit: Optional[torch.Tensor] = None   # bool, denoiser only


class WfState(NamedTuple):
    """Film, spp and features are [G*Pk] (block ring) or [num_pixels]
    (flat ring); the cursor is [G] or 0-d."""
    pool: WfPool
    film: Film
    spp: torch.Tensor          # int32 samples per (padded) pixel
    curr_pixel: torch.Tensor   # int32 ring cursor(s)
    features: Optional[FeatureFilm] = None   # guide buffers


class WfCounters(NamedTuple):
    """Queue-length analogue (geom.h:263-277); 0-dim int tensors."""
    raygen: torch.Tensor
    extension: torch.Tensor
    shadow: torch.Tensor
    splatted: torch.Tensor


def salt_seeds(seed, salt: int):
    """The seeds of a statistically independent stream: each seed mixed
    with ``salt`` by burtle_hash (FLT_SEED_SALT's mix, and the resumed
    pools' after a checkpoint)."""
    return burtle_hash(seed ^ ((salt * 0x9E3779B9) & 0xFFFFFFFF))


def wf_reset(config: RenderConfig, num_tasks: int, world_radius=1.0, *,
             device) -> WfState:
    """wf_reset.cl: clear film, reset pool, seed = lane id (salted by
    FLT_SEED_SALT when set). path_len = -1 marks paths as pre-birth: the
    first segment regenerates them without splatting. The film, spp and
    ring cursor(s) are the pixel ring's (``pixel_ring.reset``, which raises
    on a pool the block ring's groups do not divide). With
    ``config.denoiser`` the pool tracks each path's first diffuse hit and
    the state holds zero guide features."""
    npix, spp0, curr0 = pixel_ring.reset(config, num_tasks, device=device)
    n = num_tasks
    salt = flags.env_int("SEED_SALT", 0)
    seed0 = torch.arange(n, dtype=torch.int64, device=device)
    if salt:
        seed0 = salt_seeds(seed0, salt)
    f32 = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    z = f32(0.0)
    b = lambda v: torch.full((n,), v, dtype=torch.bool, device=device)
    pool = WfPool(
        orig=Vec3(z, z, z), dir=Vec3(z, z, f32(1.0)),
        shadow_orig=Vec3(z, z, z), shadow_dir=Vec3(z, z, f32(1.0)),
        T=Vec3.ones(n, device), Ei=Vec3.zeros(n, device),
        last_bsdf=Vec3.zeros(n, device), last_emission=Vec3.zeros(n, device),
        last_T=Vec3.zeros(n, device),
        last_pdf_w=f32(1.0),
        path_len=torch.full((n,), -1, dtype=torch.int32, device=device),
        seed=seed0,
        last_specular=b(True), shadow_blocked=b(True),
        shadow_pending=b(False),
        pixel_index=torch.zeros(n, dtype=torch.int32, device=device),
        last_pdf_direct=z, last_pdf_implicit=z, last_cos_th=z,
        last_light_pick=f32(1.0),
        shadow_len=f32(2.0 * float(world_radius)),
        first_diffuse_hit=b(False) if config.denoiser else None)
    return WfState(pool=pool, film=Film.zeros(npix, device), spp=spp0,
                   curr_pixel=curr0,
                   features=(FeatureFilm.zeros(npix, device)
                             if config.denoiser else None))


def wf_state_from_numpy(st: dict, *, device) -> WfState:
    """WfState from numpy arrays: ``{"pool": {field: array or (x, y, z)},
    "film": {"color": (x, y, z), "weight": array}, "spp": array,
    "curr_pixel": array}``, with ``"features": {"albedo": (x, y, z),
    "albedo_w": array, "normal": (x, y, z), "normal_w": array}`` and the
    pool's ``first_diffuse_hit`` when the denoiser is on — e.g. the
    reference package's wf_reset state, so both integrators can start
    from one state. uint32 seeds become int64."""
    def t(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(device)   # own copy

    def v(x):
        return Vec3(*(t(c) for c in x)) if isinstance(x, (tuple, list)) \
            else t(x)
    pool = WfPool(**{k: v(st["pool"][k]) for k in WfPool._fields
                     if st["pool"].get(k) is not None})
    film = Film(color=v(st["film"]["color"]), weight=t(st["film"]["weight"]))
    f = st.get("features")
    features = None if f is None else FeatureFilm(
        **{k: v(f[k]) for k in FeatureFilm._fields})
    return WfState(pool=pool, film=film, spp=t(st["spp"]).to(torch.int32),
                   curr_pixel=t(st["curr_pixel"]).to(torch.int32),
                   features=features)


def wf_state_to_numpy(state: WfState) -> dict:
    """Inverse of wf_state_from_numpy (seeds back to uint32)."""
    n = lambda a: a.detach().cpu().numpy()
    v = lambda x: tuple(n(c) for c in x) if isinstance(x, Vec3) else n(x)
    pool = {k: v(a) for k, a in state.pool._asdict().items()
            if a is not None}
    pool["seed"] = pool["seed"].astype(np.uint32)
    out = dict(pool=pool,
               film=dict(color=v(state.film.color),
                         weight=n(state.film.weight)),
               spp=n(state.spp), curr_pixel=n(state.curr_pixel))
    if state.features is not None:
        out["features"] = {k: v(a) for k, a in
                           state.features._asdict().items()}
    return out


def wf_segment(scene: DeviceScene, params: RenderParams, state: WfState,
               config: RenderConfig, pixel_base: int = 0,
               held: Optional[torch.Tensor] = None):
    """Advance the wavefront one segment: the trace phase, then the shade
    phase (integrator_wf.py:263-279). Returns (state, counters).

    The pixel ring spans ``[pixel_base, pixel_base + len(film))``: the
    whole film by default; under ``parallel.mesh.wf_segment_sharded`` each
    rank owns one slice of the film and the pool, and its own ring
    cursor(s). ``pixel_base`` counts padded pixels on the block ring (a
    multiple of the padded group size) and true pixels on the flat one.

    ``held``: the capped ring's counters, an int64 [2] tensor on the pool's
    device to which a segment under the spp cap adds, on the device, its
    lanes held idle because their pixel had reached its target and its
    finished paths that tried to splat (the admitted ones are the
    counters' ``splatted``, so the cap refused the difference)."""
    with span("flt::segment"):
        raw, occluded = wf_trace_phase(scene, state.pool, params, config)
        # off the cap the shade phase takes its seven arguments as before,
        # the form that wrappers of it (the benchmark's hooks) know
        counter = () if held is None else (held,)
        return wf_shade_phase(scene, params, state, config, raw, occluded,
                              pixel_base, *counter)


def wf_trace_phase(scene: DeviceScene, pool: WfPool, params: RenderParams,
                   config: RenderConfig):
    """Extension + shadow traces of the rays staged last segment
    (wf_extrays.cl / wf_shadowrays.cl): under one shared sort, or, with
    ``flags.SORT_RAYS`` off, one by one in lane order. Non-pending shadow
    lanes get tmax = 0. Returns (raw=(t, col), occluded); raw is None when
    the tables can resolve nothing or the scene has none (the reference's
    has_raw test, integrator_wf.py:294-296): the extension ray is then
    traced in the resolve phase, and a scene without tables traces its
    shadow rays through the BVH's any_hit."""
    with span("flt::trace"):
        light = params.area_light if config.use_area_light else None
        shadow_tmax = torch.where(pool.shadow_pending, pool.shadow_len, 0.0)
        has_raw = has_resolve_tables(scene)
        if has_raw and flags.SORT_RAYS:
            return trace_pair(pool.orig, pool.dir, pool.shadow_orig,
                              pool.shadow_dir, shadow_tmax, scene, light)
        raw = trace_extension_raw(pool.orig, pool.dir, scene) if has_raw \
            else None
        occluded = trace_shadow(pool.shadow_orig, pool.shadow_dir,
                                shadow_tmax, scene, light, True)
        return raw, occluded


def wf_resolve_phase(scene: DeviceScene, pool: WfPool, params: RenderParams,
                     config: RenderConfig, raw):
    """Winner-attribute resolve + hit construction. Returns (hit, sp)."""
    light = params.area_light if config.use_area_light else None
    return trace_extension(pool.orig, pool.dir, scene, light,
                           config.sample_impl, want_shading=True, raw=raw)


def wf_shade_phase(scene: DeviceScene, params: RenderParams, state: WfState,
                   config: RenderConfig, raw, occluded, pixel_base: int = 0,
                   held: Optional[torch.Tensor] = None):
    """Resolve + logic, the second program of a segment."""
    with span("flt::shade"):
        with span("flt::shade.resolve"):
            hit, sp = wf_resolve_phase(scene, state.pool, params, config, raw)
        with span("flt::shade.logic"):
            return wf_logic_phase(scene, params, state, config, hit, sp,
                                  occluded, pixel_base, held)


def wf_logic_phase(scene: DeviceScene, params: RenderParams, state: WfState,
                   config: RenderConfig, hit, sp, occluded,
                   pixel_base: int = 0, held: Optional[torch.Tensor] = None):
    """Logic + shading + NEE + material sampling + raygen + splat — the
    post-trace half of the segment (wf_logic.cl onward), on the pixel ring
    ``[pixel_base, pixel_base + len(film))`` and with the capped ring's
    counters ``held`` and ``tried`` (see ``wf_segment``). Returns (state,
    counters)."""
    cfg = config
    pool = state.pool
    n = pool.seed.shape[0]
    dev = pool.seed.device
    use_env = cfg.use_env_map and scene.env is not None
    light = params.area_light if cfg.use_area_light else None
    # the ring's size is the film slice this segment owns
    ring = pixel_ring.segment_ring(cfg, state.film.weight.shape[0],
                                   pixel_base)
    lpid = ring.local(pool.pixel_index)

    seed = pool.seed
    T = pool.T
    Ei = pool.Ei

    plen = pool.path_len + 1
    shadow_blocked = torch.where(pool.shadow_pending, occluded, True)

    with span("flt::shade.logic.terminate"):
        # ---- LOGIC (wf_logic.cl) --------------------------------------------
        terminate = plen <= 0   # pre-birth paths regenerate without splatting
        if cfg.max_bounces > 0:
            terminate |= plen >= (cfg.max_bounces + 1)

        # Russian roulette with the T / contProb compensation (wf_logic.cl:
        # 62-74); its draw comes before the spp cap's fetch, as the reference's
        if cfg.use_roulette:
            u_rr, seed = rand(seed)
            cp = torch.clamp(luminance(T), 0.01, 0.5)
            rr = ~terminate & (plen > MIN_PATH_LENGTH)
            terminate |= rr & (u_rr > cp)
            T = vwhere(rr, T / cp, T)

        max_samples_reached = torch.zeros(n, dtype=torch.bool, device=dev)
        spp_cap = pix_spp = None
        if cfg.max_spp > 0:
            # the cap's value comes from params (spp retargets), its presence
            # and fallback value from the config (integrator_wf.py:392-406)
            cap = torch.as_tensor(params.max_spp, dtype=torch.int32,
                                  device=dev)
            spp_cap = torch.where(cap > 0, cap, cfg.max_spp)
            pix_spp = ring.fetch_spp(lpid, state.spp)
            max_samples_reached = pix_spp >= spp_cap
            terminate |= max_samples_reached

        terminate |= is_zero(T) | (pool.last_pdf_w == 0.0)
        use_mis = (plen > 1) & ~pool.last_specular

    with span("flt::shade.logic.env"):
        # ---- implicit environment hit (wf_logic.cl:98-122): the camera ray's
        # always, later ones with implicit sampling, MIS-weighted when NEE is
        # on too
        if use_env:
            miss = (hit.i < 0) & ~terminate & (plen > 0)
            bg_raw, direct_pdf = env_radiance_and_pdf(scene.env, pool.dir,
                                                      cfg.fast_env)
            bg = bg_raw * params.env_map_strength
            if not cfg.sample_impl:
                bg = vwhere(plen == 1, bg, Vec3.zeros(n, dev))
            w = 1.0
            if cfg.sample_impl and cfg.sample_expl:
                actual = pool.last_pdf_w * pool.last_light_pick
                w_mis = actual / torch.clamp_min(actual + direct_pdf, 1e-30)
                w = torch.where(use_mis, w_mis, 1.0)
            Ei = vwhere(miss, Ei + T * bg * w, Ei)
        terminate |= hit.i < 0

    with span("flt::shade.logic.light"):
        # ---- implicit area light hit (wf_logic.cl:124-147), MIS-weighted when
        # NEE is on (the trace only reports it with implicit sampling)
        if light is not None:
            al = (hit.area_light_hit > 0) & ~terminate
            mis_w = 1.0
            if cfg.sample_expl:
                pdf_a = 1.0 / (4.0 * light.size_x * light.size_y)
                dist = length(hit.P - pool.orig)
                pdf_w = pdf_area_to_solid_angle(pdf_a, dist,
                                                -dot(pool.dir, hit.N))
                w_mis = pool.last_pdf_w / torch.clamp_min(
                    pool.last_pdf_w + pdf_w * pool.last_light_pick, 1e-30)
                mis_w = torch.where(use_mis, w_mis, 1.0)
            Ei = vwhere(al, Ei + T * light.E * mis_w, Ei)
            terminate |= al

    with span("flt::shade.logic.nee"):
        # ---- NEE shadow-ray resolution (wf_logic.cl:149-168) ----------------
        if cfg.sample_expl:
            unblocked = ~shadow_blocked
            denom = (pool.last_light_pick * pool.last_pdf_direct
                     + (1.0 if cfg.sample_impl else 0.0)
                     * pool.last_pdf_implicit)
            contrib = pool.last_bsdf * pool.last_T * pool.last_emission * (
                pool.last_cos_th / torch.clamp_min(denom, 1e-30))
            Ei = vwhere(unblocked, Ei + contrib, Ei)

    with span("flt::shade.logic.splat"):
        # ---- splat terminated paths (wf_logic.cl:171-205) -------------------
        splat = terminate & (plen > 0) & ~max_samples_reached
        if held is not None:
            # the lanes held idle and the paths that try to splat, in one
            # reduction and one add
            held += torch.stack([max_samples_reached, splat]).sum(dim=1)
        film = state.film
        rows, spp_counts, n_splatted = ring.splat(
            lpid, splat, [torch.where(splat, Ei.x, 0.0),
                          torch.where(splat, Ei.y, 0.0),
                          torch.where(splat, Ei.z, 0.0),
                          splat.to(torch.float32)],
            torch.stack([film.color.x, film.color.y, film.color.z,
                         film.weight], dim=0), state.spp, spp_cap, pix_spp)
        film = Film(color=Vec3(rows[0], rows[1], rows[2]), weight=rows[3])

    # ---- the surface, material and raygen sections: one kernel on the card
    surf = surface_shade(scene, params, state, cfg, hit, sp, seed, T, Ei,
                         terminate, plen, pixel_base=pixel_base)
    counters = WfCounters(
        raygen=surf.n_regen,
        # all n lanes are traced each segment (ray counts compare like for
        # like with the reference)
        extension=torch.tensor(n, dtype=torch.int32, device=dev),
        shadow=surf.pool.shadow_pending.sum(),
        splatted=n_splatted)
    new_state = WfState(pool=surf.pool, film=film, spp=spp_counts,
                        curr_pixel=surf.curr_pixel, features=surf.features)
    return new_state, counters


# ---------------------------------------------------------------------------
# The surface, material and raygen sections of a segment
# (csrc/surface_shade.cu on the card)
# ---------------------------------------------------------------------------

K_SURFACE = kb.Kernel("surface_shade", "surface_shade.cu",
                      "surface_shade_launch",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int])


class Surfaced(NamedTuple):
    """What ``surface_shade`` gives a segment."""
    pool: WfPool                        # the new pool
    features: Optional[FeatureFilm]     # the guide features (denoiser)
    curr_pixel: torch.Tensor            # the ring cursor(s) after raygen
    n_regen: torch.Tensor               # the lanes raygen restarted


def _guide_features(params, state: WfState, config: RenderConfig, ring,
                    terminate, plen, alive, singular, nrm: Vec3, kd: Vec3):
    """The denoiser's guide features (wf_logic.cl:214-237): the first hit's
    normal in camera space (rows right, up, -dir) and the first
    non-singular hit's albedo, splat by the ring as one 8-channel record
    after the film's; a path's first-diffuse flag ends with it. Returns
    (features, first-diffuse flags), the state's own without the
    denoiser."""
    cfg = config
    pool = state.pool
    features = state.features
    first_diffuse = pool.first_diffuse_hit
    if not cfg.denoiser:
        return features, first_diffuse
    lpid = ring.local(pool.pixel_index)
    with span("flt::shade.logic.features"):
        cam = params.camera
        nm = alive & (plen == 1)
        cs = Vec3(dot(cam.right, nrm), dot(cam.up, nrm),
                  -dot(cam.dir, nrm))
        am = alive & ~singular & ~first_diffuse
        first_diffuse = ~terminate & (first_diffuse | (alive & ~singular))
        f_old = torch.stack([*features.albedo, features.albedo_w,
                             *features.normal, features.normal_w], dim=0)
        f_new, _, _ = ring.splat(lpid, nm | am, [
            torch.where(am, kd.x, 0.0), torch.where(am, kd.y, 0.0),
            torch.where(am, kd.z, 0.0), am.to(torch.float32),
            torch.where(nm, cs.x, 0.0), torch.where(nm, cs.y, 0.0),
            torch.where(nm, cs.z, 0.0), nm.to(torch.float32)], f_old)
        features = FeatureFilm(albedo=Vec3(f_new[0], f_new[1], f_new[2]),
                               albedo_w=f_new[3],
                               normal=Vec3(f_new[4], f_new[5], f_new[6]),
                               normal_w=f_new[7])
    return features, first_diffuse


def surface_shade_plain(scene: DeviceScene, params: RenderParams,
                        state: WfState, config: RenderConfig, hit, sp, seed,
                        T: Vec3, Ei: Vec3, terminate, plen,
                        pixel_base: int = 0) -> Surfaced:
    """The plain version of the kernel: wf_logic_phase's torch code for
    the surviving paths' surface (textures, implicit triangle emission,
    the shading normal, NEE sampling), their material (``bsdf_shade``),
    the guide features and the terminated paths' raygen, then the merge
    into the new pool. ``seed``, ``T`` and ``Ei`` are the lanes' after the
    sections before; ``sp`` None resolves the materials from the hits."""
    K_SURFACE.plain_runs += 1
    cfg = config
    pool = state.pool
    n = pool.seed.shape[0]
    dev = pool.seed.device
    use_env = cfg.use_env_map and scene.env is not None
    light = params.area_light if cfg.use_area_light else None

    with span("flt::shade.logic.surface"):
        # ---- shading of surviving paths: NEE generation + material ----------
        alive = ~terminate
        if sp is None:  # tables that resolve nothing (trace.py's third branch)
            sp = resolve_material(scene.mats, hit.mat_id, hit.uv_u,
                                  hit.uv_v, scene.atlas)
        else:
            sp = apply_textures(sp, hit.uv_u, hit.uv_v, scene.atlas)

        # implicit triangle emission (weight-1; emissive surfaces are never
        # NEE-sampled as lights)
        em = alive & (hit.i >= 0) & (sp.type == bx.BXDF_EMISSIVE)
        Ei = vwhere(em, Ei + T * sp.Ke, Ei)

        nrm = tangent_space_normal(hit, scene.tri_frames, sp.map_N,
                                   scene.atlas, meta=sp.n_meta)
        backface = dot(nrm, pool.dir) > 0.0
        nrm = vwhere(backface, -nrm, nrm)
        nee_orig = hit.P - pool.dir * 1e-3

        singular = (sp.type & bx.BXDF_SINGULAR_MASK) != 0

        shadow_orig, shadow_dir = pool.shadow_orig, pool.shadow_dir
        shadow_len = pool.shadow_len
        l_pdf_direct, l_cos_th = pool.last_pdf_direct, pool.last_cos_th
        l_pick, l_emission = pool.last_light_pick, pool.last_emission

        # ---- NEE (with explicit sampling): pick the env map or the area light
        # (wf_logic.cl:249-251), in the reference's order of draws: the pick,
        # the env sample when there is an env map, the area-light sample when
        # there is a light
        shadow_pending = torch.zeros(n, dtype=torch.bool, device=dev)
        if cfg.sample_expl:
            do_nee = alive & ~singular
            env_prob = (float(cfg.use_env_map)
                        / max(1, int(cfg.use_env_map)
                              + int(cfg.use_area_light)))
            u_pick, seed = rand(seed)
            pick_env = u_pick < env_prob

            if use_env:
                u_env, seed = rand(seed)
                L, direct_pdf, env_raw = env_sample(scene.env, u_env,
                                                    cfg.fast_env)
                m = do_nee & pick_env
                shadow_orig = vwhere(m, nee_orig, shadow_orig)
                shadow_dir = vwhere(m, L, shadow_dir)
                shadow_len = torch.where(m, params.world_radius * 2.0,
                                         shadow_len)
                l_pdf_direct = torch.where(m, direct_pdf, l_pdf_direct)
                l_cos_th = torch.where(m, torch.clamp_min(dot(L, nrm), 0.0),
                                       l_cos_th)
                l_pick = torch.where(m, env_prob, l_pick)
                l_emission = vwhere(m, env_raw * params.env_map_strength,
                                    l_emission)
                shadow_pending |= m

            if light is not None:
                pdf_a, pos_l, seed = sample_area_light(light, seed)
                Lv = pos_l - nee_orig
                len0 = length(Lv)
                inv_len = 1.0 / torch.clamp_min(len0, 1e-30)
                Ln = Lv * inv_len
                cos_light = torch.clamp_min(dot(light.N, -Lv), 0.0)
                ok = do_nee & ~pick_env & (cos_light > 0.0)
                len_l = len0 * 0.995                    # wf_logic.cl:308
                direct_pdf = pdf_area_to_solid_angle(pdf_a, len_l,
                                                     cos_light * inv_len)
                cos_th = torch.clamp_min(dot(Ln, nrm), 0.0)
                shadow_orig = vwhere(ok, nee_orig, shadow_orig)
                shadow_dir = vwhere(ok, Ln, shadow_dir)
                shadow_len = torch.where(ok, len_l, shadow_len)
                l_pdf_direct = torch.where(ok, direct_pdf, l_pdf_direct)
                l_cos_th = torch.where(ok, cos_th, l_cos_th)
                l_pick = torch.where(ok, 1.0 - env_prob, l_pick)
                l_emission = vwhere(ok, Vec3(light.E.x.expand(n),
                                             light.E.y.expand(n),
                                             light.E.z.expand(n)), l_emission)
                shadow_pending |= ok

    with span("flt::shade.logic.material"):
        # ---- material phase (wf_mat_*.cl): the NEE ray's BSDF and pdf, the
        # continuation ray's lobe sample, the path's new throughput and the
        # continuation's origin (one kernel on the card)
        nee_bsdf, nee_pdf, d_new, pdf_w, seed, new_T, cont_orig = \
            bd.bsdf_shade(nrm, sp, backface, pool.dir, shadow_dir, seed, T,
                          hit.P, cfg.material_types)

    ring = pixel_ring.segment_ring(cfg, state.film.weight.shape[0],
                                   pixel_base)
    features, first_diffuse = _guide_features(
        params, state, cfg, ring, terminate, plen, alive, singular, nrm,
        sp.Kd)

    with span("flt::shade.logic.raygen"):
        # ---- RAYGEN for terminated paths (wf_raygen.cl), on the ring
        new_pixel, curr_out, n_regen = ring.raygen(terminate,
                                                   state.curr_pixel)
        pixel_index = torch.where(terminate, new_pixel, pool.pixel_index)
        # camera rays address TRUE pixels
        cam_pid = pixel_ring.padded_to_true_pid(cfg, pixel_index)
        cam_orig, cam_dir, seed = generate_camera_rays(
            cam_pid, params.camera, cfg.width, cfg.height,
            params.world_radius, seed)

        # merge: terminated -> fresh camera path; alive -> continuation
        ones3 = Vec3.ones(n, dev)
        zeros3 = Vec3.zeros(n, dev)
        orig = vwhere(terminate, cam_orig, cont_orig)
        direc = vwhere(terminate, cam_dir, d_new)
        T_out = vwhere(terminate, ones3, new_T)
        Ei_out = vwhere(terminate, zeros3, Ei)
        plen_out = torch.where(terminate, 0, plen).to(torch.int32)
        last_pdf_w = torch.where(terminate, 1.0, pdf_w)
        last_specular = torch.where(terminate, True, singular)
        last_T = vwhere(terminate, zeros3, T)
        shadow_pending &= ~terminate
        l_pdf_direct = torch.where(terminate, 0.0, l_pdf_direct)
        l_pdf_implicit = torch.where(terminate, 0.0, nee_pdf)
        l_cos_th = torch.where(terminate, 0.0, l_cos_th)
        l_pick = torch.where(terminate, 1.0, l_pick)
        l_emission = vwhere(terminate, zeros3, l_emission)
        nee_bsdf = vwhere(terminate, zeros3, nee_bsdf)

    new_pool = WfPool(
        orig=orig, dir=direc,
        shadow_orig=shadow_orig, shadow_dir=shadow_dir,
        T=T_out, Ei=Ei_out,
        last_bsdf=nee_bsdf, last_emission=l_emission, last_T=last_T,
        last_pdf_w=last_pdf_w, path_len=plen_out, seed=seed,
        last_specular=last_specular,
        shadow_blocked=torch.ones(n, dtype=torch.bool, device=dev),
        shadow_pending=shadow_pending,
        pixel_index=pixel_index,
        last_pdf_direct=l_pdf_direct, last_pdf_implicit=l_pdf_implicit,
        last_cos_th=l_cos_th, last_light_pick=l_pick,
        shadow_len=shadow_len, first_diffuse_hit=first_diffuse)

    return Surfaced(new_pool, features, curr_out, n_regen)


# the kernel's float output rows (csrc/surface_shade.cu: FOut): the new
# pool's 33, then the denoiser's shading normal and Kd
_NRM_ROW, _KD_ROW, _F_ROWS = 33, 36, 39
# csrc/surface_shade.cu: I_FLAGS
_EXPL, _ENV, _ENV_FAST, _LIGHT = 1, 2, 4, 8
_TEX_KD, _TEX_KS, _TEX_N, _DENOISE, _BLOCK = 16, 32, 64, 128, 256


def _surface_args(scene, params, state, cfg, hit, sp, seed, T, Ei,
                  terminate, plen, kring, textured):
    """The kernel's inputs in its order, (tensor or None, dtype, kind) with
    kind "lane" ([n]), "table" (any shape) or "param" (one value), and its
    flags; ``kring`` the ring's arguments (``pixel_ring.KernelRing``)."""
    f32, i32 = torch.float32, torch.int32
    pool = state.pool
    atlas = scene.atlas
    tex = atlas is not None and atlas.count > 0
    kd = tex and atlas.has_kd and not textured
    ks = tex and atlas.has_ks and not textured
    nmap = tex and atlas.has_n
    env = scene.env if cfg.use_env_map else None
    expl = cfg.sample_expl
    fast = env is not None and cfg.fast_env and env.prob_alias is not None
    light = params.area_light if cfg.use_area_light else None
    flags = ((_EXPL if expl else 0) | (_ENV if expl and env is not None else 0)
             | (_ENV_FAST if fast else 0)
             | (_LIGHT if expl and light is not None else 0)
             | (_TEX_KD if kd else 0) | (_TEX_KS if ks else 0)
             | (_TEX_N if nmap else 0)
             | (_DENOISE if cfg.denoiser else 0)
             | (_BLOCK if kring.block else 0))

    def lanes(dtype, *ts):
        return [(t, dtype, "lane") for t in ts]

    def meta(m, used):
        return lanes(i32, *(m if used and m is not None else (None,) * 3))

    def tab(t, dtype, used=True):
        return [(t if used else None, dtype, "table")]

    def pars(*ts, used=True):
        # a Python number becomes a 0-d tensor, as torch would take it
        val = lambda t: t if isinstance(t, torch.Tensor) else torch.tensor(
            float(t), dtype=f32, device=seed.device)
        return [(val(t) if used else None, f32, "param") for t in ts]

    args = (
        lanes(f32, *hit.P, *hit.N, hit.uv_u, hit.uv_v, *sp.Kd, *sp.Ks,
              *sp.Ke, sp.alpha, sp.Ni, *pool.dir, *T, *Ei,
              *pool.shadow_orig, *pool.shadow_dir, pool.shadow_len,
              pool.last_pdf_direct, pool.last_cos_th, pool.last_light_pick,
              *pool.last_emission)
        + lanes(i32, hit.i, sp.type, sp.map_Kd, sp.map_Ks, sp.map_N, plen,
                pool.pixel_index)
        + meta(sp.kd_meta, kd) + meta(sp.ks_meta, ks)
        + meta(sp.n_meta, nmap) + lanes(i32, kring.rank)
        + lanes(torch.bool, terminate) + lanes(torch.int64, seed)
        + tab(state.curr_pixel, i32)
        + tab(atlas.texels if tex else None, i32)
        + sum((tab(getattr(atlas, k) if tex else None, i32)
               for k in ("offset", "width", "height")), [])
        + tab(scene.tri_frames, f32, nmap)
        + tab(env.packed if fast else None, i32)
        + tab(env.prob_alias if fast else None, i32)
        + tab(None if env is None or fast else env.prob_table, f32)
        + tab(None if env is None or fast else env.alias_table, i32)
        + tab(None if env is None or fast else env.pdf_table, f32)
        + sum((tab(None if env is None or fast else c, f32)
               for c in (env.image if env is not None else (None,) * 3)),
              [])
        + tab(env.inv_mean_lum if fast else None, f32))
    cam = params.camera
    lt = params.area_light
    has_light = light is not None
    args += (pars(*cam.pos, *cam.dir, *cam.up, *cam.right, cam.fov_scale,
                  cam.aperture_size, cam.focal_dist)
             + pars(*lt.pos, *lt.right, *lt.up, *lt.N, *lt.E, lt.size_x,
                    lt.size_y, used=has_light)
             + pars(params.world_radius)
             + pars(params.env_map_strength, used=env is not None))
    return args, flags


def _check_args(args, n, dev, cuda):
    """Each input of one device, its dtype, [n] for the lanes' and one
    value for the parameters; contiguous CUDA tensors for the kernel."""
    for k, (t, dtype, kind) in enumerate(args):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"surface_shade: argument {k} is a "
                             f"{type(t).__name__}, not a tensor")
        if t.dtype != dtype:
            raise ValueError(f"surface_shade: argument {k} has dtype "
                             f"{t.dtype}, expected {dtype}")
        if kind == "lane" and t.shape != (n,):
            raise ValueError(f"surface_shade: argument {k} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
        if kind == "param" and t.numel() != 1:
            raise ValueError(f"surface_shade: argument {k} has "
                             f"{t.numel()} values, expected 1")
        if t.device != dev:
            raise ValueError(f"surface_shade: argument {k} is on "
                             f"{t.device}, the seeds on {dev}")
    if not cuda:
        return
    for k, (t, _, _) in enumerate(args):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"surface_shade: argument {k} is not "
                             f"contiguous")
    kb.check_cuda("surface_shade", *(t for t, _, _ in args if t is not None))


def _surface_kernel(launch, scene, params, state, config, hit, sp, seed, T,
                    Ei, terminate, plen, pixel_base=0, cuda=True):
    """The kernel's route of ``surface_shade``: its inputs checked (with
    ``cuda`` as CUDA tensors, contiguous), its outputs allocated, one
    ``launch(ptrs, ints, floats, groups)``, the new pool viewed from them,
    then the guide features."""
    cfg = config
    pool = state.pool
    n = seed.shape[0]
    dev = seed.device
    with span("flt::shade.logic.surface_raygen"):
        textured = sp is None
        if textured:    # tables that resolve nothing
            sp = resolve_material(scene.mats, hit.mat_id, hit.uv_u,
                                  hit.uv_v, scene.atlas)
        num_pixels = state.film.weight.shape[0]
        ring = pixel_ring.segment_ring(cfg, num_pixels, pixel_base)
        kr = ring.kernel_args(terminate)
        args, flags = _surface_args(scene, params, state, cfg, hit, sp, seed,
                                    T, Ei, terminate, plen, kr, textured)
        _check_args(args, n, dev, cuda)
        fo = torch.empty((_F_ROWS if cfg.denoiser else _NRM_ROW, n),
                         dtype=torch.float32, device=dev)
        io = torch.empty((2, n), dtype=torch.int32, device=dev)
        bo = torch.empty((4 if cfg.denoiser else 2, n), dtype=torch.bool,
                         device=dev)
        seed_out = torch.empty_like(seed)
        rows = lambda o, k: [o[j] if j < o.shape[0] else None
                             for j in range(k)]
        outs = rows(fo, _F_ROWS) + rows(io, 2) + rows(bo, 4) + [seed_out,
                                                                kr.out]
        ptr = lambda t: 0 if t is None else t.data_ptr()
        ptrs = (ctypes.c_void_p * (len(args) + len(outs)))(
            *(ptr(a[0]) for a in args), *(ptr(t) for t in outs))
        env = scene.env
        env_prob = (float(cfg.use_env_map)
                    / max(1, int(cfg.use_env_map) + int(cfg.use_area_light)))
        ints = (ctypes.c_int * 15)(
            n, kr.s, flags, int(cfg.material_types), cfg.width, cfg.height,
            kr.pk, kr.p_true, cfg.num_pixels, pixel_base, num_pixels,
            env.width if env is not None else 0,
            env.height if env is not None else 0,
            scene.tri_frames.shape[1] if flags & _TEX_N else 0, kr.g0)
        floats = (ctypes.c_float * 12)(
            1.0 / cfg.width, 1.0 / cfg.height, cfg.width * (1.0 / cfg.height),
            env_prob, 1.0 - env_prob, envmap._U_SCALE, envmap._V_SCALE,
            envmap._PI, envmap._TWO_PI, envmap._INV_2PI_PI, ONE_255,
            1.0 / 16383.0)
        launch(ctypes.addressof(ptrs), ctypes.addressof(ints),
               ctypes.addressof(floats), kr.groups)
        curr_out, n_regen = ring.kernel_cursors(kr, state.curr_pixel)
    v = lambda k: Vec3(fo[k], fo[k + 1], fo[k + 2])
    if cfg.denoiser:
        features, first_diffuse = _guide_features(
            params, state, cfg, ring, terminate, plen, bo[2], bo[3],
            v(_NRM_ROW), v(_KD_ROW))
    else:
        features, first_diffuse = state.features, pool.first_diffuse_hit
    new_pool = WfPool(
        orig=v(0), dir=v(3), shadow_orig=v(6), shadow_dir=v(9), T=v(12),
        Ei=v(15), last_bsdf=v(18), last_emission=v(21), last_T=v(24),
        last_pdf_w=fo[27], path_len=io[0], seed=seed_out,
        last_specular=bo[0],
        shadow_blocked=torch.ones(n, dtype=torch.bool, device=dev),
        shadow_pending=bo[1], pixel_index=io[1], last_pdf_direct=fo[28],
        last_pdf_implicit=fo[29], last_cos_th=fo[30],
        last_light_pick=fo[31], shadow_len=fo[32],
        first_diffuse_hit=first_diffuse)
    return Surfaced(new_pool, features, curr_out, n_regen)


def surface_shade(scene: DeviceScene, params: RenderParams, state: WfState,
                  config: RenderConfig, hit, sp, seed, T: Vec3, Ei: Vec3,
                  terminate, plen, pixel_base: int = 0) -> Surfaced:
    """The surface, material and raygen sections of a segment (see
    ``surface_shade_plain``) on the pixel ring ``[pixel_base, pixel_base +
    len(film))``: ``hit`` and ``sp`` the resolve's, ``seed``, ``T`` and
    ``Ei`` the lanes' after the sections before, ``terminate`` the lanes
    that end, ``plen`` their path lengths. The plain version on CPU
    tensors; on CUDA tensors one launch of csrc/surface_shade.cu (inputs
    of another dtype, shape or device, or not contiguous, raise), then the
    guide features in torch."""
    if seed.device.type == "cpu":
        return surface_shade_plain(scene, params, state, config, hit, sp,
                                   seed, T, Ei, terminate, plen, pixel_base)
    return _surface_kernel(K_SURFACE, scene, params, state, config, hit, sp,
                           seed, T, Ei, terminate, plen, pixel_base)
