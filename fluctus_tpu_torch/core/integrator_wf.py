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
resolve, the film splat of terminated paths, NEE generation, BSDF
sampling and per-group pixel-ring raygen). Queues are masks; queue
lengths are mask popcounts (``WfCounters``).

With ``config.block_ring`` (the renderer's default) the pool is
partitioned into G groups of S lanes; group g renders the true pixels
[g*P, g*P + len_g) through its own ring cursor, and its splats land in
film block g (core/block_splat.py). Film and spp live in the padded
[G*Pk] layout (``pad_pixels`` / ``unpad_pixels``), and so do the guide
features.

Without it the pixel ring is flat, the reference's own (wf_raygen.cl:25):
film, spp and features in true pixel order, one global raygen cursor
(a 0-d tensor) whose ranks are an exclusive prefix count over the whole
pool (``exclusive_rank``), and terminated paths splat by a scatter-add
into ``num_pixels + 1`` buckets, the last one the overflow bucket of
lanes that do not splat (``scatter_pixels``). Under the spp cap each
segment reads the spp by a gather and admits exactly each pixel's
remaining budget, ranking a pixel's splatting lanes by a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import bxdf_types as bx
from .. import flags
from ..bsdf import apply_textures, bxdf_eval, bxdf_pdf, bxdf_sample
from ..envmap import env_radiance_and_pdf, env_sample
from ..geom import MIN_PATH_LENGTH, RenderConfig, RenderParams
from ..rng import burtle_hash, rand
from ..sampling import pdf_area_to_solid_angle, sample_area_light
from ..vec import Vec3, dot, is_zero, length, luminance, where as vwhere
from . import block_splat as bs
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


def _block_geom(config: RenderConfig):
    """(P true pixels per group, Pk padded). Group g owns true pixels
    [g*P, g*P + len_g)."""
    p_true = -(-config.num_pixels // config.groups)
    pk = -(-p_true // 128) * 128
    return p_true, pk


def padded_to_true_pid(config: RenderConfig, idx):
    """Padded pixel index (group g, slot k -> g*Pk + k) to the true pixel
    id (g*P + k). The identity on the flat ring."""
    if not config.block_ring:
        return idx
    p_true, pk = _block_geom(config)
    return torch.div(idx, pk, rounding_mode="floor") * p_true \
        + torch.remainder(idx, pk)


def unpad_pixels(arr, config: RenderConfig):
    """Padded per-pixel array [G*Pk(, C)] -> true layout [num_pixels(, C)].
    The identity on the flat ring."""
    if not config.block_ring:
        return arr
    p_true, pk = _block_geom(config)
    g = arr.shape[0] // pk
    tail = tuple(arr.shape[1:])
    return arr.reshape((g, pk) + tail)[:, :p_true].reshape(
        (g * p_true,) + tail)[:config.num_pixels]


def pad_pixels(arr, config: RenderConfig, fill=0):
    """True per-pixel array [num_pixels(, C)] -> padded block layout
    [G*Pk(, C)] (inverse of unpad_pixels); ``fill`` lands in dead slots.
    The identity on the flat ring."""
    if not config.block_ring:
        return arr
    p_true, pk = _block_geom(config)
    g = config.groups
    total = g * p_true
    tail = tuple(arr.shape[1:])
    if total > arr.shape[0]:
        arr = torch.cat([arr, torch.full((total - arr.shape[0],) + tail,
                                         fill, dtype=arr.dtype,
                                         device=arr.device)])
    m = arr.reshape((g, p_true) + tail)
    pad = torch.full((g, pk - p_true) + tail, fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([m, pad], dim=1).reshape((g * pk,) + tail)


def salt_seeds(seed, salt: int):
    """The seeds of a statistically independent stream: each seed mixed
    with ``salt`` by burtle_hash (FLT_SEED_SALT's mix, and the resumed
    pools' after a checkpoint)."""
    return burtle_hash(seed ^ ((salt * 0x9E3779B9) & 0xFFFFFFFF))


def exclusive_rank(mask):
    """Exclusive prefix count of a bool [n] mask in int32, and its total:
    the flat ring's raygen ranks (the reference's ``exclusive_rank``
    computes the same counts by triangular matmuls, a TPU workaround)."""
    m = mask.to(torch.int32)
    incl = torch.cumsum(m, 0, dtype=torch.int32)
    return incl - m, incl[-1]


def run_ranks(key):
    """Each lane's rank among the lanes of equal ``key`` [n], in lane
    order (int64): a stable sort by key, each run's start by cummax, and
    the ranks scattered back to lane order (the reference sorts them back,
    its second ``lax.sort``, integrator_wf.py:462-470)."""
    n = key.shape[0]
    skey, slane = torch.sort(key, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=key.device)
    newrun = torch.ones(n, dtype=torch.bool, device=key.device)
    newrun[1:] = skey[1:] != skey[:-1]
    runstart = torch.cummax(torch.where(newrun, pos, 0), 0).values
    return torch.empty_like(pos).scatter_(0, slane, pos - runstart)


def scatter_pixels(seg, data, num_pixels: int):
    """The flat ring's film scatter: the rows of ``data`` [m, C] summed by
    pixel ``seg`` [m] into ``num_pixels + 1`` buckets, the last one the
    overflow bucket of lanes that do not splat; returns [num_pixels, C].
    This is the reference's own semantics for the flat ring (its
    ``segment_sum``), so it stays one ``index_add_``, not a kernel: on the
    CPU it adds in lane order, as XLA's CPU scatter does; on CUDA it adds
    by atomics in no fixed order, so float sums are not bit-reproducible
    there (whole-number weights and int32 counts are)."""
    acc = torch.zeros((num_pixels + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return acc.index_add_(0, seg, data)[:num_pixels]


def wf_reset(config: RenderConfig, num_tasks: int, world_radius=1.0, *,
             device) -> WfState:
    """wf_reset.cl: clear film, reset pool, seed = lane id (salted by
    FLT_SEED_SALT when set). path_len = -1 marks paths as pre-birth: the
    first segment regenerates them without splatting. On the block ring
    (whose geometry ``config.block_plan`` checks, raising on a pool the
    groups do not divide) padded dead pixels' spp is parked at 2^29 and
    each group has a cursor; on the flat ring spp is zero over the true
    pixels and the cursor is one 0-d tensor. With ``config.denoiser`` the
    pool tracks each path's first diffuse hit and the state holds zero
    guide features."""
    if config.block_ring:
        config.block_plan(num_tasks)
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
    if config.block_ring:
        p_true, pk = _block_geom(config)
        npix = config.groups * pk
        gi = torch.arange(npix, dtype=torch.int32, device=device) // pk
        li = torch.arange(npix, dtype=torch.int32, device=device) % pk
        live = li < torch.clamp(config.num_pixels - gi * p_true, 1, p_true)
        spp0 = torch.where(live, 0, 1 << 29).to(torch.int32)
        curr0 = torch.zeros(config.groups, dtype=torch.int32, device=device)
    else:
        npix = config.num_pixels
        spp0 = torch.zeros(npix, dtype=torch.int32, device=device)
        curr0 = torch.zeros((), dtype=torch.int32, device=device)
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
               config: RenderConfig):
    """Advance the wavefront one segment: the trace phase, then the shade
    phase (integrator_wf.py:263-279). Returns (state, counters)."""
    raw, occluded = wf_trace_phase(scene, state.pool, params, config)
    return wf_shade_phase(scene, params, state, config, raw, occluded)


def wf_trace_phase(scene: DeviceScene, pool: WfPool, params: RenderParams,
                   config: RenderConfig):
    """Extension + shadow traces of the rays staged last segment
    (wf_extrays.cl / wf_shadowrays.cl): under one shared sort, or, with
    ``flags.SORT_RAYS`` off, one by one in lane order. Non-pending shadow
    lanes get tmax = 0. Returns (raw=(t, col), occluded); raw is None when
    the tables can resolve nothing (the reference's has_raw test,
    integrator_wf.py:294-296)."""
    light = params.area_light if config.use_area_light else None
    shadow_tmax = torch.where(pool.shadow_pending, pool.shadow_len, 0.0)
    has_raw = has_resolve_tables(scene)
    if has_raw and flags.SORT_RAYS:
        return trace_pair(pool.orig, pool.dir, pool.shadow_orig,
                          pool.shadow_dir, shadow_tmax, scene, light)
    raw = trace_extension_raw(pool.orig, pool.dir, scene) if has_raw \
        else None
    occluded = trace_shadow(pool.shadow_orig, pool.shadow_dir, shadow_tmax,
                            scene, light, True)
    return raw, occluded


def wf_resolve_phase(scene: DeviceScene, pool: WfPool, params: RenderParams,
                     config: RenderConfig, raw):
    """Winner-attribute resolve + hit construction. Returns (hit, sp)."""
    light = params.area_light if config.use_area_light else None
    return trace_extension(pool.orig, pool.dir, scene, light,
                           config.sample_impl, want_shading=True, raw=raw)


def wf_shade_phase(scene: DeviceScene, params: RenderParams, state: WfState,
                   config: RenderConfig, raw, occluded):
    """Resolve + logic, the second program of a segment."""
    hit, sp = wf_resolve_phase(scene, state.pool, params, config, raw)
    return wf_logic_phase(scene, params, state, config, hit, sp, occluded)


def wf_logic_phase(scene: DeviceScene, params: RenderParams, state: WfState,
                   config: RenderConfig, hit, sp, occluded):
    """Logic + shading + NEE + material sampling + raygen + splat — the
    post-trace half of the segment (wf_logic.cl onward). Returns
    (state, counters)."""
    cfg = config
    pool = state.pool
    n = pool.seed.shape[0]
    dev = pool.seed.device
    use_env = cfg.use_env_map and scene.env is not None
    light = params.area_light if cfg.use_area_light else None
    num_pixels = state.film.weight.shape[0]
    block = cfg.block_ring
    if block:
        p_true, pk_ = _block_geom(cfg)
        g_local = num_pixels // pk_
        s_ = n // g_local
        lpid = pool.pixel_index
        lane_g = torch.arange(n, dtype=torch.int32, device=dev) // s_

    seed = pool.seed
    T = pool.T
    Ei = pool.Ei

    plen = pool.path_len + 1
    shadow_blocked = torch.where(pool.shadow_pending, occluded, True)

    # ---- LOGIC (wf_logic.cl) ---------------------------------------------
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
    if cfg.max_spp > 0:
        # the cap's value comes from params (spp retargets), its presence
        # and fallback value from the config (integrator_wf.py:392-406)
        cap = torch.as_tensor(params.max_spp, dtype=torch.int32, device=dev)
        spp_cap = torch.where(cap > 0, cap, cfg.max_spp)
        if block:
            pix_spp = bs.fetch(torch.remainder(lpid, pk_).to(torch.int32),
                               state.spp.to(torch.float32)[None, :],
                               groups=g_local).to(torch.int32)
        else:
            pix_spp = state.spp[pool.pixel_index.long()]
        max_samples_reached = pix_spp >= spp_cap
        terminate |= max_samples_reached

    terminate |= is_zero(T) | (pool.last_pdf_w == 0.0)
    use_mis = (plen > 1) & ~pool.last_specular

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

    # ---- NEE shadow-ray resolution (wf_logic.cl:149-168) ------------------
    if cfg.sample_expl:
        unblocked = ~shadow_blocked
        denom = (pool.last_light_pick * pool.last_pdf_direct
                 + (1.0 if cfg.sample_impl else 0.0)
                 * pool.last_pdf_implicit)
        contrib = pool.last_bsdf * pool.last_T * pool.last_emission * (
            pool.last_cos_th / torch.clamp_min(denom, 1e-30))
        Ei = vwhere(unblocked, Ei + contrib, Ei)

    # ---- splat terminated paths (wf_logic.cl:171-205) ---------------------
    splat = terminate & (plen > 0) & ~max_samples_reached
    film = state.film
    splat_records = None
    if block:
        data_t = torch.stack([torch.where(splat, Ei.x, 0.0),
                              torch.where(splat, Ei.y, 0.0),
                              torch.where(splat, Ei.z, 0.0),
                              splat.to(torch.float32)], dim=0)
        local_col = torch.where(splat, torch.remainder(lpid, pk_), -1).to(
            torch.int32)
        fmat = torch.stack([film.color.x, film.color.y, film.color.z,
                            film.weight], dim=0)
        if cfg.max_spp > 0:
            # each pixel admits exactly its remaining budget (K7); the
            # weight deltas are whole numbers below 2^24, so rounding them
            # is exact
            remaining = torch.clamp_min(spp_cap - state.spp, 0).to(
                torch.float32)[None, :]
            new_mat = bs.splat(local_col, data_t, fmat, groups=g_local,
                               remaining=remaining)
            delta_w = new_mat[3] - film.weight
            spp_counts = state.spp + torch.round(delta_w).to(torch.int32)
            n_splatted = torch.round(delta_w.sum()).to(torch.int32)
        else:
            new_mat = bs.splat(local_col, data_t, fmat, groups=g_local)
            spp_counts = state.spp
            n_splatted = splat.sum()
        film = Film(color=Vec3(new_mat[0], new_mat[1], new_mat[2]),
                    weight=new_mat[3])
    else:
        if cfg.max_spp > 0:
            # exact admission (integrator_wf.py:453-471): rank each
            # pixel's splatting lanes in lane order and admit the pixel's
            # remaining budget
            rank = run_ranks(torch.where(splat, pool.pixel_index,
                                         0x7FFFFFFF))
            splat &= rank < (spp_cap - pix_spp)
        data = torch.stack([torch.where(splat, Ei.x, 0.0),
                            torch.where(splat, Ei.y, 0.0),
                            torch.where(splat, Ei.z, 0.0),
                            splat.to(torch.float32)], dim=1)
        seg = torch.where(splat, pool.pixel_index, num_pixels).to(
            torch.int32)
        n_splatted = splat.sum()
        spp_counts = state.spp
        acc = scatter_pixels(seg, data, num_pixels)
        film = Film(color=Vec3(film.color.x + acc[:, 0],
                               film.color.y + acc[:, 1],
                               film.color.z + acc[:, 2]),
                    weight=film.weight + acc[:, 3])
        if cfg.max_spp > 0:
            spp_counts = torch.minimum(
                spp_counts + scatter_pixels(seg, splat.to(torch.int32),
                                            num_pixels),
                spp_cap)

    # ---- shading of surviving paths: NEE generation + material ------------
    alive = ~terminate
    sp = apply_textures(sp, hit.uv_u, hit.uv_v, scene.atlas)

    # implicit triangle emission (weight-1; emissive surfaces are never
    # NEE-sampled as lights)
    em = alive & (hit.i >= 0) & (sp.type == bx.BXDF_EMISSIVE)
    Ei = vwhere(em, Ei + T * sp.Ke, Ei)

    nrm = tangent_space_normal(hit, scene.tri_frames, sp.map_N, scene.atlas,
                               meta=sp.n_meta)
    backface = dot(nrm, pool.dir) > 0.0
    nrm = vwhere(backface, -nrm, nrm)
    nee_orig = hit.P - pool.dir * 1e-3

    singular = (sp.type & bx.BXDF_SINGULAR_MASK) != 0

    # ---- denoiser guide features (wf_logic.cl:214-237): the first hit's
    # normal in camera space (rows right, up, -dir) and the first
    # non-singular hit's albedo, splat as one 8-channel record after the
    # film's (K4, or the flat ring's scatter); a path's first-diffuse flag
    # ends with it
    features = state.features
    first_diffuse = pool.first_diffuse_hit
    if cfg.denoiser:
        cam = params.camera
        nm = alive & (plen == 1)
        cs = Vec3(dot(cam.right, nrm), dot(cam.up, nrm), -dot(cam.dir, nrm))
        am = alive & ~singular & ~first_diffuse
        first_diffuse = ~terminate & (first_diffuse | (alive & ~singular))
        # [8, n] for K4, [n, 8] rows for the flat scatter
        fdata = torch.stack([
            torch.where(am, sp.Kd.x, 0.0), torch.where(am, sp.Kd.y, 0.0),
            torch.where(am, sp.Kd.z, 0.0), am.to(torch.float32),
            torch.where(nm, cs.x, 0.0), torch.where(nm, cs.y, 0.0),
            torch.where(nm, cs.z, 0.0), nm.to(torch.float32)],
            dim=0 if block else 1)
        f_old = torch.stack([*features.albedo, features.albedo_w,
                             *features.normal, features.normal_w], dim=0)
        if block:
            f_local = torch.where(nm | am, torch.remainder(lpid, pk_),
                                  -1).to(torch.int32)
            f_new = bs.splat(f_local, fdata, f_old, groups=g_local)
        else:
            fseg = torch.where(nm | am, pool.pixel_index, num_pixels).to(
                torch.int32)
            f_new = f_old + scatter_pixels(fseg, fdata, num_pixels).T
        features = FeatureFilm(albedo=Vec3(f_new[0], f_new[1], f_new[2]),
                               albedo_w=f_new[3],
                               normal=Vec3(f_new[4], f_new[5], f_new[6]),
                               normal_w=f_new[7])

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

    # ---- material phase (wf_mat_*.cl) -------------------------------------
    nee_bsdf = bxdf_eval(nrm, sp, backface, pool.dir, shadow_dir,
                         cfg.material_types)
    nee_pdf = torch.clamp_min(bxdf_pdf(nrm, sp, backface, pool.dir,
                                       shadow_dir, cfg.material_types), 0.0)
    d_new, pdf_w, f, seed = bxdf_sample(nrm, sp, backface, pool.dir, seed,
                                        cfg.material_types)
    bad = (pdf_w == 0.0) | is_zero(f)
    new_T = vwhere(bad, Vec3.zeros(n, dev),
                   T * f * (dot(nrm, d_new) / torch.where(bad, 1.0, pdf_w)))
    cont_orig = hit.P + d_new * 1e-4

    # ---- RAYGEN for terminated paths (wf_raygen.cl): one ring per group,
    # or the flat ring's one cursor over every pixel
    if block:
        term_i = terminate.to(torch.int32).view(g_local, s_)
        rank2 = (torch.cumsum(term_i, dim=1) - term_i).to(torch.int32)
        n_term_g = term_i.sum(dim=1).to(torch.int32)
        n_regen = n_term_g.sum()
        g_row = torch.arange(g_local, dtype=torch.int32, device=dev)
        len_g = torch.clamp(cfg.num_pixels - g_row * p_true, 1, p_true)
        new_l = torch.remainder(state.curr_pixel[:, None] + rank2,
                                len_g[:, None])
        new_pixel = (lane_g * pk_ + new_l.reshape(n)).to(torch.int32)
        curr_out = torch.remainder(state.curr_pixel + n_term_g, len_g).to(
            torch.int32)
    else:
        rank, n_regen = exclusive_rank(terminate)
        new_pixel = torch.remainder(state.curr_pixel + rank, num_pixels).to(
            torch.int32)
        curr_out = torch.remainder(state.curr_pixel + n_regen,
                                   num_pixels).to(torch.int32)
    pixel_index = torch.where(terminate, new_pixel, pool.pixel_index)
    # camera rays address TRUE pixels
    cam_pid = padded_to_true_pid(cfg, pixel_index)
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

    counters = WfCounters(
        raygen=n_regen,
        # all n lanes are traced each segment (ray counts compare like for
        # like with the reference)
        extension=torch.tensor(n, dtype=torch.int32, device=dev),
        shadow=shadow_pending.sum(),
        splatted=n_splatted)
    new_state = WfState(pool=new_pool, film=film, spp=spp_counts,
                        curr_pixel=curr_out, features=features)
    return new_state, counters
