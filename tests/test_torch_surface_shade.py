"""A segment's surface, material and raygen sections in one call
(fluctus_tpu_torch/core/integrator_wf.py: ``surface_shade``, its plain
version ``surface_shade_plain`` and the kernel csrc/surface_shade.cu), on
the CPU.

- The plain version equals the sections it replaced in wf_logic_phase
  (``parent_sections``, their code as it stood there), bit for bit: whole
  renders of the production luxball (small maps, a seeded env map and the
  area light) and of luxball, free-running, capped with the denoiser, and
  a sharded slice (the second of two, pixel_base not 0), the state, the
  counters and the plain runs.
- The kernel's source, built by g++ with CUDA stubs (one thread a CTA, so
  the group scan runs as its carry), against the plain version: on the
  calls of those renders (both env routes, the denoiser, the flat ring)
  and on seeded calls at S = 256, 1,024 and 100 lanes a group, the flat
  ring's ranks and a sharded slice, with depth of field, emissive lanes,
  the resolve's baked texture descriptors and the atlas's. It computes as
  torch's CUDA kernels do; torch on the CPU divides and takes its
  transcendentals otherwise, so each float output agrees within
  test_torch_bsdf_shade's rule (64 float32 ulps of max(|value|, 1), 2^13
  for what a GGX lobe amplifies: the continuation pdf, and here the NEE
  ray's bsdf and pdf, whose direction the kernel samples itself);
  integers, flags, seeds, cursors and counts are equal. The card holds
  the compiled kernel to the plain version bit for bit (chip_smoke.py).
- The wrapper refuses inputs of another dtype, shape, layout or device."""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch import bxdf_types as bx
from fluctus_tpu_torch import kernel_build as kb
from fluctus_tpu_torch.bsdf import (ShadingParams, apply_textures,
                                    bsdf_shade, resolve_material)
from fluctus_tpu_torch.core import block_splat as bs
from fluctus_tpu_torch.core import integrator_wf as W
from fluctus_tpu_torch.core import pixel_ring as PR
from fluctus_tpu_torch.core.camera import generate_camera_rays
from fluctus_tpu_torch.core.integrator_mk import FeatureFilm, Film
from fluctus_tpu_torch.core.integrator_wf import WfPool
from fluctus_tpu_torch.core.pixel_ring import (exclusive_rank,
                                               padded_to_true_pid,
                                               scatter_pixels)
from fluctus_tpu_torch.core.trace import tangent_space_normal
from fluctus_tpu_torch.envmap import env_sample
from fluctus_tpu_torch.geom import Hit
from fluctus_tpu_torch.parallel import mesh as pm
from fluctus_tpu_torch.profiling import span
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.rng import rand
from fluctus_tpu_torch.sampling import (pdf_area_to_solid_angle,
                                        sample_area_light)
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3, dot, length
from fluctus_tpu_torch.vec import where as vwhere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import set_env_array, write_production_scene  # noqa: E402

LUXBALL = os.path.join(ROOT, "data", "luxball", "luxball.obj")
POOL = 512


def parent_sections(scene, params, state, config, hit, sp, seed, T, Ei,
                    terminate, plen, pixel_base=0):
    """wf_logic_phase's surface, material, features and raygen sections
    as they stood before ``surface_shade``: the locals they read, then
    their code."""
    cfg = config
    pool = state.pool
    n = pool.seed.shape[0]
    dev = pool.seed.device
    use_env = cfg.use_env_map and scene.env is not None
    light = params.area_light if cfg.use_area_light else None
    num_pixels = state.film.weight.shape[0]
    lpid = pool.pixel_index - pixel_base if pixel_base else pool.pixel_index
    block = cfg.block_ring
    if block:
        _, p_true, pk_ = PR.geometry(cfg)
        g_local = num_pixels // pk_
        s_ = n // g_local
        lane_g = torch.arange(n, dtype=torch.int32, device=dev) // s_

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
        nee_bsdf, nee_pdf, d_new, pdf_w, seed, new_T, cont_orig = bsdf_shade(
            nrm, sp, backface, pool.dir, shadow_dir, seed, T, hit.P,
            cfg.material_types)

    # ---- denoiser guide features (wf_logic.cl:214-237): the first hit's
    # normal in camera space (rows right, up, -dir) and the first
    # non-singular hit's albedo, splat as one 8-channel record after the
    # film's (K4, or the flat ring's scatter); a path's first-diffuse flag
    # ends with it
    features = state.features
    first_diffuse = pool.first_diffuse_hit
    if cfg.denoiser:
        with span("flt::shade.logic.features"):
            cam = params.camera
            nm = alive & (plen == 1)
            cs = Vec3(dot(cam.right, nrm), dot(cam.up, nrm),
                      -dot(cam.dir, nrm))
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
                fseg = torch.where(nm | am, lpid, num_pixels).to(torch.int32)
                f_new = f_old + scatter_pixels(fseg, fdata, num_pixels).T
            features = FeatureFilm(albedo=Vec3(f_new[0], f_new[1], f_new[2]),
                                   albedo_w=f_new[3],
                                   normal=Vec3(f_new[4], f_new[5], f_new[6]),
                                   normal_w=f_new[7])

    with span("flt::shade.logic.raygen"):
        # ---- RAYGEN for terminated paths (wf_raygen.cl): one ring per group,
        # or the flat ring's one cursor over every pixel
        if block:
            term_i = terminate.to(torch.int32).view(g_local, s_)
            rank2 = (torch.cumsum(term_i, dim=1) - term_i).to(torch.int32)
            n_term_g = term_i.sum(dim=1).to(torch.int32)
            n_regen = n_term_g.sum()
            # the slice's groups are g0.. of the whole film's
            g_row = pixel_base // pk_ + torch.arange(
                g_local, dtype=torch.int32, device=dev)
            len_g = torch.clamp(cfg.num_pixels - g_row * p_true, 1, p_true)
            new_l = torch.remainder(state.curr_pixel[:, None] + rank2,
                                    len_g[:, None])
            new_pixel = (pixel_base + lane_g * pk_ + new_l.reshape(n)).to(
                torch.int32)
            curr_out = torch.remainder(state.curr_pixel + n_term_g, len_g).to(
                torch.int32)
        else:
            rank, n_regen = exclusive_rank(terminate)
            new_pixel = (pixel_base + torch.remainder(
                state.curr_pixel + rank, num_pixels)).to(torch.int32)
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

    return W.Surfaced(new_pool, features, curr_out, n_regen)


def make_renderer(tmp_path, scene, denoiser=False, ring=True):
    """A 16x8 render of ``scene`` ("production": chip_smoke's production
    luxball with 64/32/16 maps; "luxball") with a seeded 32x16 env map
    beside the area light, depth 7, a pool of POOL lanes."""
    s = Settings()
    s.max_path_depth = 7
    s.wf_buffer_size = POOL
    s.use_denoiser = denoiser
    s.wf_block_ring = ring
    path = (write_production_scene(str(tmp_path / "scene"), (64, 32, 16),
                                   seed=3)
            if scene == "production" else LUXBALL)
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path / "data"),
                 device="cpu")
    r.load_scene(path)
    img = np.random.default_rng(5).random((16, 32, 3)).astype(np.float32)
    set_env_array(r, img * 4.0, "seeded")
    return r


ROUTES = ("free", "capped_denoise", "sharded")


def render(r, route):
    """The route's segments from a fresh pool: 4 free-running, an exact
    2 spp with the denoiser from reset(), or 4 of the second of two slices
    (``parallel.mesh``'s block-ring shard, pixel_base its film length).
    Returns (state as numpy, counters)."""
    if route == "free":
        r.init_wavefront(POOL)
        r.render_wavefront(4)
        return W.wf_state_to_numpy(r._wf_state), r._wf_total.tolist()
    if route == "capped_denoise":
        r.reset()
        r.render_single(2)
        return W.wf_state_to_numpy(r._wf_state), r._wf_total.tolist()
    r.init_wavefront(POOL)
    state = pm._slice(r._wf_state, 1, 2)
    base = state.film.weight.shape[0]
    counters = []
    for _ in range(4):
        state, c = W.wf_segment(r.device_scene, r.params, state, r._wf_cfg,
                                pixel_base=base)
        counters.append([int(x) for x in c])
    assert (state.pool.pixel_index >= base).all()
    return W.wf_state_to_numpy(state), counters


def _assert_tree_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scene", ["production", "luxball"])
def test_plain_equals_the_parent_sections(tmp_path, monkeypatch, scene,
                                          route):
    """The route through surface_shade (its plain version on the CPU) and,
    from the same reset, through the sections it replaced: the whole state
    (pool, film, spp, cursors, guide features) and the counters bit for
    bit; one plain run a segment."""
    r = make_renderer(tmp_path, scene, denoiser=route == "capped_denoise")
    kb.reset_counts()
    got = render(r, route)
    runs = W.K_SURFACE.plain_runs
    assert runs == r._wf_segments if route != "sharded" else runs == 4
    assert W.K_SURFACE.launches == 0
    monkeypatch.setattr(W, "surface_shade", parent_sections)
    want = render(r, route)
    assert W.K_SURFACE.plain_runs == runs
    _assert_tree_equal(got, want)


# The kernel's source compiled for the CPU: the CUDA keywords, the cache
# hints and intrinsics stubbed out for a CTA of one thread (a ballot is
# the thread's own flag), the launch a loop over the CTAs.
_CUDA_STUB = """
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
struct Dim3 { int x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx, gridDim;
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }
inline float __uint_as_float(unsigned int u) {
  float f; memcpy(&f, &u, 4); return f;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline void __syncthreads() {}
inline int min(int a, int b) { return a < b ? a : b; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/surface_shade.cu built by g++ (-ffp-contract=off, as nvcc's
    -fmad=false) with its headers, the launch rewritten as a loop over the
    CTAs (each of one thread: the block ring's CTA walks its group lane by
    lane); a ``launch`` for integrator_wf._surface_kernel."""
    d = tmp_path_factory.mktemp("surface_shade_cpu")
    csrc = os.path.join(os.path.dirname(kb.__file__), "csrc")
    (d / "cuda_runtime.h").write_text(_CUDA_STUB)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            with open(os.path.join(csrc, name)) as f:
                (d / name).write_text(f.read())
    with open(os.path.join(csrc, "surface_shade.cu")) as f:
        src = f.read()
    src, k = re.subn(
        r"(surface_shade_kernel)<<<[^>]*>>>\(a\);",
        r"for (int b = 0; b < (groups > 0 ? blocks : n); ++b) { "
        r"blockIdx.x = b; gridDim.x = groups > 0 ? blocks : n; "
        r"threadIdx.x = 0; blockDim.x = 1; \1(a); } (void)threads;", src)
    assert k == 1
    (d / "k.cpp").write_text(src)
    out = str(d / "libk.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(d), "-o", out,
                    str(d / "k.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(out).surface_shade_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]

    def launch(ptrs, ints, floats, groups):
        assert fn(ptrs, ints, floats, groups, None) == 0
    return launch


def run_kernel(launch, *args, **kw):
    return W._surface_kernel(launch, *args, **kw, cuda=False)


def _flat(out):
    """Surfaced as a list of (name, tensor), Vec3s and tuples spread."""
    res = []

    def walk(name, v):
        if v is None:
            return
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            for f, x in zip(v._fields, v):
                walk(f"{name}.{f}", x)
        else:
            res.append((name, v))
    walk("out", out)
    return res


# test_torch_bsdf_shade's rule: 64 ulps, and 2^13 for the GGX lobes'
# sampled pdf, whose half-vector near the normal grows a last-bit
# difference of the transcendentals some thousandfold. Here the NEE
# direction is the kernel's own too: the env map's sample takes sin and
# cos, an ulp apart on a few lanes, and a sharp GGX lobe grows that ulp in
# the NEE ray's bsdf and pdf alike (570 ulps at worst over these seeds).
ULPS = 64
PDF_ULPS = 1 << 13
GGX_AMPLIFIED = {"out.pool.last_pdf_w", "out.pool.last_pdf_implicit",
                 "out.pool.last_bsdf.x", "out.pool.last_bsdf.y",
                 "out.pool.last_bsdf.z"}


def assert_close(got, want, what):
    """Each float output within its ulps of max(|want|, 1), NaN where the
    other is NaN; every other output equal."""
    a_all, b_all = _flat(got), _flat(want)
    assert [n for n, _ in a_all] == [n for n, _ in b_all], what
    for (name, a), (_, b) in zip(a_all, b_all):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if a.dtype != torch.float32:
            assert torch.equal(a, b), f"{what}: {name} differs"
            continue
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan), f"{what}: {name} NaN"
        ulps = PDF_ULPS if name in GGX_AMPLIFIED else ULPS
        tol = ulps * torch.finfo(torch.float32).eps * torch.clamp_min(
            b.abs(), 1.0)
        err = torch.where(nan, 0.0, (a - b).abs())
        assert bool((err <= tol).all()), (
            f"{what}: {name}, max |err| {float(err.max())} at lane "
            f"{int(torch.argmax(err - tol))}")


def recorded_calls(r, route, monkeypatch):
    """The arguments of every surface_shade call of ``render(r, route)``."""
    calls = []
    real = W.surface_shade

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(W, "surface_shade", rec)
    render(r, route)
    monkeypatch.setattr(W, "surface_shade", real)
    return calls


CASES = {"production": ("production", "free", {}),
         "production_alias": ("production", "free", {"fast": False}),
         "production_denoise": ("production", "capped_denoise", {}),
         "production_sharded": ("production", "sharded", {}),
         "production_flat": ("production", "free", {"ring": False}),
         "luxball": ("luxball", "free", {}),
         "luxball_denoise": ("luxball", "capped_denoise", {})}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain_on_renders(tmp_path, monkeypatch,
                                                kernel_on_cpu, case):
    """Every surface_shade call of a route's render, through the kernel's
    source and through the plain version: the env map on the single-read
    route the card takes (``fast_env``), or on the bilinear + alias one
    (the CPU's, and the card's for maps past 2^18 texels)."""
    scene, route, opt = CASES[case]
    r = make_renderer(tmp_path, scene, denoiser=route == "capped_denoise",
                      ring=opt.get("ring", True))
    calls = recorded_calls(r, route, monkeypatch)
    assert calls
    for k, (args, kw) in enumerate(calls):
        args = list(args)
        args[3] = args[3].replace(fast_env=opt.get("fast", True))
        assert_close(run_kernel(kernel_on_cpu, *args, **kw),
                     W.surface_shade_plain(*args, **kw), f"{case} call {k}")


def _unit(rng, m):
    v = rng.normal(size=(3, m))
    return v / np.linalg.norm(v, axis=0)


def _f(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _i(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _v(a):
    return Vec3(_f(a[0]), _f(a[1]), _f(a[2]))


# the scene masks of test_torch_bsdf_shade: the production luxball's five
# lobes, the grid's diffuse + ideal dielectric, every lobe
PROD = (bx.BXDF_DIFFUSE | bx.BXDF_GLOSSY | bx.BXDF_GGX_ROUGH_REFLECTION
        | bx.BXDF_GGX_ROUGH_DIELECTRIC | bx.BXDF_IDEAL_DIELECTRIC)
MASKS = {"luxball_prod": PROD,
         "grid8x8": bx.BXDF_DIFFUSE | bx.BXDF_IDEAL_DIELECTRIC,
         "all": sum(bx.ALL_TYPES)}
NO_LOBE = (0, 1, 1 << 9, -1)      # no lobe's bit: terminated, missed lanes


def _lobes(rng, sp, m, mask):
    """Each lane's lobe drawn from every type and the no-lobe values, its
    parameters as test_torch_bsdf_shade draws them (Ks zero on a quarter,
    alphas from 0.01, Ni from 0 to 2.4, not 1: a rough dielectric that
    matches the outside index refracts through a half-vector of rounding
    noise); ``mask`` the scene's."""
    ks = rng.random((3, m))
    ks[:, rng.random(m) < 0.25] = 0.0
    types = rng.choice(list(bx.ALL_TYPES) + list(NO_LOBE), size=m)
    return sp._replace(Kd=_v(rng.random((3, m))), Ks=_v(ks),
                       alpha=_f(0.01 + rng.random(m)),
                       Ni=_f(rng.choice((0.0, 1.33, 1.5, 2.4), size=m)),
                       type=_i(types))


EDGE = ("no_lobe", "left_out", "emissive", "ideal_tir", "rough_tir")


def _edge_lanes(sp, hit, pool, m):
    """The production mask's edge lanes, lane k of kind EDGE[k % 5]: a type
    of no lobe's bit, the mirror the mask leaves out, emissive, and the
    ideal and the rough dielectric (alpha 0.05: its half-vectors within a
    few degrees of the normal) lit from inside glass of index 1.5 at 60
    degrees, past the critical 41.8 (interpolated normal +z, no normal
    map, the ray leaving along +z: the backface flip puts the shading
    normal at -z, and every such lane reflects back to -z)."""
    kind = torch.arange(m) % len(EDGE)
    no_lobe = torch.tensor(NO_LOBE, dtype=torch.int32)[
        torch.arange(m) // len(EDGE) % len(NO_LOBE)]
    typ = torch.stack([no_lobe,
                       torch.full((m,), bx.BXDF_IDEAL_REFLECTION),
                       torch.full((m,), bx.BXDF_EMISSIVE),
                       torch.full((m,), bx.BXDF_IDEAL_DIELECTRIC),
                       torch.full((m,), bx.BXDF_GGX_ROUGH_DIELECTRIC)])
    typ = typ.gather(0, kind[None].long())[0].to(torch.int32)
    tir = kind >= 3
    up = lambda v, w: Vec3(*(torch.where(tir, float(c), a)
                             for c, a in zip(w, v)))
    sp = sp._replace(type=typ, Ni=torch.where(tir, 1.5, sp.Ni),
                     alpha=torch.where(tir, 0.05, sp.alpha),
                     map_N=torch.where(tir, -1, sp.map_N))
    hit = hit._replace(N=up(hit.N, (0.0, 0.0, 1.0)))
    pool = pool._replace(dir=up(pool.dir, (np.sin(np.pi / 3), 0.0,
                                           np.cos(np.pi / 3))))
    return sp, hit, pool, tir


def seeded_call(r, seed, s, groups, flat=False, shard=None, baked=True,
                denoiser=True, lobes=None, edge=False):
    """surface_shade's arguments from a numpy seed on ``r``'s scene (its
    tables, atlas, tangent frames and env map): ``groups`` groups of ``s``
    lanes (the flat ring: one ring over their pixels), or with ``shard``
    = (k, d) slice k of d. Lanes: a third terminated, every material of
    the scene and some emissive ones, uvs past [0, 1] (the maps wrap), the
    descriptors baked (``baked``) or gathered from the atlas, pixels and
    cursors anywhere on their rings; the camera with depth of field. With
    ``lobes`` (a scene mask, set as the config's ``material_types``) each
    lane's lobe is drawn from every type (``_lobes``); with ``edge`` the
    lanes are the production mask's edge lanes (``_edge_lanes``)."""
    rng = np.random.default_rng(seed)
    cfg = r.config.replace(groups=groups, block_ring=not flat,
                           denoiser=denoiser, fast_env=True)
    n = groups * s
    g_all, pk = groups, 128
    p_true = -(-cfg.num_pixels // groups)
    g_local, g0 = (g_all, 0) if shard is None else (
        g_all // shard[1], shard[0] * (g_all // shard[1]))
    n_local = g_local * s
    npix = g_local * pk if not flat else cfg.num_pixels // (
        1 if shard is None else shard[1])
    base = g0 * pk if not flat else (0 if shard is None
                                     else shard[0] * npix)
    m = n_local
    frames = r.device_scene.tri_frames
    mats = r.scene.device_materials(device="cpu")
    mid = _i(rng.integers(0, mats.type.shape[0], size=m))
    g = mats.gather(mid)
    typ = g.type.clone()
    typ[_i(rng.random(m) < 0.05).bool()] = bx.BXDF_EMISSIVE
    atlas = r.device_scene.atlas

    def meta(mp):
        if not baked:
            return None
        safe = torch.clamp_min(mp, 0).long()
        return (atlas.offset[safe].clone(), atlas.width[safe].clone(),
                atlas.height[safe].clone())
    sp = ShadingParams(
        Kd=g.Kd, Ks=g.Ks, Ke=_v(rng.random((3, m)) * 3), Kt=g.Kt,
        alpha=g.Ns, Ni=g.Ni, d=g.d, type=typ, map_N=g.map_N,
        map_Kd=g.map_Kd, map_Ks=g.map_Ks, kd_meta=meta(g.map_Kd),
        ks_meta=meta(g.map_Ks), n_meta=meta(g.map_N))
    ntri = frames.shape[1]
    hit = Hit(P=_v(rng.normal(size=(3, m)) * 2), N=_v(_unit(rng, m)),
              uv_u=_f(rng.uniform(-1.5, 2.5, m)),
              uv_v=_f(rng.uniform(-1.5, 2.5, m)),
              t=_f(rng.random(m)), i=_i(rng.integers(0, ntri, size=m)),
              area_light_hit=_i(np.zeros(m)), mat_id=mid)
    terminate = torch.from_numpy(rng.random(m) < 1 / 3)
    if not flat:       # one group all terminated, one with none
        terminate.view(g_local, s)[0] = True
        terminate.view(g_local, s)[-1] = False
    pool = W.wf_reset(cfg.replace(groups=groups), n, device="cpu").pool
    pool = pm._slice(pool, 0 if shard is None else shard[0],
                     1 if shard is None else shard[1])
    if flat:
        pix = base + rng.integers(0, npix, size=m)
        curr = torch.tensor(int(rng.integers(0, npix)), dtype=torch.int32)
    else:
        lane_g = np.arange(m) // s
        len_g = np.clip(cfg.num_pixels - (g0 + lane_g) * p_true, 1, p_true)
        pix = base + lane_g * pk + (rng.integers(0, 1 << 20, size=m)
                                    % len_g)
        len_c = np.clip(cfg.num_pixels - (g0 + np.arange(g_local)) * p_true,
                        1, p_true)
        curr = _i(rng.integers(0, 1 << 20, size=g_local) % len_c)
    pool = pool._replace(
        dir=_v(_unit(rng, m)), shadow_orig=_v(rng.normal(size=(3, m))),
        shadow_dir=_v(_unit(rng, m)), shadow_len=_f(rng.random(m) * 9),
        last_pdf_direct=_f(rng.random(m)), last_cos_th=_f(rng.random(m)),
        last_light_pick=_f(rng.random(m)),
        last_emission=_v(rng.random((3, m))),
        path_len=_i(rng.integers(-1, 6, size=m)), pixel_index=_i(pix),
        first_diffuse_hit=torch.from_numpy(rng.random(m) < 0.5))
    state = W.WfState(pool=pool, film=Film.zeros(npix, "cpu"),
                      spp=torch.zeros(npix, dtype=torch.int32),
                      curr_pixel=curr,
                      features=FeatureFilm.zeros(npix, "cpu"))
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, size=m,
                                          dtype=np.int64))
    cam = r.params.camera
    params = r.params._replace(camera=cam._replace(
        aperture_size=torch.tensor(0.05), focal_dist=torch.tensor(3.0)))
    T, Ei = _v(rng.random((3, m)) + 0.01), _v(rng.random((3, m)))
    if lobes is not None:
        cfg = cfg.replace(material_types=lobes)
        sp = _lobes(rng, sp, m, lobes)
    if edge:
        sp, hit, pool, _ = _edge_lanes(sp, hit, pool, m)
        state = state._replace(pool=pool)
    return (r.device_scene, params, state, cfg, hit, sp, seeds, T, Ei,
            terminate, pool.path_len + 1), dict(pixel_base=base)


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    return make_renderer(tmp_path_factory.mktemp("production"),
                         "production")


SEEDED = {"s256": dict(s=256, groups=4), "s1024": dict(s=1024, groups=2),
          "s100": dict(s=100, groups=8), "s100_atlas": dict(
              s=100, groups=4, baked=False),
          "flat": dict(s=256, groups=4, flat=True),
          "sharded": dict(s=256, groups=8, shard=(1, 2)),
          "flat_sharded": dict(s=128, groups=4, flat=True, shard=(1, 2)),
          "no_denoiser": dict(s=96, groups=4, denoiser=False),
          **{f"lobes_{mask}_{seed}": dict(s=256, groups=4,
                                           lobes=MASKS[mask], seeds=(seed,))
             for mask in MASKS for seed in (1, 2, 3)},
          "edge_lanes": dict(s=100, groups=4, lobes=PROD, edge=True,
                             seeds=(4,))}


@pytest.mark.parametrize("case", list(SEEDED))
def test_kernel_source_matches_plain_seeded(production, kernel_on_cpu, case):
    """Seeded calls (``seeded_call``): S lanes a group not a power of two
    and past the CTA's 256 (the scan's carry across tiles), the flat
    ring's ranks, a slice's pixel_base, the atlas's descriptors, depth of
    field; every lobe under each scene mask, and the edge lanes (their
    dielectrics reflect); the cursors and restarted counts equal."""
    opt = dict(SEEDED[case])
    for seed in opt.pop("seeds", (1, 2)):
        args, kw = seeded_call(production, seed, **opt)
        want = W.surface_shade_plain(*args, **kw)
        assert int(want.n_regen) == int(args[9].sum())
        assert_close(run_kernel(kernel_on_cpu, *args, **kw), want,
                     f"{case}, seed {seed}")
        if opt.get("edge"):
            tir = (torch.arange(args[9].shape[0]) % len(EDGE) >= 3) \
                & ~args[9]
            assert bool(tir.any())
            assert bool((want.pool.dir.z[tir] < 0.0).all())


def test_wrapper_refuses_malformed_inputs(production):
    """A float64 throughput, an int64 type, a [m, 1] seed, a short hit
    point, a strided direction among tensors the kernel could take, one
    tensor on another device, and tensors on a device that is neither the
    CPU nor CUDA: each a ValueError; the CPU takes the plain version."""
    args, kw = seeded_call(production, 3, s=64, groups=4)
    names = ("scene", "params", "state", "config", "hit", "sp", "seed", "T",
             "Ei", "terminate", "plen")
    meta = {k: _to(v, "meta") for k, v in zip(names, args)}
    bad = {
        "dtype": dict(T=Vec3(meta["T"].x.double(), *meta["T"][1:])),
        "type dtype": dict(sp=meta["sp"]._replace(
            type=meta["sp"].type.long())),
        "shape": dict(seed=meta["seed"][:, None]),
        "length": dict(hit=meta["hit"]._replace(P=Vec3(
            meta["hit"].P.x[:8], *meta["hit"].P[1:]))),
        "layout": dict(Ei=Vec3(torch.zeros(2 * args[8].x.shape[0],
                                           device="meta")[::2],
                               *meta["Ei"][1:])),
        "device": dict(terminate=args[9]),
    }
    match = {"dtype": "dtype", "type dtype": "dtype", "shape": "shape",
             "length": "shape", "layout": "not contiguous",
             "device": "is on cpu"}
    kb.reset_counts()
    for what, swap in bad.items():
        a = dict(meta, **swap)
        with pytest.raises(ValueError, match=match[what]):
            W.surface_shade(*(a[k] for k in names), **kw)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        W.surface_shade(*(meta[k] for k in names), **kw)
    assert W.K_SURFACE.launches == 0 and W.K_SURFACE.plain_runs == 0
    out = W.surface_shade(*args, **kw)
    assert W.K_SURFACE.plain_runs == 1
    _assert_tree_equal(W.wf_state_to_numpy(W.WfState(
        out.pool, args[2].film, args[2].spp, out.curr_pixel)),
        W.wf_state_to_numpy(W.WfState(
            W.surface_shade_plain(*args, **kw).pool, args[2].film,
            args[2].spp, out.curr_pixel)))


def _to(x, device):
    """Every tensor of a (nested) NamedTuple on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x
