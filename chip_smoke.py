#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fluctus_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, one JSON line each; any failure raises and exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), then
   every kernel of csrc/ built from source in parallel; for K2, K5 and K9
   (csrc/sweep_hopper.cuh) the registers, spills and shared memory of each
   instantiation and the occupancy they allow.
2. kernel vs plain: the inputs K1-K4 receive on the luxball path (the 1M
   camera rays of the second segment and the bounce rays of the fourth, as
   the pair trace sorts them) go through each kernel and through its plain
   PyTorch version on the card; the outputs are held to the stated
   tolerances and both are timed (CUDA events, median; a spin kernel
   queued first hides the host's launch, and a kernel's time with its
   launch stands beside), with one PyTorch library call computing the
   same function as a yardstick where one exists. K1 (its candidate
   lists, order and skey, against _candidate_order(tile_order_plain))
   and K4 (all four channels) bit for bit, each also on synthetic calls
   from a numpy seed: K1 on edge-case tiles (NaN, +-0, +-inf and
   subnormal direction components, origins on box faces, tmax 0, -1,
   +inf and NaN, an all-culled tile, ties at 0.0) with 1, 13, 33 and
   4,096 boxes (the wrapper's limit; one more must raise ValueError) and
   a tile of 96 rays; K4 on groups with every lane on one pixel, every
   lane on its own pixel, empty lanes and every lane empty.
3. luxball path: Renderer(1920, 1080) on luxball with a 1M-path pool, 2
   warm-up segments, a fresh pool, then SEGMENTS timed segments; Mrays/s
   (primary + extension + shadow rays, as bench.py counts them),
   ms/segment, peak memory; every kernel's launch count must equal
   segments x its launches per segment, no plain version may run, the
   film must be finite with weight > 0 on >= 99% of pixels. K2's calls
   of the last timed segment are held bit for bit to the plain version and
   timed. Then two more segments under torch.profiler: device time by
   kernel, device operations per segment and the device's busy share.
4. whole-path parity: 4 segments at 256x144 with 64k paths through the
   kernels and, from the same reset, through the plain versions on the
   card.
2b, 3b, 4b: the same three phases on the large-scene path: the 8x8
   luxball grid (361,088 triangles, 2,056 clusters, past both tier
   switches), so each segment runs K1 over superclusters, K5 twice, K6
   and K4. 2b holds K1 (over superclusters), K5 (both modes) and K6 to
   their plain versions
   and times K3 on K6's inputs; 3b times LARGE_SEGMENTS segments, checks
   the primary-hit share, and holds K5's calls of its last segment to the
   plain version and times them. The trace kernels (K2, K5, K9) are held
   bit for bit: t as int32 bits, columns and per-tile visit counts; their
   lines carry the per-tile visits (p50, p99, max), the (ray, triangle)
   pairs per second and the kernel's time on its heaviest 1% of tiles
   alone and on the rest, K5's also the live superclusters and member
   culls of each tile (counted on the plain walk).
5. exact-spp (Renderer.render_single, the capped wavefront) on luxball at
   1080p with 1M paths: a first render records K7's and K8's arguments in
   segment 2 and in the last segment where budgets bind, held bit for bit
   to their plain versions and timed, and K7 also on one synthetic call of
   the same shape from a numpy seed: groups with every lane on one pixel,
   every lane on its own pixel, empty (-1) lanes, every lane empty,
   budgets 0, 1, 2.5, 255, 1e30 and NaN (5a); then, from reset(), a timed
   render_single(EXACT_SPP): spp and film weight equal the target on
   every true pixel, 0 weight on parked padded slots (the reference's
   wf_reset leaves the first slot of a group without pixels live; those
   "phantom" slots are counted and reported), launches per segment K1 2,
   K2 2, K3 1, K7 1, K8 1, K4 0; a second call accumulates to twice the
   target (profiled: device time by kernel and busy share), and
   render_wavefront re-inits with the cap off (5b); and the
   exact render at 256x144 with 64k paths through the kernels and through
   the plain versions, film and spp equal (5c).
6. the microkernel megastep (flags.FORCE_MK) at 1080p: MK_SPP samples,
   weight MK_SPP everywhere, launches per sample (depth + 1) x (K1 2, K2 2,
   K3 1), its image mean within 15% of the exact render's, and one more
   sample profiled (6a); the same
   with flags.SORT_RAYS off, which traces in lane order through K1 and K9
   in both modes: one closest-hit and one any-hit K9 call held to
   trace_ros_plain (columns and t bit-equal) and timed beside K2 on the
   same rays sorted (6b); pick_single at the image centre against
   closest_hit_mxu_full (6c).
7. edge-case tiles (after phase 2 on luxball's tables, after 2b on the
   8x8 grid's): K2, K9 and K5, closest-hit and any-hit, bit for bit against
   their plain versions on tiles made from a numpy seed: tmax = +inf
   lanes, direction components of 0, origins on a triangle's plane, rays
   parallel to a triangle, lists that end at once, tiles that stop at
   once, and K5 walking superclusters of 1 and 64 members first.
8. the K10 route: luxball's tables written as a table cache without B16
   (0-d b16t/attr_b16, under the reference's file name) load through
   Renderer.load_scene, so resolve_hits_mxu takes K10 (csrc/resolve_v1.cu)
   by the tables' content. 8a: K10's recorded inputs of segments 2 and 4
   held bit for bit to resolve_v1_plain and, on the same winners, to K3 on
   the B16 tables within the reference's v5-vs-v1 gate; timed. 8b: the
   1080p/1M wavefront on those tables (launches per segment K1 2, K2 2,
   K10 1, K4 1, K3 0), its tonemapped mean within 1% of phase 3's B16
   route after the same segments, one profiled segment (K10's share of
   device time), and render_single(4) exact. 8c: whole-path parity
   through the kernels and the plain versions on those tables, film and
   spp equal. 8d: the 8x8 grid loaded cold, then warm from its BVH and
   table caches: host seconds, cache hits, device tables and the films
   of 4 segments equal, the cache files' sizes.
9. the env map, on luxball at 1080p with 1M paths (phase 3's view and
   light). 9a: gallery/teapot_wavefront.hdr (512x512, the single-read
   "fast" route the card takes): K1-K4 held to their plain versions on
   the recorded calls of segments 2 and 4 (phase 2's helpers), then
   ENV_SEGMENTS timed segments as phase 3 (its image brighter than phase
   3's), one profiled, and the env lookups' device time per segment. 9c:
   render_single(ENV_SPP) with that map: K7 and K8 held bit for bit on
   its recorded calls and timed (K8 with its bound, the 32-byte sectors
   it touches and torch.take), then a timed render with spp = weight =
   ENV_SPP on every pixel. 9e: one megastep sample (FORCE_MK), an env and
   an area shadow trace per bounce. 9b: a seeded 2048x1024 sky from
   EnvironmentMap.from_array (past 2^18 texels: the bilinear + alias
   route), ENV_ALIAS_SEGMENTS timed segments, profiled as 9a. 9d: phase
   4's parity with the env map, fast and alias routes and the env map
   alone (no area light).
11. the production luxball (write_production_scene, written
   from a seed into a temporary directory: luxball with planar uvs, a
   2048^2 albedo map and a 1024^2 normal map on the ground, a 512^2
   specular map on the glossy core, a rough dielectric glass, and a
   second instance beside it with a rough-reflection core and an ideal
   glass; 11,282 triangles on the flat tier, K1-K4), at 1080p with 1M
   paths, depth 10, phase 3's view and light. 11a: K1-K4 held to their
   plain versions on the recorded calls of segments 2 and 4; on K3's
   calls the share of textured lanes (map rows 22-24) and that their
   descriptor rows 29-34 are non-zero, K6 on the same calls and K10 on
   the same winners with the tables' f32 attrs, each bit for bit against
   its plain version (so all three resolve kernels are held with textured
   rows); PROD_SEGMENTS timed segments, one profiled, and the texture
   work's device time per segment (a tex_lookup line: apply_textures and
   the normal mapping); then with the teapot env map (single-read route)
   K1-K4 held again and PROD_ENV_SEGMENTS timed segments. 11b:
   use_russian_roulette on, PROD_RR_SEGMENTS timed segments, then the
   share of lanes roulette ends in each of 4 more segments. 11c:
   render_single(PROD_SPP) with roulette set (it runs without, as the
   reference's): spp = weight = PROD_SPP on every pixel; then the capped
   wavefront with roulette on (exact_with_roulette), K7 and K8 held bit
   for bit on its recorded calls, spp = weight exact. 11d: one megastep
   sample (render_sample) with roulette on, launches per bounce K1 2, K2
   2, K3 1. 11e: phase 4's parity on the production scene, with
   sample_implicit off, with sample_explicit off and with roulette on.
12. a user's render job at 1080p with 1M paths, depth 10. 12a: phase
   11's production luxball with use_denoiser: K4 at 4 channels (the film)
   and 8 (the guide features, splat after the film) held bit for bit on
   segments 2 and 4, timed at 8 channels beside its bound and
   index_add_, and on a synthetic 8-channel call; render_single(JOB_SPP)
   with every K4 call (the features) held bit for bit, K7 and K8 as in
   phase 5, spp = weight = JOB_SPP, whole feature weights, the denoised
   image finite and its device time (atrous_denoise); then
   DENOISE_SEGMENTS timed and 2 profiled free-running segments beside
   11a's without the denoiser. K4's wrapper counts its launches by
   channel count (``launches_by``): the exact render makes one 8-channel
   launch per segment, the timed segments one 4-channel and one
   8-channel launch each. 12b: luxball render_single(RESUME_SPP),
   save_checkpoint, a fresh Renderer's load_checkpoint and
   render_single(RESUME_SPP): spp = weight = 2 x RESUME_SPP on every
   pixel, its tonemapped mean within the 1% bias gate of an uninterrupted
   render_single(2 x RESUME_SPP). 12c: python -m fluctus_tpu_torch in a
   fresh directory on the luxball (absolute path): -s CLI_SPP
   --save-state --checkpoint writes the .png, the .hdr, the checkpoint
   and a state file that round-trips through state_io; then --wavefront
   24 --preview-every 8 --checkpoint loads the state ("Loaded render
   state"), resumes the checkpoint and writes 2 preview frames.
13. the flat pixel ring (film in true pixel order, one raygen cursor,
   the film scatter an index_add_ into num_pixels + 1 buckets) on luxball
   at 1080p, depth 10. 13a: wf_block_ring off, K1-K3 held to their plain
   versions on the recorded calls of segments 2 and 4 (no K4 call), then
   SEGMENTS timed segments with 1M paths (launches per segment K1 2, K2 2,
   K3 1, K4/K7/K8 0), 2 profiled (the index_add_ kernels' device time and
   share), the scatter alone on its segment's call; phase 4's parity on
   the flat ring (integer state and weights equal, rgb within FLAT_RTOL).
   13c: wf_splat_every = FLAT_SPLAT_EVERY (accepted and ignored: the
   port scatters every segment), the same timed segments: the counters
   equal 13a's and the film equals 13a's (weights exactly, rgb within
   FLAT_RTOL); one scatter of 4 segments' records timed, as the JAX
   package's batching would make it. 13d: the
   denoiser on the flat ring, 4 segments: whole feature weights, a finite
   denoised image, the 8-channel scatter timed. 13b: the default config
   (block ring, 4096 groups) and render_single_wavefront(FLAT_SPP,
   num_tasks=1,000,000), which the groups do not divide: the flat ring,
   spp = weight = FLAT_SPP on every pixel, its tonemapped mean within the
   1% bias gate of phase 5's block-ring render, seconds and Mrays/s
   beside phase 5's. 13e: FLT_BLOCK_RING=0 in a subprocess takes the flat
   ring and says so; the same process without it, the block ring. 13f:
   luxball's 5,642 triangles written as an ASCII PLY, loaded cold (both
   caches written) and warm (both hit), 4 flat segments with a finite
   film.
10. the kernels line (launches including phases 11, 12 and 13's timed
   runs; K4's entry with its 8-channel launches, as counted in 12a), the
   card line, then the final result line.

Every renderer loads with a fresh temporary ``data_dir`` (removed at the
end), so phases 2-6 load cold as before (now writing the caches) and
nothing is written under the repository's data/.

Prints nothing of the result and exits non-zero without CUDA or without
the package beside it.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEGMENTS = 24
LARGE_SEGMENTS = 12
LUXBALL = "data/luxball/luxball.obj"
LARGE = "fluctus_tpu_torch/scenes/luxball_grid_8x8.sc.json"
# camera (pos, dir) and area light (pos, half size); N (0,-1,0), E 50
VIEWS = {LUXBALL: ((0.0, 1.6, 4.5), (0.0, -0.12, -1.0), (0, 4, 0),
                   (0.5, 0.5)),
         LARGE: ((0.0, 34.0, 48.0), (0.0, -1.0, -1.0), (0, 20, 0),
                 (6.0, 6.0))}
PEAK_FP32 = 67e12          # H100 SXM FP32 (non-tensor) FLOP/s, data sheet
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s, data sheet
EXACT_SPP = 16
MK_SPP = 2
MK_MEAN_GATE = 0.15        # tests/test_render_single_wf.py:35-38
_ZERO = {"trace_rol_sc": 0, "resolve_v5s": 0, "block_splat_capped": 0,
         "fetch": 0, "trace_ros": 0, "resolve_v1": 0}
PER_SEGMENT = {"tile_order": 2, "trace_rol": 2, "resolve_v5": 1,
               "block_splat": 1, **_ZERO}
PER_SEGMENT_LARGE = {"tile_order": 2, "trace_rol_sc": 2, "resolve_v5s": 1,
                     "block_splat": 1, "trace_rol": 0, "resolve_v5": 0,
                     "block_splat_capped": 0, "fetch": 0, "trace_ros": 0,
                     "resolve_v1": 0}
PER_SEGMENT_EXACT = {"tile_order": 2, "trace_rol": 2, "resolve_v5": 1,
                     "block_splat": 0, "trace_rol_sc": 0, "resolve_v5s": 0,
                     "block_splat_capped": 1, "fetch": 1, "trace_ros": 0,
                     "resolve_v1": 0}
# the same paths on tables without B16: K10 takes K3's place
PER_SEGMENT_K10 = {**PER_SEGMENT, "resolve_v5": 0, "resolve_v1": 1}
PER_SEGMENT_EXACT_K10 = {**PER_SEGMENT_EXACT, "resolve_v5": 0,
                         "resolve_v1": 1}
K10_SPP = 4
ENV_FILE = "gallery/teapot_wavefront.hdr"   # 512x512: the fast route
ENV_SEGMENTS = 24
ENV_ALIAS_SEGMENTS = 12
SKY_SIZE = (2048, 1024)    # 2,097,152 texels, past 2^18: the alias route
ENV_SPP = 16
# phase 11: the albedo, normal and specular maps' sizes (5,505,024 texels,
# under the descriptors' 2^24), segments and spp
PROD_SIZES = (2048, 1024, 512)
PROD_SEGMENTS = 24
PROD_ENV_SEGMENTS = 24     # fewer leave pixels uncovered under the env map
PROD_RR_SEGMENTS = 24
PROD_SPP = 4
PROD_PARITY = ({}, {"sample_implicit": False}, {"sample_explicit": False},
               {"use_russian_roulette": True})
BIAS_GATE = 0.01           # the 1% tonemapped-mean bias gate (ROADMAP)
# phase 13: the flat pixel ring. Its film scatter (index_add_) adds by
# atomics in no fixed order, so two flat films agree to a few ulp of each
# pixel's sum of non-negative samples: rgb is held at FLAT_RTOL / FLAT_ATOL,
# whole-number weights and integer state exactly
FLAT_RTOL, FLAT_ATOL = 1e-5, 1e-6
FLAT = {"wf_block_ring": False}
FLAT_SPLAT_EVERY = 4
FLAT_SPP = 16
FLAT_POOL = 1_000_000      # 1,000,000 % 4096 = 576: the exact path's pool
PER_SEGMENT_FLAT = {**PER_SEGMENT, "block_splat": 0}
LUXBALL_TRIANGLES = 5642
# the device kernels of Tensor.index_add_ (the profiler's names)
INDEX_ADD = r"indexFunc\w*Index"
# phase 12: with the denoiser K4 also splats the 8 guide-feature channels
# once a segment, after the film's splat (or K7's, with the spp cap)
PER_SEGMENT_DENOISE = {**PER_SEGMENT, "block_splat": 2}
PER_SEGMENT_EXACT_DENOISE = {**PER_SEGMENT_EXACT, "block_splat": 1}
JOB_SPP = 4
DENOISE_SEGMENTS = 24       # 12 leave 2.4% of the pixels uncovered
RESUME_SPP = 8             # 12b: 8 + 8 spp against 16 uninterrupted
CLI_SPP = 16
# per bounce of a sample: one extension and one shadow trace, one resolve
PER_BOUNCE_MK = {"tile_order": 2, "trace_rol": 2, "resolve_v5": 1,
                 "block_splat": 0, **_ZERO}
PER_BOUNCE_ROS = {**PER_BOUNCE_MK, "trace_rol": 0, "trace_ros": 2}
# with the env map and the area light, NEE traces a shadow ray to each
PER_BOUNCE_MK_ENV = {**PER_BOUNCE_MK, "tile_order": 3, "trace_rol": 3}
SOURCES = {"tile_order": "fluctus_tpu_torch/csrc/tile_order.cu",
           "trace_rol": "fluctus_tpu_torch/csrc/trace_rol.cu",
           "resolve_v5": "fluctus_tpu_torch/csrc/resolve_v5.cu",
           "block_splat": "fluctus_tpu_torch/csrc/block_splat.cu",
           "trace_rol_sc": "fluctus_tpu_torch/csrc/trace_rol_sc.cu",
           "resolve_v5s": "fluctus_tpu_torch/csrc/resolve_v5s.cu",
           "block_splat_capped":
               "fluctus_tpu_torch/csrc/block_splat_capped.cu",
           "fetch": "fluctus_tpu_torch/csrc/fetch.cu",
           "trace_ros": "fluctus_tpu_torch/csrc/trace_ros.cu",
           "resolve_v1": "fluctus_tpu_torch/csrc/resolve_v1.cu"}
REPLACES = {"tile_order": "fluctus_tpu/accel/mxu_trace.py:1056",
            "trace_rol": "fluctus_tpu/accel/mxu_trace.py:736",
            "resolve_v5": "fluctus_tpu/accel/mxu_trace.py:1745",
            "block_splat": "fluctus_tpu/core/block_splat.py:103",
            "trace_rol_sc": "fluctus_tpu/accel/mxu_trace.py:832",
            "resolve_v5s": "fluctus_tpu/accel/mxu_trace.py:1894",
            "block_splat_capped": "fluctus_tpu/core/block_splat.py:116",
            "fetch": "fluctus_tpu/core/block_splat.py:147",
            "trace_ros": "fluctus_tpu/accel/mxu_trace.py:630",
            "resolve_v1": "fluctus_tpu/accel/mxu_trace.py:1669"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


TMP_ROOT = None            # the run's temporary directory (main sets it)


def fresh_dir():
    """A new empty directory under the run's temporary directory."""
    return tempfile.mkdtemp(dir=TMP_ROOT)


def make_renderer(width, height, device, scene=LUXBALL, data_dir=None,
                  env_map=None, area_light=True, switches=None):
    """A main path's renderer: luxball with the camera of
    tools/make_goldens.py and an area light above the ball (any scene
    without a view of its own, as phase 11's production luxball, takes
    this view), or the 8x8 grid seen from above its near edge with a
    12x12 light over its centre; with the env map file ``env_map`` when
    given, without the area light when ``area_light`` is False, and the
    Settings fields of the dict ``switches`` set. Its caches live in
    ``data_dir``, a fresh (cold) one unless given."""
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    pos, dir_, lpos, lsize = VIEWS.get(scene, VIEWS[LUXBALL])
    s = Settings()
    s.camera.pos, s.camera.dir = pos, dir_
    a = s.area_light
    a.pos, a.N, a.right, a.up = lpos, (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E, a.size = (50.0, 50.0, 50.0), lsize
    s.use_area_light = area_light
    for name, value in (switches or {}).items():
        setattr(s, name, value)
    r = Renderer(width, height, settings=s, device=device,
                 data_dir=data_dir or fresh_dir())
    r.load_scene(scene, env_map=env_map)
    return r


class Recorder:
    """Record the arguments of the kernel wrappers during chosen segments
    (the wrappers run as usual)."""

    def __init__(self):
        from fluctus_tpu_torch.accel import mxu_trace as mt
        from fluctus_tpu_torch.core import block_splat as bs
        self.targets = [(mt, "tile_order"), (mt, "trace_rol"),
                        (mt, "resolve_v5"), (bs, "splat"),
                        (mt, "trace_rol_sc"), (mt, "resolve_v5s"),
                        (mt, "resolve_v1")]
        self.calls = {}
        self.active = None

    def __enter__(self):
        self.orig = {}
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.orig[(mod, name)] = fn

            def wrap(*args, _fn=fn, _name=name, **kw):
                if self.active is not None:
                    self.calls.setdefault((self.active, _name), []).append(
                        (args, kw))
                return _fn(*args, **kw)
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.orig.items():
            setattr(mod, name, fn)


def plain_versions():
    """Swap every kernel wrapper for its plain PyTorch version (the parity
    phases' reference runs); returns the undo function."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs

    def splat(local, data, film, groups, remaining=None):
        if remaining is None:
            return bs.splat_plain(local, data, film, groups)
        return bs.splat_capped_plain(local, data, film, groups, remaining)
    swaps = [(mt, "tile_order", tile_order_chain_plain),
             (mt, "trace_rol", mt.trace_rol_plain),
             (mt, "resolve_v5", mt.resolve_v5_plain),
             (bs, "splat", splat),
             (mt, "trace_rol_sc", mt.trace_rol_sc_plain),
             (mt, "resolve_v5s", mt.resolve_v5s_plain),
             (bs, "fetch", bs.fetch_plain),
             (mt, "trace_ros", mt.trace_ros_plain),
             (mt, "resolve_v1", mt.resolve_v1_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)

    def undo():
        for m, n, f in saved:
            setattr(m, n, f)
    return undo


SPIN_CYCLES = 2_000_000    # ~1 ms of GPU clock: longer than a launch


def time_ms(fn, reps=10, warm=2, spin=True):
    """Median ms of fn() on the card (CUDA events around each call). With
    ``spin`` a spin kernel queued before the first event keeps the card
    busy while the host launches fn, so the events bracket device time
    only; without it they also hold the host's launch latency."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, reps=10):
    """A kernel's device time (``ms``) and its time with the host launch
    (``ms_with_launch``)."""
    return dict(ms=time_ms(fn, reps), ms_with_launch=time_ms(fn, reps,
                                                             spin=False))


def bound(ops, nbytes):
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def trace_plain_chunked(plain, rays, tm, order, cons, *rest, chunk=256):
    """A trace kernel's plain version over all tiles, a chunk of tiles at a
    time (the tiles are independent; this bounds the [tiles, tc, rt]
    temporaries)."""
    import torch
    outs = [plain(rays[k:k + chunk], tm[k:k + chunk], order[k:k + chunk],
                  cons[k:k + chunk], *rest)
            for k in range(0, rays.shape[0], chunk)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def tile_order_chain_plain(rays, tm, boxes):
    """K1's plain version: the bounds of tile_order_plain sorted into the
    candidate lists by _candidate_order (order, skey)."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    return mt._candidate_order(mt.tile_order_plain(rays, tm, boxes))


def tile_order_diffs(got, ref):
    """Entries of K1's (order, skey) that differ from the plain version's,
    skey compared as int32 bits."""
    import torch
    return {what: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for what, a, b in zip(("order", "skey"), got, ref)}


def check_tile_order(mt, rec_calls):
    """K1 vs plain on every recorded call of segments 2 and 4: order and
    skey bit-equal to _candidate_order(tile_order_plain(...)). Returns the
    timing dict of segment 4's first call."""
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "tile_order")]:
            diff = tile_order_diffs(mt.tile_order(*args),
                                    tile_order_chain_plain(*args))
            if any(diff.values()):
                raise AssertionError(f"K1 differs from its plain version "
                                     f"(segment {seg}): {diff}")
    rays, tm, boxes = rec_calls[(4, "tile_order")][0][0]
    nt, _, rt = rays.shape
    ncl = boxes.shape[0]
    order, skey = mt.tile_order(rays, tm, boxes)
    b_ms, b_by = bound(nt * ncl * rt * 25,
                       nbytes(rays, tm, boxes, order, skey))
    return dict(
        max_abs_err=0.0, **kernel_ms(lambda: mt.tile_order(rays, tm, boxes)),
        plain_ms=time_ms(lambda: tile_order_chain_plain(rays, tm, boxes), 3,
                         1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        live_entries=int((order >= 0).sum()),
        octant_warps=octant_warps(rays, k1_rays_per_thread()),
        shape=f"{nt} tiles x {rt} rays x {ncl} boxes")


def k1_edge_inputs(ncl, nt, rt, seed):
    """numpy float32 rays [nt, 8, rt], tmax [nt, rt] and boxes [ncl, 8] of
    an edge-case K1 call, made from a numpy seed. Boxes in [-4, 6]^3, a
    tenth of their extents 0, a twentieth of their axes inverted (low
    plane above the high one), up to four of them the cube [-20, 20]^3,
    one more (where ncl > 1) the slab x in [2e30, 3e30].
    Rays from [-6, 6]^3 with normal directions; by lane, a direction
    component of +0, -0, +-inf, NaN or +-1e-40 (its inverse overflows),
    an origin component NaN, or an origin on a face of a box, pointing
    into it (it enters at tnear = -0.0); tmax 0, -1, +inf, NaN or in
    [0, 20]. Every other tile before the last three holds rays of one
    direction octant, as sorted tiles do (its zero and NaN components
    become +0 or -1e-40 by the octant's sign). The last tile is all
    culled (origins far outside, tmax -1); the one before has every
    origin inside the cubes (ties at 0.0) and a fifth of its lanes on box
    faces; the third from last looks along +x with tmax +inf, so all its
    rays enter the far slab past the 1e30 cull bound."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4.0, 4.0, (ncl, 3))
    ext = rng.uniform(0.0, 2.0, (ncl, 3))
    ext[rng.random((ncl, 3)) < 0.1] = 0.0
    ext[rng.random((ncl, 3)) < 0.05] *= -1.0
    boxes = np.zeros((ncl, 8))
    boxes[:, 0:3], boxes[:, 3:6] = lo, lo + ext
    boxes[:, 6], boxes[:, 7] = np.arange(ncl), 1.0
    pick = rng.permutation(ncl)
    big, far = pick[:4], pick[4:5] if ncl > 4 else pick[1:2]
    boxes[big, 0:3], boxes[big, 3:6] = -20.0, 20.0
    boxes[far, 0:3], boxes[far, 3:6] = (2e30, -1e36, -1e36), (3e30, 1e36, 1e36)
    boxes = boxes.astype(np.float32)
    n = nt * rt
    lane, axis = np.arange(n), rng.integers(0, 3, n)
    tiles = lane // rt
    octile = (tiles % 2 == 0) & (tiles < nt - 3)
    sgn = np.where(rng.random((nt, 3)) < 0.5, -1.0, 1.0)[tiles]
    o = rng.uniform(-6.0, 6.0, (n, 3))
    d = rng.normal(size=(n, 3))
    kind = rng.integers(0, 16, n)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40])
    pick = kind < len(special)
    d[lane[pick], axis[pick]] = special[kind[pick]]
    o[lane[kind == 7], axis[kind == 7]] = np.nan
    face = (kind == 8) | ((tiles == nt - 2) & (kind < 3))
    b = rng.integers(0, ncl, n)
    inside = boxes[b, 0:3] + rng.random((n, 3)) * (boxes[b, 3:6]
                                                   - boxes[b, 0:3])
    o[face] = inside[face]
    at_max = np.where(octile, sgn[lane, axis] < 0, rng.random(n) < 0.5)
    f_lo = boxes[b, axis].astype(np.float64)
    f_hi = boxes[b, axis + 3].astype(np.float64)
    o[lane[face], axis[face]] = np.where(at_max, f_hi, f_lo)[face]
    d[lane[face], axis[face]] = np.where(at_max, -1.0, 1.0)[face] * \
        np.abs(d[lane[face], axis[face]])
    dd = np.abs(d) * sgn
    bad = np.isnan(dd) | (dd == 0.0)       # -0.0's reciprocal is +1e30
    dd[bad] = np.where(sgn[bad] < 0, -1e-40, 0.0)
    d[octile] = dd[octile]
    tm = rng.uniform(0.0, 20.0, n)
    kind_t = rng.integers(0, 8, n)
    tm[kind_t == 0], tm[kind_t == 1] = 0.0, -1.0
    tm[kind_t == 2], tm[kind_t == 3] = np.inf, np.nan
    ties = tiles == nt - 2
    o[ties & ~face] = rng.uniform(-1.0, 1.0, (int((ties & ~face).sum()), 3))
    tm[ties] = np.inf
    beyond = tiles == nt - 3
    o[beyond] = rng.uniform(-1.0, 1.0, (int(beyond.sum()), 3))
    d[beyond] = np.stack([np.ones(int(beyond.sum())),
                          *rng.normal(0.0, 0.1, (2, int(beyond.sum())))], 1)
    tm[beyond] = np.inf
    culled = tiles == nt - 1
    o[culled], tm[culled] = 100.0, -1.0
    rays = np.zeros((nt, 8, rt), np.float32)
    rays[:, 0:3] = o.reshape(nt, rt, 3).transpose(0, 2, 1)
    rays[:, 3] = 1.0
    rays[:, 4:7] = d.reshape(nt, rt, 3).transpose(0, 2, 1)
    return rays, tm.astype(np.float32).reshape(nt, rt), boxes


def octant_warps(rays, rays_per_thread):
    """The share of K1's warps whose rays share one octant (the sign bits
    of their reciprocal directions), which take its octant path: thread t
    of a tile holds lanes t + k * threads, as csrc/tile_order.cu."""
    import torch
    nt, _, rt = rays.shape
    while rt % (32 * rays_per_thread):
        rays_per_thread //= 2
    threads = rt // rays_per_thread
    d = rays[:, 4:7]
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    neg = (inv.view(torch.int32) < 0).int()
    octs = neg[:, 0] | neg[:, 1] << 1 | neg[:, 2] << 2          # [nt, rt]
    lanes = (torch.arange(threads)[:, None] + torch.arange(
        rays_per_thread)[None, :] * threads).to(rays.device)
    warps = octs[:, lanes].reshape(nt, threads // 32, -1)
    return float((warps == warps[:, :, :1]).all(dim=2).float().mean())


def k1_rays_per_thread():
    """K1's RAYS_PER_THREAD as csrc/tile_order.cu sets it."""
    with open(os.path.join("fluctus_tpu_torch", "csrc", "tile_order.cu")) as f:
        return int(re.search(r"constexpr int RAYS_PER_THREAD = (\d+);",
                             f.read())[1])


# (boxes, tiles, rays per tile) of the synthetic K1 calls: one box, a
# count not a multiple of 8, luxball's cluster count, a tile that is not
# a multiple of 64 rays, and the wrapper's limit
K1_EDGE_CALLS = ((1, 16, 512), (13, 16, 512), (33, 64, 512), (33, 8, 96),
                 (4096, 4, 512))


def check_k1_synthetic(seed=5):
    """K1 on the calls of K1_EDGE_CALLS made by k1_edge_inputs, against
    its plain version bit for bit; one box past the limit must raise
    ValueError. Returns what each call held."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    out = []
    for k, (ncl, nt, rt) in enumerate(K1_EDGE_CALLS):
        rays, tm, boxes = (torch.from_numpy(a).cuda() for a in
                           k1_edge_inputs(ncl, nt, rt, seed + k))
        got = mt.tile_order(rays, tm, boxes)
        diff = tile_order_diffs(got, tile_order_chain_plain(rays, tm, boxes))
        skey = got[1]
        out.append(dict(boxes=ncl, tiles=nt, rays_per_tile=rt, differ=diff,
                        live=int((got[0] >= 0).sum()),
                        zero_keys=int((skey == 0.0).sum()),
                        negative_zero_keys=int(
                            (skey.view(torch.int32) == -2 ** 31).sum()),
                        culled_tiles=int((got[0][:, 0] < 0).sum()),
                        octant_warps=octant_warps(rays,
                                                  k1_rays_per_thread())))
        if any(diff.values()):
            raise AssertionError(f"K1 differs from its plain version on a "
                                 f"synthetic call: {out[-1]}")
    if not all(o["zero_keys"] and o["culled_tiles"] and
               0.0 < o["octant_warps"] < 1.0 for o in out):
        raise AssertionError(f"K1 synthetic calls lack ties at 0, culled "
                             f"tiles or warps of either path: {out}")
    rays, tm, boxes = (torch.from_numpy(a).cuda() for a in
                       k1_edge_inputs(mt.K1_MAX_BOXES + 1, 1, 512, seed))
    try:
        mt.tile_order(rays, tm, boxes)
    except ValueError:
        pass
    else:
        raise AssertionError("K1 took more boxes than its limit")
    return out


def trace_diffs(got, ref):
    """Values of a trace kernel's (t, i, visits) that differ from its plain
    version's, per output: t compared as int32 bits (NaN too), the columns
    and the visit counts as integers. All 0 for a kernel that agrees."""
    import torch
    out = {}
    for a, b, what in zip(got, ref, ("t", "columns", "visits")):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        out[what] = 0 if torch.equal(a, b) else int((a != b).sum())
    return out


def visit_stats(visits, tc, rt, ms):
    """Per-tile visit counts (p50, p99, max), and the (ray, triangle) pairs
    the visits sweep per second of kernel time ``ms``."""
    import torch
    v = visits.double()
    q = torch.quantile(v, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                       device=v.device))
    pairs = int(visits.sum()) * tc * rt
    return dict(visits_p50=float(q[0]), visits_p99=float(q[1]),
                visits_max=int(visits.max()), pairs=pairs,
                pairs_per_s=pairs / (ms / 1e3))


def check_trace(name, kernel, plain, rec_calls, chunk, segs=(2, 4),
                walk=None):
    """A trace kernel vs its plain version on every recorded call of the
    segments ``segs``: t (as bits), winner columns / verdicts and visit
    counts bit-equal. Returns (timing dict of the last segment's
    closest-hit call, with ``walk(args)``'s counters when given, and
    segment 2's closest-hit kernel output or None)."""
    calls, seg2 = [], None
    for seg in segs:
        for args, _ in rec_calls[(seg, name)]:
            got = kernel(*args)
            ref = trace_plain_chunked(plain, *args, chunk=chunk)
            diff = trace_diffs(got, ref)
            if any(diff.values()):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(segment {seg}, any_hit={args[-1]}): "
                                     f"{diff}")
            calls.append((seg, args, got[2]))
            if seg == 2 and not args[-1]:
                seg2 = got
    seg, args, visits = [c for c in calls if not c[1][-1]][-1]
    extra = walk(args) if walk else {}
    res = trace_timing(kernel, plain, args, visits, chunk,
                       f"closest-hit, rays of segment {seg}",
                       culls=extra.get("member_culls", 0))
    _, any_args, any_visits = [c for c in calls if c[1][-1]][-1]
    any_ms = time_ms(lambda: kernel(*any_args))
    res["any_hit"] = dict(ms=any_ms, **visit_stats(
        any_visits, any_args[-2], any_args[0].shape[2], any_ms))
    return dict(res, **extra), seg2


def sc_walk_counts(args, chunk=512):
    """Where K5's work goes on one call: per tile the live superclusters
    and the member culls (the slab tests of the members of each live
    supercluster) of the plain walk, trace_rol_sc_plain's loop counted."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    rays, tm, order, cons, t12, boxes, sc_box, tc, any_hit = args
    t12c = t12.view(12, boxes.shape[0], tc)
    lives, culls = [], []
    for k in range(0, rays.shape[0], chunk):
        st = mt._TraceState(rays[k:k + chunk], tm[k:k + chunk], tc)
        o, cn = order[k:k + chunk], cons[k:k + chunk]
        live_n = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
        cull_n = torch.zeros_like(live_n)
        n_slots = o.shape[1]
        stop = st.stop_at(o, cn, 0)
        for slot in range(n_slots):
            run = ~stop
            if not bool(run.any()):
                break
            s = o[:, slot].long()
            srow = sc_box[s.clamp_min(0)]
            live_sc = st.box_hit(srow, any_hit).any(dim=1) & (s >= 0) & run
            c0 = srow[:, 6].to(torch.int64)
            cnt = torch.where(live_sc, srow[:, 7].to(torch.int64), 0)
            live_n += live_sc
            cull_n += cnt
            for m in range(int(cnt.max())):
                c = c0 + m
                box = boxes[torch.where(m < cnt, c, 0)]
                live = (st.box_hit(box, any_hit).any(dim=1)
                        & (st.t_best.amax(dim=1) > 0.0) & (m < cnt))
                st.sweep(live, c, t12c, any_hit)
            stop = stop | st.stop_at(o, cn, min(slot + 1, n_slots - 1))
        lives.append(live_n)
        culls.append(cull_n)
    live_n, cull_n = torch.cat(lives).double(), torch.cat(culls).double()
    q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=o.device)
    ql, qc = torch.quantile(live_n, q), torch.quantile(cull_n, q)
    return dict(live_superclusters=int(live_n.sum()),
                live_superclusters_p50=float(ql[0]),
                live_superclusters_p99=float(ql[1]),
                live_superclusters_max=int(live_n.max()),
                member_culls=int(cull_n.sum()),
                member_culls_p50=float(qc[0]), member_culls_p99=float(qc[1]),
                member_culls_max=int(cull_n.max()))


def heavy_split(kernel, args, visits, frac=0.01):
    """A rays-on-lanes trace kernel's time on the heaviest ``frac`` of its
    tiles alone (by visits; args[:4] are per tile) and on the others alone:
    how far the chain of visits of the heaviest tiles bounds the launch."""
    import torch
    nt = args[0].shape[0]
    idx = torch.argsort(visits, descending=True, stable=True)
    k = max(1, int(nt * frac))
    out = dict(heavy_tiles=k, heavy_visits=int(visits[idx[:k]].sum()))
    for name, sel in (("heavy", idx[:k]), ("light", idx[k:])):
        sub = [a[sel].contiguous() for a in args[:4]] + list(args[4:])
        out[f"{name}_ms"] = time_ms(lambda: kernel(*sub))
    return out


def trace_timing(kernel, plain, args, visits, chunk, what, culls=0):
    """A trace kernel's time on one call (rays [nt, 8, rt] first, tc last
    but one), its bound (~30 operations per swept pair, ~20 per ray and
    member cull ``culls``), plain time, visit statistics and pair rate, and
    its time on its heaviest 1% of tiles alone and on the rest."""
    import torch
    rays, order, tc = args[0], args[2], args[-2]
    nt, _, rt = rays.shape
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nvis = int(visits.sum())
    b_ms, b_by = bound(nvis * tc * rt * 30 + culls * rt * 20,
                       nbytes(*tensors) + nt * rt * 8)
    times = kernel_ms(lambda: kernel(*args))
    return dict(
        max_abs_err=0.0, **times,
        plain_ms=time_ms(lambda: trace_plain_chunked(plain, *args,
                                                     chunk=chunk), 2, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        visited_clusters=nvis, member_culls=culls,
        **visit_stats(visits, tc, rt, times["ms"]),
        **heavy_split(kernel, args, visits),
        shape=f"{nt} tiles x {rt} rays x {order.shape[1]} candidates, "
              f"{what}")


def check_resolve(name, kernel, plain, rec_calls):
    """A resolve kernel vs its plain version on every recorded call of
    segments 2 and 4: integer rows equal, floats rtol 1e-6. Returns the
    timing dict of segment 4's call and its arguments."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    worst = 0.0
    ints = [mt.ATTR_MAT, mt.ATTR_TYPE, mt.ATTR_MAP_KD, mt.ATTR_MAP_KS,
            mt.ATTR_MAP_N, mt.ATTR_TRI]
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, name)]:
            got = kernel(*args)
            ref = plain(*args)
            if not torch.equal(got[ints], ref[ints]):
                raise AssertionError(f"{name} integer rows differ (segment "
                                     f"{seg})")
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)
            worst = max(worst, float((got - ref).abs().max()))
    args = rec_calls[(4, name)][0][0]
    col, o4, d4, b16r, t16r = args
    b = col.shape[0]
    safe = col.clamp_min(0)
    hit = col >= 0
    winners = int(torch.unique(col[hit]).numel())
    # each input read once: the column, the rays, every distinct winner's
    # B16 row and transform row; the [40, b] output written once
    b_ms, b_by = bound(b * 60, b * (4 + 32 + 160) + winners * (256 + 64))
    return dict(
        max_abs_err=worst, **kernel_ms(lambda: kernel(*args)),
        plain_ms=time_ms(lambda: plain(*args), 3, 1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.index_select(b16r, 0, safe)),
        library_call="torch.index_select of the winners' B16 rows",
        shape=f"{b} rays, {int(hit.sum())} hits, {winners} distinct "
              f"winners, table {b16r.shape[0]} rows"), args


def check_luxball_kernels(rec_calls, what):
    """K1-K4 vs their plain versions on the recorded calls of segments 2
    and 4 of a luxball path (``what`` names it): K1-K3 checked and timed
    by their helpers, K4 on all four channels bit for bit."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol"], _ = check_trace("trace_rol", mt.trace_rol,
                                      mt.trace_rol_plain, rec_calls, 256)
    res["resolve_v5"], _ = check_resolve("resolve_v5", mt.resolve_v5,
                                         mt.resolve_v5_plain, rec_calls)
    for seg in (2, 4):
        for args, kw in rec_calls[(seg, "splat")]:
            got = bs.splat(*args, **kw)
            ref = bs.splat_plain(*args, **kw)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K4 differs from its plain version "
                                     f"({what}, segment {seg})")
    return res


def phase_kernels(r, rec_calls):
    """Phase 2: every recorded kernel call vs its plain version."""
    res = check_luxball_kernels(rec_calls, "luxball")
    (local, data, film), kw = rec_calls[(4, "splat")][0]
    res["block_splat"] = dict(
        **splat_timing(local, data, film, kw["groups"]),
        synthetic=check_splat_synthetic(capped=False))
    res["tile_order"]["synthetic"] = check_k1_synthetic()
    return res


def splat_timing(local, data, film, g):
    """K4 on one call: its time, its plain version's, its byte bound (each
    input read once, the film written once) and Tensor.index_add_ of the
    same records into the flattened film."""
    import torch
    from fluctus_tpu_torch.core import block_splat as bs
    c, n = data.shape
    s = n // g
    pk = film.shape[1] // g
    lane = torch.arange(n, device=local.device, dtype=torch.int32)
    dump = torch.full_like(local, g * pk)

    def library():
        pid = torch.where(local >= 0, (lane // s) * pk + local, dump)
        acc = torch.zeros((c, g * pk + 1), device=film.device)
        return film + acc.index_add_(1, pid, data)[:, :g * pk]
    b_ms, b_by = bound(n * c, nbytes(local, data) + 2 * nbytes(film))
    return dict(
        max_abs_err=0.0, **kernel_ms(lambda: bs.splat(local, data, film,
                                                          groups=g)),
        plain_ms=time_ms(lambda: bs.splat_plain(local, data, film, g), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        library_call="Tensor.index_add_ on the flattened film",
        shape=f"{c} channels, {g} groups x {s} lanes, Pk={pk}, "
              f"{int((local >= 0).sum())} splats")


def phase_kernels_large(r, rec_calls):
    """Phase 2b: the large path's recorded K1 (over superclusters), K5 and
    K6 calls vs their plain versions; K3 timed on K6's inputs. Returns
    (results, primary-hit share of segment 2's camera rays)."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol_sc"], seg2 = check_trace(
        "trace_rol_sc", mt.trace_rol_sc, mt.trace_rol_sc_plain, rec_calls,
        512, walk=sc_walk_counts)
    res["resolve_v5s"], args = check_resolve(
        "resolve_v5s", mt.resolve_v5s, mt.resolve_v5s_plain, rec_calls)
    res["resolve_v5_on_large"] = dict(
        ms=time_ms(lambda: mt.resolve_v5(*args)),
        shape=res["resolve_v5s"]["shape"])
    # segment 2 traces the camera rays of every lane (segment 1 gives each
    # pre-birth lane its first camera ray)
    return res, float((seg2[1] >= 0).float().mean())


class LastCalls:
    """Keep the arguments of the last ``keep`` calls of ``mod.name``, its
    keyword arguments' values after the positional ones (the wrapper runs
    as usual)."""

    def __init__(self, mod, name, keep=2):
        self.mod, self.name, self.keep = mod, name, keep
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def rec(*args, **kw):
            self.calls = (self.calls + [args + tuple(kw.values())])[
                -self.keep:]
            return self.orig(*args, **kw)
        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


# ---------------------------------------------------------------------------
# Phase 7: K2, K5 and K9 on edge-case tiles
# ---------------------------------------------------------------------------

def edge_rays(sc, nt, seed, rt=512):
    """[nt * rt, 4] rays (o4, d4) and tmax of edge-case tiles, made from a
    numpy seed in the tables' (centred) frame: rays from above and around
    the scene toward random points of its bounds; a tenth each with a
    direction component of exactly 0, with the origin on a triangle's plane
    (oz = 0 up to rounding), or parallel to a triangle (dz = 0 up to
    rounding); tmax +inf on half the lanes. The last three tiles: rays
    that look up from above the scene (the candidate list ends at once),
    tmax 0 everywhere (the tile stops at once), and every origin on a
    triangle's plane with tmax +inf."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n = nt * rt
    lo, hi = sc.lo.double().cpu().numpy(), sc.hi.double().cpu().numpy()
    span = hi - lo
    target = lo + rng.random((n, 3)) * span
    orig = lo + (rng.random((n, 3)) * 1.6 - 0.3) * span
    orig[:, 1] = hi[1] + rng.random(n) * span[1]
    # triangles' planes from their transforms: M p + b = (u, v, 0)
    rows = torch.nonzero(sc.tri_map >= 0)[:, 0]
    pick = rows[torch.from_numpy(rng.integers(0, rows.numel(), n)).to(
        rows.device)]
    T = sc.t12[:, pick].double().cpu().numpy().T          # [n, 12]
    M = T[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(n, 3, 3)
    b = T[:, [3, 7, 11]]
    uv0 = np.stack([rng.random(n) * 0.5, rng.random(n) * 0.5,
                    np.zeros(n)], 1)
    on_plane = np.linalg.solve(M, (uv0 - b)[..., None])[..., 0]
    nrm = M[:, 2]                                          # dz = d . nrm
    d = target - orig
    kind = rng.integers(0, 10, n)
    zero = kind == 0
    d[zero, rng.integers(0, 3, int(zero.sum()))] = 0.0
    plane = kind == 1
    orig[plane] = on_plane[plane]
    par = kind == 2
    d[par] = np.cross(nrm[par], rng.normal(size=(int(par.sum()), 3)))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    tm = np.where(rng.random(n) < 0.5, np.inf,
                  rng.random(n) * span.max() * 2.0)
    up, zero_t, inf_plane = (slice(k * rt, (k + 1) * rt)
                             for k in (nt - 3, nt - 2, nt - 1))
    orig[up] = target[up] + [0.0, 2.0 * span[1], 0.0]
    d[up] = [0.0, 1.0, 0.0]
    tm[zero_t] = 0.0
    orig[inf_plane] = on_plane[inf_plane]
    tm[inf_plane] = np.inf
    o4 = np.concatenate([orig, np.ones((n, 1))], 1).astype(np.float32)
    d4 = np.concatenate([d, np.zeros((n, 1))], 1).astype(np.float32)
    dev = sc.t12.device
    return (torch.from_numpy(o4).to(dev), torch.from_numpy(d4).to(dev),
            torch.from_numpy(tm.astype(np.float32)).to(dev)[:, None])


def synthetic_supers(sc):
    """An sc_box that cuts the clusters into a supercluster of 1 member,
    then superclusters of 64 (SC_CLUSTERS) and the remainder, boxes the
    union of their members'."""
    import torch
    ncl = sc.n_clusters
    cuts = [0] + list(range(1, ncl, 64)) + [ncl]
    box = sc.cluster_box
    out = torch.zeros((len(cuts) - 1, 8), device=box.device)
    for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        out[s, 0:3] = box[a:b, 0:3].amin(0)
        out[s, 3:6] = box[a:b, 3:6].amax(0)
        out[s, 6], out[s, 7] = a, b - a
    return out


def check_edges(sc, scene, seed, nt=64):
    """Phase 7 on one scene's tables: K2 (on the clusters' list), K9 (the
    same list, from tx/ty/tz, or t12's rows on slim tables) and K5 (on the
    scene's superclusters and on synthetic ones of 1 and 64 members)
    against their plain versions on edge-case tiles, closest-hit and
    any-hit, t / columns / visits bit for bit."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    rt = mt.ROL_TILE
    o4, d4, tmax = edge_rays(sc, nt, seed, rt)
    rays = mt._pack_rays(o4, d4, rt)
    tm = tmax.reshape(nt, rt).contiguous()
    tc = sc.cluster_size
    txyz = ((sc.tx, sc.ty, sc.tz) if sc.tx is not None else
            tuple(sc.t12[k:k + 4] for k in (0, 4, 8)))
    order, cons = mt.tile_order(rays, tm, sc.cluster_box)
    supers = {"scene": sc.sc_box, "synthetic": synthetic_supers(sc)}
    counts = {k: v[:, 7].long().tolist() for k, v in supers.items()}
    out = dict(scene=scene, tiles=nt, rays=nt * rt, seed=seed,
               supercluster_members=counts,
               lists_ending_at_once=int((order[:, 0] < 0).sum()))
    for any_hit in (False, True):
        mode = "any_hit" if any_hit else "closest"
        args = (o4, d4, tmax, order, cons, *txyz, sc.cluster_box,
                sc.n_clusters, tc, any_hit)
        got = mt.trace_ros(*args)
        diff = trace_diffs(got, ros_plain_chunked(args))
        out[f"trace_ros_{mode}"] = dict(differ=diff,
                                        visits=int(got[2].sum()),
                                        hits=int((got[1] >= 0).sum()))
        kargs = (rays, tm, order, cons, sc.t12, sc.cluster_box,
                 sc.n_clusters, tc, any_hit)
        got = mt.trace_rol(*kargs)
        diff = trace_diffs(got, trace_plain_chunked(mt.trace_rol_plain,
                                                    *kargs, chunk=256))
        out[f"trace_rol_{mode}"] = dict(differ=diff,
                                        visits=int(got[2].sum()),
                                        hits=int((got[1] >= 0).sum()))
        for name, sb in supers.items():
            so, sn = mt.tile_order(rays, tm, sb)
            # the first two tiles walk the 1-member supercluster first, the
            # next two the synthetic 64-member one (or the scene's largest)
            one = int(torch.argmin(sb[:, 7]))
            big = int(torch.argmax(sb[:, 7]))
            for t_, s_ in ((0, one), (1, one), (2, big), (3, big)):
                rest = [x for x in so[t_].tolist() if x not in (s_, -1)]
                so[t_] = torch.tensor([s_] + rest + [-1] * (
                    so.shape[1] - 1 - len(rest)), dtype=torch.int32)
                sn[t_, 0] = 0.0
            kargs = (rays, tm, so, sn, sc.t12, sc.cluster_box, sb, tc,
                     any_hit)
            got = mt.trace_rol_sc(*kargs)
            diff = trace_diffs(got, trace_plain_chunked(
                mt.trace_rol_sc_plain, *kargs, chunk=512))
            out[f"trace_rol_sc_{mode}_{name}"] = dict(
                differ=diff, visits=int(got[2].sum()),
                hits=int((got[1] >= 0).sum()))
    emit(dict(phase="edge_tiles", **out))
    bad = {k: v["differ"] for k, v in out.items()
           if isinstance(v, dict) and any(v.get("differ", {}).values())}
    if bad:
        raise AssertionError(f"edge tiles: K2/K5/K9 differ from their "
                             f"plain versions on {scene}: {bad}")
    return out


def phase_main(r, card, scene, segments, per_segment, extra=None):
    """Phase 3 / 3b: a main path at 1080p with 1M paths."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    r.init_wavefront(1 << 20)
    r.render_wavefront(2)
    r.init_wavefront(1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_counts()
    t0 = time.perf_counter()
    r.render_wavefront(segments)          # ends in torch.cuda.synchronize
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kb.KERNELS.values()}
    plain = {k.name: k.plain_runs for k in kb.KERNELS.values()}
    k4_widths = dict(kb.KERNELS["block_splat"].launches_by)
    st = r.wavefront_stats()
    rays = st.primary_rays + st.extension_rays + st.shadow_rays
    film = r.wavefront_film()
    finite = bool(torch.isfinite(film.color.x).all()
                  and torch.isfinite(film.color.y).all()
                  and torch.isfinite(film.color.z).all())
    covered = float((film.weight > 0).float().mean())
    image_mean = float(r.ldr_image().mean())
    out = dict(phase="main_path", scene=scene, width=r.width,
               height=r.height, paths=1 << 20, segments=segments,
               seconds=elapsed, mrays_per_s=rays / elapsed / 1e6,
               ms_per_segment=elapsed / segments * 1e3,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               rays=dict(primary=st.primary_rays,
                         extension=st.extension_rays,
                         shadow=st.shadow_rays, samples=st.samples),
               launches=launches, plain_runs=plain,
               k4_launches_by_channels=k4_widths, film_finite=finite,
               pixels_covered=covered, image_mean=image_mean, card=card,
               **(extra or {}))
    emit(out)
    for name, per in per_segment.items():
        if launches.get(name) != per * segments:
            raise AssertionError(f"{name}: {launches.get(name)} launches, "
                                 f"expected {per * segments}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    if not finite or covered < 0.99:
        raise AssertionError(f"film check failed: finite={finite}, "
                             f"covered={covered}")
    return launches, out


def profile_segments(r, card, ms_per_segment, n=2, run=None,
                     unit="segment"):
    """Device time by kernel over n more segments (torch.profiler, CUPTI),
    or over the segments (or mk samples, ``unit``) ``run()`` advances (it
    returns their count): where a segment's time goes (returned as well
    as printed). The busy share divides the device time per segment by the timed run's unprofiled wall time per segment; the
    profiled segments' own wall time (profiler overhead included) stands
    beside it, since later segments of a pool can cost more than the
    timed run's average. The kernels' own launch counts over the same
    segments stand beside the profiler's call counts, which show any
    events the profiler lost; ``device_launches_per_segment`` counts every
    device operation (kernels, copies, fills) the profiler saw;
    ``index_add_us_per_segment`` the device time of Tensor.index_add_'s
    kernels (the flat ring's film scatter)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fluctus_tpu_torch import kernel_build as kb
    torch.cuda.synchronize()
    kb.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            r.render_wavefront(n)
        else:
            n = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    launches = {k.name: k.launches / n for k in kb.KERNELS.values()
                if k.launches}
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0) or 0
        if dt > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    dev_ms = sum(dt for dt, _, _ in rows) / n / 1e3
    ours = {}                   # the port's kernels, by csrc function name
    for dt, key, _ in rows:
        m = re.search(r"(?:^|\s)(\w+)_kernel[<(]", key)
        if m and m.group(1) in kb.KERNELS:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + dt / n
    index_add = sum(dt for dt, key, _ in rows if re.search(INDEX_ADD, key))
    out = dict(phase="profile", segments=n, unit=unit, card=card,
               device_ms_per_segment=dev_ms,
               device_launches_per_segment=sum(c for _, _, c in rows) / n,
               device_busy_share=dev_ms / ms_per_segment,
               profiled_wall_ms_per_segment=wall_ms,
               launches_per_segment=launches,
               kernels_us_per_segment=ours,
               index_add_us_per_segment=index_add / n,
               index_add_share=index_add / n / 1e3 / dev_ms,
               top=[dict(name=k[:90], us_per_segment=dt / n,
                         calls_per_segment=c / n)
                    for dt, k, c in rows[:14]])
    emit(out)
    return out


def phase_parity(scene=LUXBALL, width=256, height=144, paths=1 << 16,
                 device="cuda", data_dir=None, exact=False, env_map=None,
                 area_light=True, fast_env=True, switches=None, flat=False):
    """Phase 4 / 4b / 8c / 9d / 11e / 13a: 4 segments through the kernels and
    through the plain versions on the card, from the same reset (both
    loads from ``data_dir`` when given, else each from a fresh one), with
    the env map file ``env_map`` on its fast route or (``fast_env`` False)
    its bilinear + alias route, the area light unless ``area_light`` is
    False, and the Settings fields of ``switches`` set. With ``exact`` the
    films and per-pixel spp must be equal. With ``flat`` both runs must be
    on the flat pixel ring, with the integer state and the film weights
    equal and the rgb within FLAT_RTOL / FLAT_ATOL (its scatter adds in no
    fixed order on the card). Returns the printed object."""
    import torch
    runs = []
    for use_plain in (False, True):
        undo = plain_versions() if use_plain else (lambda: None)
        try:
            r = make_renderer(width, height, device, scene, data_dir,
                              env_map, area_light, switches)
            r.config = r.config.replace(fast_env=fast_env)
            r.init_wavefront(paths)
            r.render_wavefront(4)
            runs.append((r._wf_state, r.wavefront_stats(),
                         r._wf_cfg.block_ring))
        finally:
            undo()
    (a, sa, ring_a), (b, sb, ring_b) = runs
    out = dict(phase="parity", scene=scene, width=width, height=height,
               paths=paths, b16_tables=r.device_scene.mxu.b16r is not None,
               env_map=env_map, use_env_map=r.config.use_env_map,
               fast_env=fast_env, use_area_light=r.config.use_area_light,
               switches=switches or {}, segments=4,
               block_ring=[ring_a, ring_b],
               counters_kernel=list(sa), counters_plain=list(sb))
    for name in ("pixel_index", "seed", "path_len"):
        frac = float((getattr(a.pool, name) == getattr(b.pool, name))
                     .float().mean())
        out[f"{name}_equal"] = frac
        if frac < 0.999:
            emit(out)
            raise AssertionError(f"parity: {name} equal on {frac}")
    fa = torch.stack([*a.film.color, a.film.weight])
    fb = torch.stack([*b.film.color, b.film.weight])
    out["film_max_abs_err"] = float((fa - fb).abs().max())
    out["film_equal"] = bool(torch.equal(fa, fb))
    out["weights_equal"] = bool(torch.equal(a.film.weight, b.film.weight))
    out["spp_equal"] = bool(torch.equal(a.spp, b.spp))
    emit(out)
    if sa != sb:
        raise AssertionError(f"parity: counters {sa} != {sb}")
    torch.testing.assert_close(fa, fb, rtol=1e-4, atol=1e-6)
    if flat:
        if ring_a or ring_b or not out["weights_equal"] or min(
                out[f"{k}_equal"] for k in ("pixel_index", "seed",
                                            "path_len")) < 1.0:
            raise AssertionError(f"flat parity failed: {out}")
        torch.testing.assert_close(fa[:3], fb[:3], rtol=FLAT_RTOL,
                                   atol=FLAT_ATOL)
    if exact and not (out["film_equal"] and out["spp_equal"]):
        raise AssertionError("parity: film or spp differ")
    return out

# ---------------------------------------------------------------------------
# Phase 5: exact-spp rendering (K7, K8)
# ---------------------------------------------------------------------------

def _candidate_pids(local, groups, pk):
    """Padded pixel id of each splat candidate (local >= 0), else the
    dump id groups * pk."""
    import torch
    n = local.shape[0]
    lane = torch.arange(n, device=local.device, dtype=torch.int64)
    pid = (lane // (n // groups)) * pk + local.long()
    return torch.where(local >= 0, pid, groups * pk)


class ExactRecorder:
    """Record the capped splat's and the fetch's arguments of segment 2 and
    of the last segment in which some pixel had more candidates than its
    remaining budget, and with ``keep_free`` the arguments of every
    uncapped splat (the denoiser's features through K4); the wrappers run
    as usual."""

    def __init__(self, keep_free=False):
        self.seg = 0
        self.fetch_args = None
        self.early = self.tail = None
        self.keep_free = keep_free
        self.free = []

    def __enter__(self):
        from fluctus_tpu_torch.core import block_splat as bs
        self.bs = bs
        self.orig = (bs.splat, bs.fetch)
        splat, fetch = self.orig

        def rec_fetch(local, table, groups):
            self.fetch_args = (local, table, groups)
            return fetch(local, table, groups)

        def rec_splat(local, data, film, groups, remaining=None):
            if remaining is None and self.keep_free:
                self.free.append((self.seg, (local, data, film, groups)))
            if remaining is not None:
                self.seg += 1
                rec = (self.seg, (local, data, film, groups, remaining),
                       self.fetch_args)
                if self.seg == 2:
                    self.early = rec
                elif self._binds(local, groups, film.shape[1] // groups,
                                 remaining):
                    self.tail = rec
            return splat(local, data, film, groups, remaining=remaining)
        bs.splat, bs.fetch = rec_splat, rec_fetch
        return self

    @staticmethod
    def _binds(local, groups, pk, remaining):
        import torch
        pid = _candidate_pids(local, groups, pk)
        count = torch.bincount(pid, minlength=groups * pk + 1)[:-1]
        return bool((count > remaining[0]).any())

    def __exit__(self, *exc):
        self.bs.splat, self.bs.fetch = self.orig


def check_exact_kernels(rec):
    """K7 and K8 vs their plain versions on the recorded calls: K7's film
    bit-equal, each pixel's weight delta = min(candidates, remaining); K8
    bit-equal. Returns (K7 timing dict, K8 timing dict)."""
    import torch
    from fluctus_tpu_torch.core import block_splat as bs
    segs = {}
    for seg, (local, data, film, g, rem), fargs in (rec.early, rec.tail):
        got = bs.splat(local, data, film, groups=g, remaining=rem)
        ref = bs.splat_capped_plain(local, data, film, g, rem)
        if not torch.equal(got, ref):
            raise AssertionError(f"K7 differs from its plain version "
                                 f"(segment {seg})")
        pk = film.shape[1] // g
        pid = _candidate_pids(local, g, pk)
        count = torch.bincount(pid, minlength=g * pk + 1)[:-1].float()
        if not torch.equal(got[3] - film[3], torch.minimum(count, rem[0])):
            raise AssertionError(f"K7 admitted set wrong (segment {seg})")
        if not torch.equal(bs.fetch(*fargs), bs.fetch_plain(*fargs)):
            raise AssertionError(f"K8 differs from its plain version "
                                 f"(segment {seg})")
        segs[seg] = dict(candidates=int((local >= 0).sum()),
                          over_budget_pixels=int((count > rem[0]).sum()))
    (seg, (local, data, film, g, rem), fargs) = rec.early
    c, n = data.shape
    pk = film.shape[1] // g
    pid = _candidate_pids(local, g, pk)
    # the admitted records, for the library yardstick: rank within the
    # pixel by a stable sort, admitted while rank < remaining
    _, order = torch.sort(pid, stable=True)
    sp = pid[order]
    pos = torch.arange(n, device=pid.device)
    start = torch.where(torch.cat([sp.new_ones(1, dtype=torch.bool),
                                   sp[1:] != sp[:-1]]), pos, 0)
    rank = torch.empty_like(pos)
    rank[order] = pos - torch.cummax(start, 0).values
    rem_ext = torch.cat([rem[0], rem.new_zeros(1)])
    ok = rank.float() < rem_ext[pid]
    pid_ok = torch.where(ok, pid, g * pk)

    def library():
        acc = torch.zeros((c, g * pk + 1), device=film.device)
        return film + acc.index_add_(1, pid_ok, data)[:, :g * pk]
    if not torch.equal(library()[3], bs.splat_capped_plain(
            local, data, film, g, rem)[3]):
        raise AssertionError("K7 yardstick admits another set")
    b7 = bound(n * c, nbytes(local, data, rem) + 2 * nbytes(film))
    k7 = dict(max_abs_err=0.0,
              **kernel_ms(lambda: bs.splat(local, data, film, groups=g,
                                              remaining=rem)),
              plain_ms=time_ms(lambda: bs.splat_capped_plain(
                  local, data, film, g, rem), 3, 1),
              bound_ms=b7[0], bound_by=b7[1], library_ms=time_ms(library),
              library_call="Tensor.index_add_ of the admitted records "
                           "(the admission has no one-call equivalent)",
              shape=f"{g} groups x {n // g} lanes, Pk={pk}",
              segments=segs)
    flocal, table, fg = fargs
    fpid = (torch.arange(n, device=flocal.device) // (n // fg)) * pk \
        + flocal.long()
    nread = int(torch.unique(fpid).numel())
    b8 = bound(n, nbytes(flocal) + n * 4 + nread * 4)
    # beside the bound: the 32-byte sectors the reads and writes touch
    ok = (flocal >= 0) & (flocal < pk)
    table_sectors = int(torch.unique(fpid[ok] * 4 // 32).numel())
    lane_sectors = 2 * -(-n * 4 // 32)          # local read, out written
    sector_bytes = 32 * (table_sectors + lane_sectors)
    k8 = dict(max_abs_err=0.0,
              **kernel_ms(lambda: bs.fetch(flocal, table, groups=fg)),
              plain_ms=time_ms(lambda: bs.fetch_plain(flocal, table, fg)),
              bound_ms=b8[0], bound_by=b8[1],
              library_ms=time_ms(lambda: torch.take(table, fpid)),
              library_call="torch.take of the table at the lanes' pixels",
              sectors=dict(table=table_sectors, lanes=lane_sectors,
                           bytes=sector_bytes,
                           ms_at_peak=sector_bytes / PEAK_BYTES * 1e3),
              shape=f"{n} lanes, {nread} distinct pixels read")
    return k7, k8


def check_splat_synthetic(capped, groups=4096, s=256, pk=512, seed=9,
                          channels=4):
    """K7 (``capped``) or K4 on one synthetic call of the main path's
    shape (K4 also with the 8 channels of the denoiser's guide features),
    made from a numpy seed, against its plain version bit for bit:
    groups in turn with every lane on one pixel, every lane on its own
    pixel, a third of the lanes empty (-1) and the rest on 5 pixels, every
    lane empty, or lanes on 40 random pixels; for K7 each pixel's budget
    one of 0, 1, 2.5, 255, 1e30 and NaN; data and film normal, with some
    -0.0 data. Returns the counts it was checked on."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.core import block_splat as bs
    rng = np.random.default_rng(seed)
    layout = np.arange(groups) % 5
    local = rng.integers(0, 40, (groups, s))
    one = layout == 0
    local[one] = rng.integers(0, pk, (int(one.sum()), 1))
    own = layout == 1
    local[own] = np.argsort(rng.random((int(own.sum()), pk)), axis=1)[:, :s]
    few = layout == 2
    local[few] = rng.integers(0, 5, (int(few.sum()), s))
    local[few[:, None] & (rng.random((groups, s)) < 1 / 3)] = -1
    local[layout == 3] = -1
    budgets = np.array([0.0, 1.0, 2.5, 255.0, 1e30, np.nan], np.float32)
    rem = budgets[rng.integers(0, len(budgets), groups * pk)][None]
    data = rng.normal(size=(channels, groups * s)).astype(np.float32)
    data[rng.random(data.shape) < 0.05] = -0.0
    film = rng.normal(size=(channels, groups * pk)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (local.reshape(-1).astype(np.int32), data, film, rem)]
    local_t, data_t, film_t, rem_t = args
    if capped:
        got = bs.splat(local_t, data_t, film_t, groups=groups,
                       remaining=rem_t)
        ref = bs.splat_capped_plain(local_t, data_t, film_t, groups, rem_t)
    else:
        got = bs.splat(local_t, data_t, film_t, groups=groups)
        ref = bs.splat_plain(local_t, data_t, film_t, groups)
    differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    out = dict(differ=differ, candidates=int((local >= 0).sum()),
               pixels_changed=int((got != film_t).any(0).sum()),
               shape=f"{channels} channels, {groups} groups x {s} lanes, "
                     f"Pk={pk}", seed=seed)
    if differ:
        raise AssertionError(f"{'K7' if capped else 'K4'} differs from its "
                             f"plain version on the synthetic call: {out}")
    return out


def check_launches(launches, plain, per, units, what):
    for name, k in per.items():
        if launches.get(name) != k * units:
            raise AssertionError(f"{what}: {name} {launches.get(name)} "
                                 f"launches, expected {k * units}")
    if any(plain.values()):
        raise AssertionError(f"{what}: a plain version ran: {plain}")


def counts():
    from fluctus_tpu_torch import kernel_build as kb
    return ({k.name: k.launches for k in kb.KERNELS.values()},
            {k.name: k.plain_runs for k in kb.KERNELS.values()})


def phase_exact(r, card):
    """Phase 5a/5b on a 1080p luxball renderer with a 1M-path pool.
    Returns (kernel results, K7/K8 launches of the timed render, the
    exact image's mean, the timed render's line)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import _block_geom, unpad_pixels
    r.reset()
    with ExactRecorder() as rec:
        r.render_single(EXACT_SPP)
    k7, k8 = check_exact_kernels(rec)
    k7["synthetic"] = check_splat_synthetic(capped=True)
    emit(dict(phase="exact_kernels_vs_plain", card=card,
              early_segment=rec.early[0], tail_segment=rec.tail[0],
              segments=rec.seg, block_splat_capped=k7, fetch=k8))

    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single(EXACT_SPP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, plain = counts()
    segments = len(r._wf_counters)
    st = r.stats
    mrays = r.perf_mrays(elapsed)
    state = r._wf_state
    spp = unpad_pixels(state.spp, r.config)
    dead_w = state.film.weight[state.spp >= (1 << 29)]
    # padded slots by the block geometry; the first slot of a group that
    # owns no true pixel is not parked dead, by the reference's wf_reset,
    # so its ring renders it like a pixel (a "phantom" slot)
    p_true, pk = _block_geom(r.config)
    slot = torch.arange(state.spp.numel(), device=state.spp.device)
    padded = (slot % pk) >= (r.config.num_pixels
                             - (slot // pk) * p_true).clamp(0, p_true)
    phantom = padded & (state.spp < (1 << 29))
    exact = bool((spp == EXACT_SPP).all() and (film.weight == EXACT_SPP).all()
                 and (dead_w == 0).all())
    mean = float(r.hdr_image().mean())
    out = dict(phase="exact_path", scene=LUXBALL, width=r.width,
               height=r.height, paths=r.settings.wf_buffer_size,
               spp=EXACT_SPP,
               seconds=elapsed, segments=segments,
               mrays_per_s=mrays["total"], samples_per_s=st.samples / elapsed,
               rays=st._asdict(), launches=launches, plain_runs=plain,
               spp_and_weight_exact=exact, padded_slots=int(padded.sum()),
               parked_slots=int(dead_w.numel()),
               phantom_slots=int(phantom.sum()),
               phantom_weights=torch.unique(
                   state.film.weight[phantom]).tolist(),
               image_mean=mean, tonemapped_mean=float(r.ldr_image().mean()),
               card=card)
    emit(out)
    check_launches(launches, plain, PER_SEGMENT_EXACT, segments,
                   "exact path")
    if not exact:
        raise AssertionError("exact path: spp/weight differ from the target")

    def accumulate():
        r.render_single(EXACT_SPP)
        return len(r._wf_counters)
    # the second render runs under the profiler
    profile_segments(r, card, elapsed / segments * 1e3, run=accumulate)
    film = r.film
    again = len(r._wf_counters)
    spp = unpad_pixels(r._wf_state.spp, r.config)
    acc = bool((spp == 2 * EXACT_SPP).all()
               and (film.weight == 2 * EXACT_SPP).all())
    r.render_wavefront(2)
    reinit = (r._wf_cfg.max_spp == 0 and not r._wf_exact_mode
              and float(r.current_film().weight.sum()) > 0)
    emit(dict(phase="exact_accumulate", segments=again,
              wavefront_segments=len(r._wf_counters), accumulated_exact=acc,
              wavefront_reinit=reinit, card=card))
    if not (acc and reinit):
        raise AssertionError(f"exact path: accumulate {acc}, re-init "
                             f"{reinit}")
    return dict(block_splat_capped=k7, fetch=k8), launches, mean, out


def phase_exact_parity(width=256, height=144, paths=1 << 16, spp=4):
    """Phase 5c: render_single(spp) through the kernels and, from the same
    reset, through the plain versions."""
    import torch
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    runs = []
    for use_plain in (False, True):
        undo = plain_versions() if use_plain else (lambda: None)
        try:
            r = make_renderer(width, height, "cuda")
            r.settings.wf_buffer_size = paths
            film = r.render_single(spp)
            runs.append((film, unpad_pixels(r._wf_state.spp, r.config),
                         r.stats))
        finally:
            undo()
    (fa, sa, ca), (fb, sb, cb) = runs
    ma = torch.stack([*fa.color, fa.weight])
    mb = torch.stack([*fb.color, fb.weight])
    out = dict(phase="exact_parity", width=width, height=height,
               paths=paths, spp=spp, stats_kernel=list(ca),
               stats_plain=list(cb), spp_equal=bool(torch.equal(sa, sb)),
               film_equal=bool(torch.equal(ma, mb)),
               film_max_abs_err=float((ma - mb).abs().max()))
    emit(out)
    if not (out["spp_equal"] and out["film_equal"] and ca == cb
            and bool((sa == spp).all())):
        raise AssertionError("exact parity failed")


# ---------------------------------------------------------------------------
# Phase 6: the microkernel megastep and the rays-on-sublanes trace (K9)
# ---------------------------------------------------------------------------

class RosRecorder:
    """Record the arguments of the calls number ``keep`` (counted from 0;
    per bounce the extension trace, then the shadow trace) of a trace
    kernel's wrapper: K9's, or ``name``'s."""

    def __init__(self, keep, name="trace_ros"):
        self.keep = keep
        self.name = name
        self.n = 0
        self.calls = {}

    def __enter__(self):
        from fluctus_tpu_torch.accel import mxu_trace as mt
        self.mt = mt
        self.orig = getattr(mt, self.name)

        def rec(*args):
            if self.n in self.keep:
                self.calls[self.n] = args
            self.n += 1
            return self.orig(*args)
        setattr(mt, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mt, self.name, self.orig)


def ros_plain_chunked(args, chunk=256):
    """trace_ros_plain over all tiles, a chunk of tiles at a time."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    o4, d4, tm, order, cons = args[:5]
    rt = o4.shape[0] // order.shape[0]
    outs = []
    for k in range(0, order.shape[0], chunk):
        sl = slice(k * rt, (k + chunk) * rt)
        outs.append(mt.trace_ros_plain(o4[sl], d4[sl], tm[sl],
                                       order[k:k + chunk],
                                       cons[k:k + chunk], *args[5:]))
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def check_ros(r, calls):
    """K9 vs its plain version on the recorded calls (columns, t and visit
    counts bit-equal); timing of the closest-hit call, and K2 on the same
    rays as the sorted single-set trace hands them to it."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    res, per_tile = {}, {}
    for idx, args in sorted(calls.items()):
        got = mt.trace_ros(*args)
        diff = trace_diffs(got, ros_plain_chunked(args))
        if any(diff.values()):
            raise AssertionError(f"K9 differs from the plain version (call "
                                 f"{idx}, any_hit={bool(args[-1])}): {diff}")
        res[idx] = dict(any_hit=bool(args[-1]),
                        visits=int(got[2].sum()),
                        hits=int((got[1] >= 0).sum()))
        per_tile[idx] = got[2]
    args = calls[min(calls)]                    # closest-hit
    o4, d4, tm, order = args[:4]
    tc = args[-2]
    nt, rt = order.shape[0], o4.shape[0] // order.shape[0]
    visits = res[min(calls)]["visits"]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    b_ms, b_by = bound(visits * tc * rt * 30, nbytes(*tensors) + nt * rt * 8)
    times = kernel_ms(lambda: mt.trace_ros(*args), 5)
    any_args = calls[max(calls)]
    any_ms = time_ms(lambda: mt.trace_ros(*any_args), 5)
    # K2 on the same rays, sorted as _sorted_trace sorts them
    rec = Recorder()
    rec.targets = [(mt, "trace_rol")]
    with rec:
        rec.active = 0
        scene = r.device_scene.mxu
        mt._sorted_trace(o4, d4, None, scene, False)
    k2_args = rec.calls[(0, "trace_rol")][0][0]
    k2_visits = int(mt.trace_rol(*k2_args)[2].sum())
    return dict(
        max_abs_err=0.0, **times,
        plain_ms=time_ms(lambda: ros_plain_chunked(args), 1, 0),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        visited_clusters=visits, calls=res,
        **visit_stats(per_tile[min(calls)], tc, rt, times["ms"]),
        any_hit_ms=any_ms,
        any_hit_stats=visit_stats(per_tile[max(calls)], tc, rt, any_ms),
        k2_sorted_ms=time_ms(lambda: mt.trace_rol(*k2_args)),
        k2_sorted_visited_clusters=k2_visits,
        shape=f"{nt} tiles x {rt} rays in lane order x {order.shape[1]} "
              "candidates, closest-hit, bounce 2")


def phase_mk(r, card, exact_mean):
    """Phase 6a/6b/6c on the 1080p luxball renderer. Returns (K9 results,
    K9 launches of the rays-on-sublanes render)."""
    import torch
    from fluctus_tpu_torch import flags
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.camera import generate_camera_rays
    depth = r.config.max_bounces
    saved = flags.FORCE_MK, flags.SORT_RAYS
    flags.FORCE_MK = True
    try:
        r.reset()
        torch.cuda.synchronize()
        kb.reset_counts()
        t0 = time.perf_counter()
        film = r.render_single(MK_SPP)
        elapsed = time.perf_counter() - t0
        launches, plain = counts()
        mean = float(r.hdr_image().mean())
        rel = abs(mean - exact_mean) / max(exact_mean, 1e-9)
        weight_ok = bool((film.weight == MK_SPP).all())
        emit(dict(phase="mk_path", width=r.width, height=r.height,
                  spp=MK_SPP, depth=depth, seconds=elapsed,
                  seconds_per_sample=elapsed / MK_SPP,
                  mrays_per_s=r.perf_mrays(elapsed)["total"],
                  rays=r.stats._asdict(), launches=launches,
                  plain_runs=plain, weight_exact=weight_ok,
                  image_mean=mean, exact_image_mean=exact_mean,
                  mean_rel_diff=rel, card=card))
        check_launches(launches, plain, PER_BOUNCE_MK, (depth + 1) * MK_SPP,
                       "mk path")
        if not weight_ok or rel > MK_MEAN_GATE:
            raise AssertionError(f"mk path: weight exact {weight_ok}, mean "
                                 f"differs by {rel}")

        def one_sample():
            r.render_single(1)
            return 1
        profile_segments(r, card, elapsed / MK_SPP * 1e3, run=one_sample,
                         unit="mk sample")

        flags.SORT_RAYS = False
        r.reset()
        torch.cuda.synchronize()
        kb.reset_counts()
        with RosRecorder(keep=(4, 5)) as rec:
            t0 = time.perf_counter()
            film = r.render_single(1)
            elapsed = time.perf_counter() - t0
        ros_launches, plain = counts()
        emit(dict(phase="rays_on_sublanes_path", depth=depth, spp=1,
                  seconds=elapsed,
                  mrays_per_s=r.perf_mrays(elapsed)["total"],
                  rays=r.stats._asdict(), launches=ros_launches,
                  plain_runs=plain,
                  weight_exact=bool((film.weight == 1).all()), card=card))
        check_launches(ros_launches, plain, PER_BOUNCE_ROS, depth + 1,
                       "rays-on-sublanes path")
        k9 = check_ros(r, rec.calls)
    finally:
        flags.FORCE_MK, flags.SORT_RAYS = saved
    emit(dict(phase="trace_ros_vs_plain", card=card, trace_ros=k9))

    ok, t, tri = r.pick_single(0.5, 0.5)
    px, py = int(0.5 * (r.width - 1)), int(0.5 * (r.height - 1))
    pixel = torch.tensor([py * r.width + px], dtype=torch.int32,
                         device=r.device)
    orig, d, _ = generate_camera_rays(
        pixel, r.params.camera, r.width, r.height, r.params.world_radius,
        torch.zeros(1, dtype=torch.int64, device=r.device))
    ft, ftri, _, _, _ = mt.closest_hit_mxu_full(orig, d, r.device_scene.mxu)
    emit(dict(phase="pick", hit=ok, t=t, tri=tri, full_t=float(ft[0]),
              full_tri=int(ftri[0])))
    if not ok or tri != int(ftri[0]) or abs(t - float(ft[0])) > 1e-6 * t:
        raise AssertionError("pick_single disagrees with "
                             "closest_hit_mxu_full")
    return k9, ros_launches


def kernels_line(kres, launches):
    """One entry per ported kernel: its checks and times from phase 2 (K1-K4,
    luxball), 2b (K5, K6), 5a (K7, K8), 6b (K9) or 8a (K10), and its
    launches on its main path, counted from 0: K1-K6 summed over the
    free-running runs (3, 3b, 11, 12a, and 13a and 13c on the flat ring,
    where K4, K7 and K8 launch 0 times), K7 and K8 in the timed exact
    renders (5b, 11c, 12a), K9 in the rays-on-sublanes render (6b), K10 in
    the free-running run on tables without B16 (8b). K4's entry also
    carries its 8-channel calls (12a: the denoiser's features), with their
    launches in 12a's runs."""
    out = []
    for name in SOURCES:
        k = kres[name]
        entry = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"])
        any_ms = k.get("any_hit", {}).get("ms", k.get("any_hit_ms"))
        if any_ms is not None:          # the trace kernels' any-hit call
            entry["any_hit_ms"] = any_ms
        if "channels_8" in k:           # K4 on the denoiser's features
            c8 = k["channels_8"]
            entry["channels_8"] = {key: c8[key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        out.append(entry)
    return {"kernels": out}


def vertex_table_bytes(r):
    """Device bytes of the rays-on-sublanes trace's tx/ty/tz, of the
    transform rows txy_t (closest_hit_mxu_full, K10) and of K10's f32
    attrs (slim tables drop them)."""
    sc = r.device_scene.mxu
    return nbytes(*(t for t in (sc.tx, sc.ty, sc.tz, sc.txy_t, sc.attrs)
                    if t is not None))


def record_segments(r):
    """Segments 1-4 from a fresh 1M-path pool, the kernel wrappers'
    arguments recorded in segments 2 and 4."""
    with Recorder() as rec:
        r.init_wavefront(1 << 20)
        for seg in range(1, 5):
            rec.active = seg if seg in (2, 4) else None
            r.render_wavefront(1)
        rec.active = None
    return rec.calls


# ---------------------------------------------------------------------------
# Phase 8: the K10 route (tables without B16) and the caches
# ---------------------------------------------------------------------------

def no_b16_cache(scene_file=LUXBALL):
    """A fresh data_dir holding ``scene_file``'s table cache with the B16
    tables stored absent (0-d b16t and attr_b16), under the reference's
    file name. Returns (data_dir, the full tables with B16 on the card)."""
    from fluctus_tpu_torch.accel import build_bvh
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.renderer import table_cache_path
    from fluctus_tpu_torch.scene import Scene
    scene = Scene()
    scene.load_model(scene_file)
    p, nrm, uv, mid = scene.triangle_arrays()
    slim = p.shape[0] > 65536
    host, statics = mt.MXUScene.build(p, build_bvh(p), normals=nrm, uvs=uv,
                                      mat_ids=mid, materials=scene.materials,
                                      slim=slim)
    d = fresh_dir()
    mt.write_table_cache(table_cache_path(d, scene, "sah", slim),
                         dict(host, b16t=None, attr_b16=None), statics)
    return d, mt.tables_from_numpy(host, statics, "cuda")


def check_resolve_v1(rec_calls, full):
    """Phase 8a: K10 vs its plain version on every recorded call of
    segments 2 and 4 (bit for bit), and vs K3 on the B16 tables ``full`` on
    the same winners: rows MAT, TYPE, MAP_*, TRI equal after rounding; N,
    UV, KD, NS and HITT within rtol 2e-3, atol 2e-3 (the reference's
    v5-vs-v1 gate, tests/test_mxu_resolve.py:97-103). Returns K10's timing
    dict on segment 4's call."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    ints = [mt.ATTR_MAT, mt.ATTR_TYPE, mt.ATTR_MAP_KD, mt.ATTR_MAP_KS,
            mt.ATTR_MAP_N, mt.ATTR_TRI]
    gated = ((mt.ATTR_N, 3, "N"), (mt.ATTR_UV, 2, "UV"), (mt.ATTR_KD, 3, "KD"),
             (mt.ATTR_NS, 1, "NS"), (mt.ATTR_HITT, 1, "HITT"))
    vs_k3 = {}
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "resolve_v1")]:
            got = mt.resolve_v1(*args)
            ref = mt.resolve_v1_plain(*args)
            diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            if diff:
                raise AssertionError(f"K10 differs from its plain version in "
                                     f"{diff} values (segment {seg})")
            col, o4, d4 = args[:3]
            k3 = mt.resolve_v5(col, o4, d4, full.b16r, full.t16r)
            if not torch.equal(torch.round(got[ints]), torch.round(k3[ints])):
                raise AssertionError(f"K10 and K3 integer rows differ "
                                     f"(segment {seg})")
            for c, w, name in gated:
                torch.testing.assert_close(got[c:c + w], k3[c:c + w],
                                           rtol=2e-3, atol=2e-3)
                vs_k3[name] = max(vs_k3.get(name, 0.0), float(
                    (got[c:c + w] - k3[c:c + w]).abs().max()))
    args = rec_calls[(4, "resolve_v1")][0][0]
    col, o4, d4, txy_t, attrs, tc = args
    b = col.shape[0]
    hit = col >= 0
    safe = col.clamp_min(0).long()
    winners = int(torch.unique(col[hit]).numel())
    row = (safe // tc) * (3 * tc) + safe % tc

    def library():
        return (torch.index_select(attrs, 0, row),
                torch.index_select(attrs, 0, row + tc),
                torch.index_select(attrs, 0, row + 2 * tc),
                torch.index_select(txy_t, 0, safe))
    # each input read once: the column, the rays, every distinct winner's
    # three attribute rows and transform row; the [40, b] output written
    # once. Operations: about 50 for t/u/v and 5 per interpolated column
    # of each hit.
    b_ms, b_by = bound(int(hit.sum()) * 250,
                       b * (4 + 32 + 160) + winners * (3 * 160 + 48))
    return dict(
        max_abs_err=0.0, **kernel_ms(lambda: mt.resolve_v1(*args)),
        plain_ms=time_ms(lambda: mt.resolve_v1_plain(*args), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        library_call="three torch.index_select of the winners' attrs rows "
                     "and one of their txy_t rows",
        k3_same_winners_ms=time_ms(lambda: mt.resolve_v5(
            col, o4, d4, full.b16r, full.t16r)),
        max_abs_diff_vs_k3=vs_k3,
        shape=f"{b} rays, {int(hit.sum())} hits, {winners} distinct "
              f"winners, attrs {attrs.shape[0]} rows")


def phase_k10(card, b16_main):
    """Phases 8a-8c on luxball's tables without B16. ``b16_main`` is phase
    3's main-path line (the B16 route). Returns (K10's timing dict, its
    launches in the timed run)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    data_dir, full = no_b16_cache()
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
    sc = r.device_scene.mxu
    if not (r.cache_hit["tables"] and sc.b16r is None
            and sc.attrs is not None and torch.equal(sc.attrs, full.attrs)
            and torch.equal(sc.txy_t, full.txy_t)):
        raise AssertionError(f"no-B16 tables not loaded from the cache: "
                             f"{r.cache_hit}, b16r {sc.b16r is not None}")
    k10 = check_resolve_v1(record_segments(r), full)
    emit(dict(phase="resolve_v1_vs_plain", card=card, scene=LUXBALL,
              cache_hit=r.cache_hit, host_steps=r.load_seconds,
              vertex_table_bytes=vertex_table_bytes(r), resolve_v1=k10))

    # 8b: the wavefront on these tables, against the B16 route's mean
    launches, main = phase_main(r, card, LUXBALL, SEGMENTS, PER_SEGMENT_K10,
                                extra=dict(tables="no B16 (table cache)"))
    rel = abs(main["image_mean"] - b16_main["image_mean"]) / \
        b16_main["image_mean"]
    prof = profile_segments(r, card, main["ms_per_segment"], n=1)
    share = prof["kernels_us_per_segment"].get("resolve_v1", 0.0) / 1e3 \
        / prof["device_ms_per_segment"]
    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single(K10_SPP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    x_launches, plain = counts()
    segments = len(r._wf_counters)
    spp = unpad_pixels(r._wf_state.spp, r.config)
    exact = bool((spp == K10_SPP).all() and (film.weight == K10_SPP).all())
    emit(dict(phase="k10_route", card=card, image_mean=main["image_mean"],
              b16_image_mean=b16_main["image_mean"], mean_rel_diff=rel,
              resolve_v1_device_share=share, exact_spp=K10_SPP,
              exact_seconds=elapsed, exact_segments=segments,
              exact_launches=x_launches, spp_and_weight_exact=exact))
    if rel > BIAS_GATE:
        raise AssertionError(f"K10 route mean differs by {rel} from the "
                             "B16 route's")
    check_launches(x_launches, plain, PER_SEGMENT_EXACT_K10, segments,
                   "K10 exact path")
    if not exact:
        raise AssertionError("K10 exact path: spp/weight differ from "
                             "the target")
    del r
    torch.cuda.empty_cache()

    # 8c: whole-path parity on the same tables
    out = phase_parity(LUXBALL, data_dir=data_dir, exact=True)
    if out["b16_tables"]:
        raise AssertionError("K10 parity ran on B16 tables")
    return k10, launches


def same_tables(a, b):
    """Two MXUSceneT equal field for field (tensors bit for bit)."""
    import torch
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(
                    x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                    y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
                return name
        elif x != y:
            return name
    return None


def phase_caches(card):
    """Phase 8d: the 8x8 grid loaded cold into a fresh data_dir, then warm
    from the caches the cold load wrote: host seconds (load, and to the end
    of a first segment), cache hits, the device tables equal field for
    field, and the films of 4 segments from the same reset equal."""
    import torch
    d = fresh_dir()
    runs = []
    for kind in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = make_renderer(1920, 1080, "cuda", LARGE, data_dir=d)
        load_s = time.perf_counter() - t0
        r.init_wavefront(1 << 20)
        r.render_wavefront(1)                 # ends in synchronize
        first_s = time.perf_counter() - t0
        r.init_wavefront(1 << 20)
        r.render_wavefront(4)
        f = r.wavefront_film()
        runs.append(dict(kind=kind, tables=r.device_scene.mxu,
                         film=torch.stack([*f.color, f.weight]),
                         line=dict(load_seconds=r.load_seconds,
                                   cache_hit=r.cache_hit,
                                   host_seconds_to_load=load_s,
                                   host_seconds_to_first_segment=first_s)))
        del r, f
    cold, warm = runs
    files = {os.path.relpath(os.path.join(dp, n), d):
             os.path.getsize(os.path.join(dp, n))
             for dp, _, names in os.walk(d) for n in names}
    diff = same_tables(cold["tables"], warm["tables"])
    film_equal = bool(torch.equal(cold["film"], warm["film"]))
    emit(dict(phase="caches", scene=LARGE, card=card, cold=cold["line"],
              warm=warm["line"], cache_file_bytes=files,
              tables_equal=diff is None, films_equal=film_equal))
    if cold["line"]["cache_hit"] != dict(bvh=False, tables=False) or \
            warm["line"]["cache_hit"] != dict(bvh=True, tables=True):
        raise AssertionError("caches: cold load hit or warm load missed")
    if diff is not None or not film_equal:
        raise AssertionError(f"caches: warm load differs (table {diff}, "
                             f"films equal {film_equal})")


# ---------------------------------------------------------------------------
# Phase 9: the env map on the luxball paths
# ---------------------------------------------------------------------------

def sky_map(width, height, seed):
    """A seeded sky of width x height texels: a gradient from a bright
    horizon to a blue zenith, a dark ground below the horizon, 5% texel
    noise from ``seed``, and a sun disc of 2,000 (a few texels across)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # 0 = zenith
    up = np.clip((0.5 - v) * 2.0, 0.0, 1.0)[:, None]
    sky = (np.array([1.0, 0.95, 0.9], np.float32) * (1.0 - up)
           + np.array([0.15, 0.3, 0.9], np.float32) * up)
    ground = np.array([0.2, 0.15, 0.1], np.float32)
    img = np.where((v < 0.5)[:, None, None], sky[:, None, :],
                   ground[None, None, :]) * np.ones((1, width, 1),
                                                    np.float32)
    img *= 1.0 + 0.05 * rng.standard_normal((height, width, 1))
    yy, xx = np.ogrid[0:height, 0:width]
    cy, cx, rad = int(0.3 * height), int(0.6 * width), max(2, width // 512)
    img[(yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad] = 2000.0
    return img.astype(np.float32)


def set_env_array(r, img, name):
    """Give a loaded renderer an env map made with EnvironmentMap.from_array
    (Scene.set_env_map, its tables on the card, rebuild_config)."""
    from fluctus_tpu_torch.envmap import EnvironmentMap
    env = EnvironmentMap.from_array(img, name=name)
    r.scene.set_env_map(env)
    r.device_scene = r.device_scene._replace(env=env.device_tables(r.device))
    r.settings.use_env_map = True
    r.rebuild_config()


def env_route(r):
    env = r.device_scene.env
    return dict(env_map=r.scene.envmap.name, texels=env.width * env.height,
                use_env_map=r.config.use_env_map, fast_env=r.config.fast_env,
                single_read=env.prob_alias is not None,
                use_area_light=r.config.use_area_light)


def device_ms_of(fn, reps=4):
    """Device ms and device operations of one ``fn()``, summed over the
    device events torch.profiler sees (an elementwise chain this short is
    host bound, so CUDA events around it would time the host's
    launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us, ops = 0.0, 0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0) or 0
        if dt > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += dt
            ops += e.count
    return dev_us / reps / 1e3, ops / reps


def env_lookup_ms(r):
    """Device ms and device operations of one segment's env lookups on the
    current pool: the implicit hit's radiance and pdf along every lane's
    direction and the NEE sample of every lane."""
    import torch
    from fluctus_tpu_torch.envmap import env_radiance_and_pdf, env_sample
    env, fast = r.device_scene.env, r.config.fast_env
    d = r._wf_state.pool.dir
    g = torch.Generator(device=r.device).manual_seed(9)
    u = torch.rand(d.x.shape[0], generator=g, device=r.device)

    def lookups():
        env_radiance_and_pdf(env, d, fast)
        env_sample(env, u, fast)
    return device_ms_of(lookups)


def env_path(r, card, segments, what):
    """A timed env-lit wavefront run (phase 3's), its profile and the env
    lookups' device time. Returns the main_path line."""
    _, main = phase_main(r, card, LUXBALL, segments, PER_SEGMENT,
                         extra=dict(env_route(r), cell=what))
    prof = profile_segments(r, card, main["ms_per_segment"])
    look, ops = env_lookup_ms(r)
    emit(dict(phase="env_lookup", cell=what, card=card,
              device_ms_per_segment=look, device_ops_per_segment=ops,
              share_of_device_ms=look / prof["device_ms_per_segment"]))
    return main


def phase_env(card, plain_main):
    """Phases 9a-9e: luxball at 1080p with 1M paths, depth 10, with the
    env map (see the module docstring). ``plain_main`` is phase 3's line:
    the env map must brighten the image."""
    import torch
    from fluctus_tpu_torch import flags
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    r = make_renderer(1920, 1080, "cuda", env_map=ENV_FILE)
    route = env_route(r)
    if not (route["use_env_map"] and route["fast_env"]
            and route["single_read"]):
        raise AssertionError(f"9a: not the env map's fast route: {route}")

    # 9a: env-lit wavefront, fast route
    kres = check_luxball_kernels(record_segments(r), "env map")
    emit(dict(phase="env_kernels_vs_plain", card=card, **route, **kres))
    main = env_path(r, card, ENV_SEGMENTS, "9a fast route")
    if not main["image_mean"] > plain_main["image_mean"]:
        raise AssertionError("9a: the env map does not light the image")

    # 9c: exact spp with the env map (K7, the redesigned K8)
    r.reset()
    with ExactRecorder() as rec:
        r.render_single(ENV_SPP)
    k7, k8 = check_exact_kernels(rec)
    emit(dict(phase="env_exact_kernels_vs_plain", card=card, **route,
              early_segment=rec.early[0], tail_segment=rec.tail[0],
              segments=rec.seg, block_splat_capped=k7, fetch=k8))
    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single(ENV_SPP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, plain = counts()
    segments = len(r._wf_counters)
    spp = unpad_pixels(r._wf_state.spp, r.config)
    exact = bool((spp == ENV_SPP).all() and (film.weight == ENV_SPP).all())
    finite = bool(all(torch.isfinite(c).all() for c in film.color))
    emit(dict(phase="env_exact_path", card=card, **route, spp=ENV_SPP,
              seconds=elapsed, segments=segments,
              mrays_per_s=r.perf_mrays(elapsed)["total"],
              samples_per_s=r.stats.samples / elapsed,
              rays=r.stats._asdict(), launches=launches, plain_runs=plain,
              spp_and_weight_exact=exact, film_finite=finite,
              image_mean=float(r.hdr_image().mean())))
    check_launches(launches, plain, PER_SEGMENT_EXACT, segments,
                   "env exact path")
    if not (exact and finite):
        raise AssertionError(f"9c: spp/weight exact {exact}, finite "
                             f"{finite}")

    # 9e: the megastep with the env map, 1 spp
    depth = r.config.max_bounces
    saved = flags.FORCE_MK
    flags.FORCE_MK = True
    try:
        r.reset()
        torch.cuda.synchronize()
        kb.reset_counts()
        t0 = time.perf_counter()
        film = r.render_single(1)
        elapsed = time.perf_counter() - t0
    finally:
        flags.FORCE_MK = saved
    launches, plain = counts()
    ok = bool((film.weight == 1).all()
              and all(torch.isfinite(c).all() for c in film.color))
    emit(dict(phase="env_mk_path", card=card, **route, spp=1, depth=depth,
              seconds_per_sample=elapsed,
              mrays_per_s=r.perf_mrays(elapsed)["total"],
              rays=r.stats._asdict(), launches=launches, plain_runs=plain,
              weight_exact_and_finite=ok,
              image_mean=float(r.hdr_image().mean())))
    check_launches(launches, plain, PER_BOUNCE_MK_ENV, depth + 1,
                   "env mk path")
    if not ok:
        raise AssertionError("9e: weight or film wrong")

    # 9b: the alias route, a seeded 2048x1024 sky from from_array
    t0 = time.perf_counter()
    set_env_array(r, sky_map(*SKY_SIZE, seed=10), "sky 2048x1024")
    build_s = time.perf_counter() - t0
    route = env_route(r)
    if route["single_read"] or not route["use_env_map"]:
        raise AssertionError(f"9b: not the alias route: {route}")
    env_path(r, card, ENV_ALIAS_SEGMENTS, f"9b alias route (tables built "
             f"in {build_s:.3f} s)")
    del r
    torch.cuda.empty_cache()

    # 9d: whole-path parity with the env map, kernels vs plain versions
    for fast, area in ((True, True), (False, True), (True, False)):
        phase_parity(LUXBALL, env_map=ENV_FILE, area_light=area,
                     fast_env=fast)


# ---------------------------------------------------------------------------
# Phase 11: the production luxball (textures, normal maps, GGX lobes,
# Russian roulette and the sampling toggles)
# ---------------------------------------------------------------------------

PROD_MTL = """newmtl glass
shader rough_dielectric
Ks 1.0 1.0 1.0
Kt 0.98 0.98 0.98
Ni 1.5
Ns 500

newmtl core
shader glossy
Kd 0.65 0.25 0.08
Ks 0.04 0.04 0.04
Ni 1.5
Ns 200
map_Ks specular.png

newmtl ground
shader diffuse
Kd 0.55 0.55 0.55
map_Kd albedo.png
map_bump normal.png
"""

PROD_INSTANCE_B = {"translation": [2.3, 0.0, -1.2],
                   "skipMaterials": ["ground"],
                   "materials": {"core": {"shader": "rough_reflection",
                                          "Ks": [0.9, 0.8, 0.6], "Ni": 2.0,
                                          "Ns": 100},
                                 "glass": {"shader": "ideal_dielectric"}}}


def _production_maps(sizes, seed):
    """(albedo RGB, normal RGB, specular RGB) uint8 images."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s_kd, s_n, s_ks = sizes
    yy, xx = np.mgrid[0:s_kd, 0:s_kd]
    cell = max(1, s_kd // 8)
    check = ((yy // cell + xx // cell) % 2)[..., None]
    albedo = np.where(check, [0.85, 0.8, 0.7], [0.25, 0.35, 0.55])
    albedo = albedo * (0.9 + 0.1 * rng.random((s_kd, s_kd, 1)))
    yy, xx = np.mgrid[0:s_n, 0:s_n] * (2.0 * np.pi * 6.0 / s_n)
    n = np.stack([0.35 * np.sin(xx), 0.35 * np.sin(yy),
                  np.ones_like(xx)], -1)
    n += 0.05 * rng.standard_normal(n.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    spec = 0.1 + 0.8 * rng.random((s_ks, s_ks, 1)) * np.ones(3)
    u8 = lambda a: np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
    return u8(albedo), u8(n * 0.5 + 0.5), u8(spec)


def write_production_scene(out_dir: str, sizes=PROD_SIZES,
                           seed: int = 0) -> str:
    """The production luxball, written into ``out_dir`` from a seed:
    production.obj (data/luxball/luxball.obj with planar uvs, u = x / 2,
    v = z / 2, so the ground's maps repeat and wrap), production.mtl,
    seeded albedo, normal and specular PNGs (``sizes`` are their edge
    lengths) and production.sc.json. Instance A: the ground diffuse with
    an albedo map (map_Kd) and a normal map (map_bump), the core glossy
    with a specular map (map_Ks, Ns 200) and the glass rough dielectric
    (Ns 500). Instance B, beside it: no ground, the core overridden to
    rough reflection and the glass to ideal dielectric. So every lobe but
    emissive and every map type is in the scene. Returns the .sc.json's
    path."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, LUXBALL)) as f:
        for raw in f:
            parts = raw.split()
            if parts and parts[0] == "mtllib":
                lines.append("mtllib production.mtl\n")
            elif parts and parts[0] == "v":
                # the vertex's planar uv, so vertex i and uv i pair up
                x, z = float(parts[1]), float(parts[3])
                lines += [raw, f"vt {x / 2.0:.6f} {z / 2.0:.6f}\n"]
            elif parts and parts[0] == "f":
                lines.append("f " + " ".join(f"{i}/{i}" for i in parts[1:])
                             + "\n")
            else:
                lines.append(raw)
    with open(os.path.join(out_dir, "production.obj"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(out_dir, "production.mtl"), "w") as f:
        f.write(PROD_MTL)
    for name, img in zip(("albedo", "normal", "specular"),
                         _production_maps(sizes, seed)):
        Image.fromarray(img, "RGB").save(
            os.path.join(out_dir, f"{name}.png"), compress_level=1)
    path = os.path.join(out_dir, "production.sc.json")
    with open(path, "w") as f:
        json.dump([{"file": "production.obj"},
                   {"file": "production.obj", **PROD_INSTANCE_B}], f,
                  indent=1)
    return path


def production_info(r, write_s):
    """The production scene's make-up, as loaded."""
    from fluctus_tpu_torch import bxdf_types as bx
    ds, sc = r.device_scene, r.device_scene.mxu
    atlas = ds.atlas
    return dict(
        triangles=r.scene.num_triangles, n_clusters=sc.n_clusters,
        lobes=[bx.type_name(t) for t in bx.ALL_TYPES
               if ds.material_types & t],
        textures=[(t.name, t.width, t.height) for t in r.scene.textures],
        texels=int(atlas.texels.numel()), has_tex_meta=sc.has_tex_meta,
        tri_frames=ds.tri_frames is not None, scene_write_s=write_s,
        host_steps=r.load_seconds)


def check_textured_resolves(rec_calls, sc):
    """11a: K3's recorded calls of segments 2 and 4 on the textured
    tables: the share of hit lanes whose material has a map (rows 22-24)
    and, of those, the share whose descriptor rows 29-34 are non-zero
    (both must be > 0); K6 on the same calls and K10 on the same winners
    with the tables' (``sc``) f32 attrs, each bit for bit against its plain
    version, with rows 22-25 (map indices, triangle) equal to K3's and
    the largest difference of K10's interpolated descriptor rows from
    K3's reported. Returns the printed dict."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    out, tex, hits, desc = {}, 0, 0, 0
    k10_desc = 0.0
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "resolve_v5")]:
            col, o4, d4, b16r, t16r = args
            k3 = mt.resolve_v5(*args)
            hit = col >= 0
            maps = (k3[mt.ATTR_MAP_KD:mt.ATTR_MAP_N + 1] > -0.5).any(0) & hit
            nz = (k3[mt.ATTR_TKD_WH:mt.ATTR_TN_OFF + 1] != 0).any(0)
            hits += int(hit.sum())
            tex += int(maps.sum())
            desc += int((maps & nz).sum())
            k6 = mt.resolve_v5s(*args)
            if not (torch.equal(k6.view(torch.int32), mt.resolve_v5s_plain(
                    *args).view(torch.int32))
                    and torch.equal(k6.view(torch.int32),
                                    k3.view(torch.int32))):
                raise AssertionError(f"11a: K6 differs from its plain "
                                     f"version or K3 (segment {seg})")
            v1 = (col, o4, d4, sc.txy_t, sc.attrs, sc.cluster_size)
            k10 = mt.resolve_v1(*v1)
            if not torch.equal(k10.view(torch.int32),
                               mt.resolve_v1_plain(*v1).view(torch.int32)):
                raise AssertionError(f"11a: K10 differs from its plain "
                                     f"version (segment {seg})")
            rows = slice(mt.ATTR_MAP_KD, mt.ATTR_TRI + 1)
            if not torch.equal(torch.round(k10[rows]), torch.round(k3[rows])):
                raise AssertionError(f"11a: K10's map/triangle rows differ "
                                     f"from K3's (segment {seg})")
            dr = slice(mt.ATTR_TKD_WH, mt.ATTR_TN_OFF + 1)
            k10_desc = max(k10_desc, float((k10[dr] - k3[dr]).abs().max()))
    out.update(hit_lanes=hits, textured_share_of_hits=tex / max(hits, 1),
               descriptor_share_of_textured=desc / max(tex, 1),
               k6_equal_k3=True, k10_desc_max_abs_diff_vs_k3=k10_desc)
    if not (tex > 0 and desc == tex):
        raise AssertionError(f"11a: textured lanes {tex}, with descriptors "
                             f"{desc}")
    return out


def tex_lookup_ms(r):
    """Device ms and device operations of one segment's texture work on
    the current pool: apply_textures (Kd with its gamma, Ks) and the
    normal mapping of every lane's resolved hit."""
    from fluctus_tpu_torch.bsdf import apply_textures
    from fluctus_tpu_torch.core.integrator_wf import (wf_resolve_phase,
                                                      wf_trace_phase)
    from fluctus_tpu_torch.core.trace import tangent_space_normal
    ds, cfg, pool = r.device_scene, r._wf_cfg, r._wf_state.pool
    raw, _ = wf_trace_phase(ds, pool, r.params, cfg)
    hit, sp = wf_resolve_phase(ds, pool, r.params, cfg, raw)

    def lookups():
        s2 = apply_textures(sp, hit.uv_u, hit.uv_v, ds.atlas)
        tangent_space_normal(hit, ds.tri_frames, s2.map_N, ds.atlas,
                             meta=s2.n_meta)
    return device_ms_of(lookups)


def roulette_share(r):
    """The share of the pool's lanes that Russian roulette ends in the
    next segment: its first draw above the clamped luminance of the
    throughput, on lanes past MIN_PATH_LENGTH that no depth limit ends
    (integrator_wf.wf_logic_phase's test, read from the pool)."""
    import torch
    from fluctus_tpu_torch.geom import MIN_PATH_LENGTH
    from fluctus_tpu_torch.rng import rand
    from fluctus_tpu_torch.vec import luminance
    pool, cfg = r._wf_state.pool, r._wf_cfg
    plen = pool.path_len + 1
    u, _ = rand(pool.seed)
    cp = torch.clamp(luminance(pool.T), 0.01, 0.5)
    live = (plen > MIN_PATH_LENGTH) & (plen < cfg.max_bounces + 1)
    return float((live & (u > cp)).float().mean())


def exact_with_roulette(r, spp):
    """The capped wavefront (render_single_wavefront's loop: 16 segments
    between checks of the least spp) from a fresh 1M-path pool with
    Russian roulette on, which render_single turns off as the reference
    does. Returns (state, segments)."""
    import torch
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    cfg = r.config.replace(max_spp=1, use_roulette=True)
    params = r.params._replace(max_spp=torch.tensor(
        spp, dtype=torch.int32, device=r.device))
    state = wf_reset(cfg, 1 << 20, world_radius=r.world_radius,
                     device=r.device)
    segments = 0
    while segments < 4096:
        for _ in range(16):
            state, _ = wf_segment(r.device_scene, params, state, cfg)
            segments += 1
        if int(state.spp.min()) >= spp:
            break
    return state, segments


def phase_production(card, lux_kres):
    """Phases 11a-11e (see the module docstring). ``lux_kres`` holds phase
    2's kernel results (K2 on luxball's rays). Returns the launches of its
    timed main-path runs by kernel, and the scene file, its caches'
    directory, 11a's timed run and profile (for phase 12)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_mk import Film, render_sample
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    t0 = time.perf_counter()
    data_dir = fresh_dir()
    scene = write_production_scene(fresh_dir(), PROD_SIZES, seed=11)
    write_s = time.perf_counter() - t0
    r = make_renderer(1920, 1080, "cuda", scene, data_dir=data_dir)
    info = production_info(r, write_s)
    want = {"diffuse", "glossy", "rough_reflection", "rough_dielectric",
            "ideal_dielectric"}
    if not (set(info["lobes"]) == want and info["has_tex_meta"]
            and info["tri_frames"] and len(info["textures"]) == 3
            and info["n_clusters"] <= 96):
        raise AssertionError(f"11: not the production scene: {info}")
    launches = {}

    def add(counts_):
        for k, v in counts_.items():
            launches[k] = launches.get(k, 0) + v

    # 11a: K1-K4 (and K6, K10 on K3's calls) on textured segments, then
    # the timed wavefront
    rec = record_segments(r)
    kres = check_luxball_kernels(rec, "production")
    tex = check_textured_resolves(rec, r.device_scene.mxu)
    lux = lux_kres["trace_rol"]
    emit(dict(phase="production_kernels_vs_plain", card=card, **info,
              **kres, textured=tex,
              trace_rol_luxball=dict(ms=lux["ms"],
                                     any_hit_ms=lux["any_hit"]["ms"])))
    la, main = phase_main(r, card, scene, PROD_SEGMENTS, PER_SEGMENT,
                          extra=dict(cell="11a production"))
    add(la)
    prof = profile_segments(r, card, main["ms_per_segment"])
    look, ops = tex_lookup_ms(r)
    emit(dict(phase="tex_lookup", cell="11a production", card=card,
              device_ms_per_segment=look, device_ops_per_segment=ops,
              share_of_device_ms=look / prof["device_ms_per_segment"]))

    # 11a with the env map (the teapot map, single-read route)
    r.scene.load_env_map(ENV_FILE)
    r.device_scene = r.device_scene._replace(
        env=r.scene.envmap.device_tables(r.device))
    r.settings.use_env_map = True
    r.rebuild_config()
    kres_env = check_luxball_kernels(record_segments(r), "production env")
    emit(dict(phase="production_env_kernels_vs_plain", card=card,
              **env_route(r), **kres_env))
    le, _ = phase_main(r, card, scene, PROD_ENV_SEGMENTS, PER_SEGMENT,
                       extra=dict(env_route(r), cell="11a production + env"))
    add(le)
    r.settings.use_env_map = False

    # 11b: Russian roulette
    r.settings.use_russian_roulette = True
    r.rebuild_config()
    lb, main_rr = phase_main(r, card, scene, PROD_RR_SEGMENTS, PER_SEGMENT,
                             extra=dict(cell="11b roulette"))
    add(lb)
    shares = []
    for _ in range(4):
        shares.append(roulette_share(r))
        r.render_wavefront(1)
    emit(dict(phase="roulette", card=card, segments_after_timed=4,
              ended_share_per_segment=shares,
              mrays_per_s=main_rr["mrays_per_s"],
              ms_per_segment=main_rr["ms_per_segment"],
              without_roulette=dict(mrays_per_s=main["mrays_per_s"],
                                    ms_per_segment=main["ms_per_segment"])))
    if not any(shares):
        raise AssertionError("11b: roulette ended no path")

    # 11c: exact spp; render_single with roulette set (it runs without, as
    # the reference's), then the capped wavefront with roulette on
    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single(PROD_SPP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    lc, plain = counts()
    segments = len(r._wf_counters)
    spp = unpad_pixels(r._wf_state.spp, r.config)
    exact = bool((spp == PROD_SPP).all() and (film.weight == PROD_SPP).all())
    check_launches(lc, plain, PER_SEGMENT_EXACT, segments,
                   "production exact path")
    add({k: lc[k] for k in ("block_splat_capped", "fetch")})
    with ExactRecorder() as rec:
        state, rr_segments = exact_with_roulette(r, PROD_SPP)
    k7, k8 = check_exact_kernels(rec)
    rr_spp = unpad_pixels(state.spp, r.config)
    rr_w = unpad_pixels(state.film.weight, r.config)
    rr_exact = bool((rr_spp == PROD_SPP).all() and (rr_w == PROD_SPP).all())
    emit(dict(phase="production_exact", card=card, spp=PROD_SPP,
              seconds=elapsed, segments=segments,
              mrays_per_s=r.perf_mrays(elapsed)["total"],
              render_single_roulette=r._wf_cfg.use_roulette,
              spp_and_weight_exact=exact, launches=lc, plain_runs=plain,
              roulette_segments=rr_segments,
              roulette_spp_and_weight_exact=rr_exact,
              block_splat_capped=k7, fetch=k8))
    if not (exact and rr_exact):
        raise AssertionError(f"11c: exact {exact}, with roulette "
                             f"{rr_exact}")

    # 11d: one megastep sample with roulette on (render_sample itself:
    # render_single turns roulette off)
    depth = r.config.max_bounces
    npx = r.config.num_pixels
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    mfilm, _, st = render_sample(
        r.device_scene, r.params, Film.zeros(npx, r.device),
        torch.arange(npx, dtype=torch.int64, device=r.device), r.config)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    lm, plain = counts()
    ok = bool((mfilm.weight == 1).all()
              and all(torch.isfinite(c).all() for c in mfilm.color))
    emit(dict(phase="production_mk", card=card, roulette=True,
              depth=depth, seconds_per_sample=elapsed, rays=st._asdict(),
              launches=lm, plain_runs=plain, weight_exact_and_finite=ok))
    check_launches(lm, plain, PER_BOUNCE_MK, depth + 1, "production mk")
    if not ok:
        raise AssertionError("11d: weight or film wrong")
    del r
    torch.cuda.empty_cache()

    # 11e: whole-path parity, kernels vs plain versions
    for switches in PROD_PARITY:
        phase_parity(scene, data_dir=data_dir, switches=switches)
    return launches, dict(scene=scene, data_dir=data_dir, main=main,
                          prof=prof)


# ---------------------------------------------------------------------------
# Phase 12: a user's render job (the denoiser, checkpoints, the CLI)
# ---------------------------------------------------------------------------

def check_free_splats(calls, what):
    """Every recorded uncapped splat call (K4) against splat_plain, bit for
    bit. Returns the calls' count per channel count."""
    import torch
    from fluctus_tpu_torch.core import block_splat as bs
    widths = {}
    for seg, (local, data, film, g) in calls:
        got = bs.splat(local, data, film, groups=g)
        ref = bs.splat_plain(local, data, film, g)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K4 differs from its plain version ({what},"
                                 f" {data.shape[0]} channels, segment {seg})")
        widths[data.shape[0]] = widths.get(data.shape[0], 0) + 1
    return widths


def phase_denoiser(card, prod):
    """Phase 12a (see the module docstring). ``prod`` holds phase 11a's
    scene, caches, timed run and profile. Returns (K4's 8-channel results
    for the kernels line, launches of the main-path runs by kernel, K4's
    8-channel launches among them)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.denoise import atrous_denoise
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    r = make_renderer(1920, 1080, "cuda", prod["scene"],
                      data_dir=prod["data_dir"],
                      switches={"use_denoiser": True})
    if not r.config.denoiser:
        raise AssertionError("12a: the denoiser is off")

    # K4 at 4 and 8 channels on free-running segments 2 and 4
    rec = record_segments(r)
    free = [(seg, args + (kw["groups"],)) for seg in (2, 4)
            for args, kw in rec[(seg, "splat")]]
    widths = check_free_splats(free, "denoiser segments")
    if widths != {4: 2, 8: 2}:
        raise AssertionError(f"12a: K4 calls by channels {widths}")
    local, data, film, g = free[-1][1]
    k4_8 = dict(**splat_timing(local, data, film, g),
                synthetic=check_splat_synthetic(capped=False, channels=8))
    del rec, free, local, data, film

    # render_single(JOB_SPP): every K4 call (the features) held, K7 and K8
    # as phase 5
    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    with ExactRecorder(keep_free=True) as xrec:
        r.render_single(JOB_SPP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    lx, plain = counts()
    exact_k4 = dict(kb.KERNELS["block_splat"].launches_by)
    segments = len(r._wf_counters)
    check_launches(lx, plain, PER_SEGMENT_EXACT_DENOISE, segments,
                   "denoiser exact path")
    exact_widths = check_free_splats(xrec.free, "denoiser exact path")
    k7, k8 = check_exact_kernels(xrec)
    del xrec
    spp = unpad_pixels(r._wf_state.spp, r.config)
    exact = bool((spp == JOB_SPP).all() and (r.film.weight == JOB_SPP).all())
    f = r.features
    wts = torch.stack([f.albedo_w, f.normal_w])
    whole = bool((wts == torch.round(wts)).all() and (wts >= 0).all())
    hdr = r._vec_image(r.film.color, r.film.weight)
    alb, nrm = r._feature_tensors()
    den = r.denoised_tensor()
    finite = bool(torch.isfinite(den).all())
    den_ms = time_ms(lambda: atrous_denoise(hdr, alb, nrm), reps=5, warm=1)
    out = dict(phase="denoiser_exact", card=card, spp=JOB_SPP,
               seconds=elapsed, segments=segments,
               spp_and_weight_exact=exact, launches=lx, plain_runs=plain,
               k4_calls_by_channels=exact_widths,
               k4_launches_by_channels=exact_k4,
               feature_weights_whole=whole,
               albedo_w_max=float(f.albedo_w.max()),
               normal_w_max=float(f.normal_w.max()),
               pixels_with_normal_w_over_spp=int((f.normal_w > JOB_SPP)
                                                 .sum()),
               normal_w_mean=float(f.normal_w.mean()),
               denoised_finite=finite, denoise_device_ms=den_ms,
               denoise_shape=list(den.shape),
               block_splat_capped=k7, fetch=k8)
    emit(out)
    if not (exact and whole and finite) or exact_k4 != {8: segments} or (
            exact_widths != exact_k4):
        raise AssertionError(f"12a: exact {exact}, whole weights {whole}, "
                             f"denoised finite {finite}, K4 launches "
                             f"{exact_k4}, recorded calls {exact_widths}")
    launches = dict(lx)

    # DENOISE_SEGMENTS free-running segments with the denoiser, profiled
    lf, main = phase_main(r, card, prod["scene"], DENOISE_SEGMENTS,
                          PER_SEGMENT_DENOISE,
                          extra=dict(cell="12a production + denoiser"))
    for k, v in lf.items():
        launches[k] = launches.get(k, 0) + v
    free_k4 = main["k4_launches_by_channels"]
    if free_k4 != {4: DENOISE_SEGMENTS, 8: DENOISE_SEGMENTS}:
        raise AssertionError(f"12a: K4 launches by channels {free_k4} over "
                             f"{DENOISE_SEGMENTS} segments, expected one "
                             f"of each width per segment")
    prof = profile_segments(r, card, main["ms_per_segment"])
    emit(dict(phase="denoiser_cost", card=card,
              ms_per_segment=main["ms_per_segment"],
              device_ms_per_segment=prof["device_ms_per_segment"],
              without_denoiser=dict(
                  ms_per_segment=prod["main"]["ms_per_segment"],
                  device_ms_per_segment=prod["prof"][
                      "device_ms_per_segment"]),
              denoise_device_ms=den_ms))
    del r
    torch.cuda.empty_cache()
    return k4_8, launches, exact_k4[8] + free_k4[8]


def phase_resume(card):
    """Phase 12b: render_single(RESUME_SPP), save_checkpoint, then a fresh
    Renderer's load_checkpoint and render_single(RESUME_SPP); against an
    uninterrupted render_single(2 * RESUME_SPP)."""
    import torch
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    data_dir = fresh_dir()
    ck = os.path.join(fresh_dir(), "luxball.ckpt.npz")
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
    r.render_single(RESUME_SPP)
    r.save_checkpoint(ck)
    del r
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
    loaded = r.load_checkpoint(ck)
    t0 = time.perf_counter()
    film = r.render_single(RESUME_SPP)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    spp = unpad_pixels(r._wf_state.spp, r.config)
    total = 2 * RESUME_SPP
    exact = bool((spp == total).all() and (film.weight == total).all())
    resumed_mean = float(r.ldr_image().mean())
    r.reset()
    r.render_single(total)
    whole_mean = float(r.ldr_image().mean())
    bias = abs(resumed_mean - whole_mean) / whole_mean
    emit(dict(phase="checkpoint_resume", card=card, scene=LUXBALL,
              spp=[RESUME_SPP, RESUME_SPP], loaded=loaded,
              checkpoint_bytes=os.path.getsize(ck),
              resumed_seconds=resumed_s, spp_and_weight_exact=exact,
              resumed_mean=resumed_mean, uninterrupted_mean=whole_mean,
              relative_bias=bias, gate=BIAS_GATE))
    del r
    torch.cuda.empty_cache()
    if not (loaded and exact and bias < BIAS_GATE):
        raise AssertionError(f"12b: loaded {loaded}, exact {exact}, bias "
                             f"{bias}")


def run_cli(cwd, *args, timeout=300):
    """``python -m fluctus_tpu_torch args`` in ``cwd``, the repository on
    its path. Returns (exit code, stdout, stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("FLT_FORCE_CPU", None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fluctus_tpu_torch", *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def phase_cli(card):
    """Phase 12c: the CLI as a subprocess in a fresh directory. The state
    file round-trips: it is the bytes save_state writes for the default
    Settings the CLI ran with, and load_state then save_state reproduces
    them."""
    from fluctus_tpu_torch import state_io
    from fluctus_tpu_torch.settings import Settings
    cwd = fresh_dir()
    scene = os.path.abspath(LUXBALL)
    rc1, out1, err1, s1 = run_cli(
        cwd, scene, "-x", "1920", "-y", "1080", "-s", str(CLI_SPP),
        "--save-state", "--checkpoint", "ck.npz", "-o", "out.png")
    states = sorted(os.listdir(os.path.join(cwd, "data", "states"))) \
        if rc1 == 0 else []
    files1 = sorted(os.listdir(cwd))
    round_trip = False
    if len(states) == 1:
        path = os.path.join(cwd, "data", "states", states[0])
        loaded = Settings()
        state_io.load_state(path, loaded)
        again = os.path.join(fresh_dir(), "state.dat")
        state_io.save_state(again, loaded)
        fresh = os.path.join(fresh_dir(), "state.dat")
        state_io.save_state(fresh, Settings())
        with open(path, "rb") as a, open(again, "rb") as b, \
                open(fresh, "rb") as c:
            got = a.read()
            round_trip = got == b.read() == c.read()
    rc2, out2, err2, s2 = run_cli(
        cwd, scene, "-x", "1920", "-y", "1080", "--wavefront", "24",
        "--preview-every", "8", "--checkpoint", "ck.npz", "-o", "wf.png")
    frames = sorted(f for f in os.listdir(cwd) if f.startswith("wf_f"))
    out = dict(phase="cli", card=card, scene=scene,
               spp_run=dict(exit=rc1, seconds=s1, files=files1,
                            states=states, state_round_trip=round_trip,
                            stdout=out1.strip().splitlines()[-6:],
                            stderr=err1.strip().splitlines()[-4:]),
               wavefront_run=dict(exit=rc2, seconds=s2, frames=frames,
                                  stdout=out2.strip().splitlines()[-8:],
                                  stderr=err2.strip().splitlines()[-4:]))
    emit(out)
    want1 = {"ck.npz", "out.png", "out.hdr", "data"}
    if rc1 or not want1 <= set(files1) or not round_trip:
        raise AssertionError(f"12c: the -s {CLI_SPP} run failed")
    if rc2 or "Loaded render state" not in out2 or \
            "resumed checkpoint" not in out2 or \
            frames != ["wf_f0001.png", "wf_f0002.png"] or \
            not os.path.exists(os.path.join(cwd, "wf.hdr")):
        raise AssertionError("12c: the --wavefront run failed")


# ---------------------------------------------------------------------------
# Phase 13: the flat pixel ring and the PLY loader
# ---------------------------------------------------------------------------

def scatter_timing(seg, data, num_pixels, what):
    """The flat ring's film scatter (``integrator_wf.scatter_pixels``: a
    zeroed [num_pixels + 1, C] buffer and one index_add_) on one recorded
    call: its device time and its byte bound (the pixel ids and records
    read once, the [num_pixels, C] sums written once)."""
    from fluctus_tpu_torch.core import integrator_wf as wf
    m, c = data.shape
    b_ms, b_by = bound(m * c, nbytes(seg, data) + num_pixels * c * 4)
    return dict(**kernel_ms(lambda: wf.scatter_pixels(seg, data,
                                                      num_pixels)),
                bound_ms=b_ms, bound_by=b_by, cell=what,
                shape=f"{m} records x {c} channels into {num_pixels} + 1 "
                      f"buckets, {int((seg < num_pixels).sum())} splats")


def flat_kernels(rec_calls):
    """K1-K3 vs their plain versions on the recorded calls of segments 2
    and 4 of the flat path (phase 2's helpers; no K4 call there)."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    if any(name == "splat" for _, name in rec_calls):
        raise AssertionError("13a: K4 ran on the flat ring")
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol"], _ = check_trace("trace_rol", mt.trace_rol,
                                      mt.trace_rol_plain, rec_calls, 256)
    res["resolve_v5"], _ = check_resolve("resolve_v5", mt.resolve_v5,
                                         mt.resolve_v5_plain, rec_calls)
    return res


def film_diff(fa, fb):
    """Two films: weights equal, and the largest rgb difference."""
    import torch
    ca, cb = torch.stack(list(fa.color)), torch.stack(list(fb.color))
    return dict(weights_equal=bool(torch.equal(fa.weight, fb.weight)),
                rgb_max_abs_err=float((ca - cb).abs().max()),
                rgb_close=bool(torch.allclose(ca, cb, rtol=FLAT_RTOL,
                                              atol=FLAT_ATOL)))


FLAT_ENV_SCRIPT = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
for ring_env in ("0", None):
    if ring_env is None:
        os.environ.pop("FLT_BLOCK_RING")
    r = cs.make_renderer(256, 144, "cuda", data_dir=sys.argv[1])
    r.init_wavefront(1 << 16)
    r.render_wavefront(2)
    print(f"FLT_BLOCK_RING={os.environ.get('FLT_BLOCK_RING')}",
          f"ring={'block' if r._wf_cfg.block_ring else 'flat'}",
          f"samples={r.wavefront_stats().samples}",
          f"weight={int(r.wavefront_film().weight.sum())}", flush=True)
"""


def flat_env_run(data_dir):
    """Phase 13e: a subprocess started with FLT_BLOCK_RING=0 renders 2
    segments at 256x144 and says which ring it took; then, with the
    variable removed, the same (the block-ring control)."""
    env = dict(os.environ, PYTHONPATH=os.getcwd(), FLT_BLOCK_RING="0")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", FLAT_ENV_SCRIPT, data_dir],
                       env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in p.stdout.splitlines()
             if ln.startswith("FLT_BLOCK_RING=")]
    out = dict(exit=p.returncode, seconds=time.perf_counter() - t0,
               lines=lines, stderr=p.stderr.strip().splitlines()[-4:])
    ok = (p.returncode == 0 and len(lines) == 2
          and lines[0].startswith("FLT_BLOCK_RING=0 ring=flat")
          and lines[1].startswith("FLT_BLOCK_RING=None ring=block")
          and all(ln.split()[2][8:] == ln.split()[3][7:] for ln in lines))
    return out, ok


def write_ply(path, scene_file=LUXBALL):
    """``scene_file``'s triangles as an ASCII PLY: three vertices of its
    own (x, y, z, nx, ny, nz) a triangle, and the triangle faces."""
    import numpy as np
    from fluctus_tpu_torch.scene import Scene
    sc = Scene()
    sc.load_model(scene_file)
    p, n, _, _ = sc.triangle_arrays()
    m = p.shape[0]
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {3 * m}\n"
                + "".join(f"property float {a}\n"
                          for a in ("x", "y", "z", "nx", "ny", "nz"))
                + f"element face {m}\nproperty list uchar int "
                  "vertex_indices\nend_header\n")
        np.savetxt(f, np.concatenate([p, n], axis=2).reshape(3 * m, 6),
                   fmt="%.9g")
        np.savetxt(f, np.concatenate([np.full((m, 1), 3), np.arange(
            3 * m).reshape(m, 3)], axis=1), fmt="%d")
    return m


def phase_flat(card, exact_line, plain_main):
    """Phases 13a-13f (see the module docstring). ``exact_line`` is phase
    5b's timed exact render, ``plain_main`` phase 3's timed block-ring run.
    Returns the launches of 13a's and 13c's timed runs."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core import integrator_wf as wf
    data_dir = fresh_dir()

    # 13a: free-running on the flat ring: K1-K3 held, timed, profiled
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir, switches=FLAT)
    if r.config.block_ring:
        raise AssertionError("13a: the config is on the block ring")
    kres = flat_kernels(record_segments(r))
    emit(dict(phase="flat_kernels_vs_plain", card=card, scene=LUXBALL,
              **kres))
    la, main = phase_main(r, card, LUXBALL, SEGMENTS, PER_SEGMENT_FLAT,
                          extra=dict(cell="13a flat ring",
                                     block_ring=r._wf_cfg.block_ring))
    if r._wf_cfg.block_ring:
        raise AssertionError("13a: the pool is on the block ring")
    film_k1 = r.wavefront_film()
    with LastCalls(wf, "scatter_pixels", keep=1) as rec:
        r.render_wavefront(1)
    scatter = {"channels_4": scatter_timing(*rec.calls[0], "13a")}
    prof = profile_segments(r, card, main["ms_per_segment"])
    emit(dict(phase="flat_cost", card=card,
              ms_per_segment=main["ms_per_segment"],
              mrays_per_s=main["mrays_per_s"],
              device_ms_per_segment=prof["device_ms_per_segment"],
              index_add_us_per_segment=prof["index_add_us_per_segment"],
              index_add_share=prof["index_add_share"],
              scatter=scatter["channels_4"],
              block_ring=dict(ms_per_segment=plain_main["ms_per_segment"],
                              mrays_per_s=plain_main["mrays_per_s"])))
    phase_parity(LUXBALL, switches=FLAT, flat=True)

    # 13c: the same 24 segments with wf_splat_every set, which the port
    # accepts and ignores: 13a's counters and film
    r.settings.wf_splat_every = FLAT_SPLAT_EVERY
    lc, again = phase_main(r, card, LUXBALL, SEGMENTS, PER_SEGMENT_FLAT,
                           extra=dict(cell="13c flat ring, splat every "
                                           f"{FLAT_SPLAT_EVERY}"))
    diff = film_diff(r.wavefront_film(), film_k1)
    same = again["rays"] == main["rays"]
    # what the reference's batching would scatter at once: one index_add_
    # of 4 segments' records (against 4 of 13a's single ones)
    with LastCalls(wf, "scatter_pixels", keep=FLAT_SPLAT_EVERY) as rec:
        r.render_wavefront(FLAT_SPLAT_EVERY)
    segs, datas, npx = zip(*rec.calls)
    scatter["batch"] = scatter_timing(torch.cat(segs), torch.cat(datas),
                                      npx[0], "13c")
    emit(dict(phase="flat_splat_every", card=card, k=FLAT_SPLAT_EVERY,
              ms_per_segment=again["ms_per_segment"],
              mrays_per_s=again["mrays_per_s"],
              k1_ms_per_segment=main["ms_per_segment"],
              counters_equal=same, scatter_batch=scatter["batch"], **diff))
    if not (same and diff["weights_equal"] and diff["rgb_close"]):
        raise AssertionError(f"13c: the film with wf_splat_every set "
                             f"differs from 13a's: counters {same}, {diff}")
    r.settings.wf_splat_every = 1

    # 13d: the denoiser on the flat ring
    r.settings.use_denoiser = True
    r.rebuild_config()
    r.init_wavefront(1 << 20)
    with LastCalls(wf, "scatter_pixels", keep=1) as rec:
        r.render_wavefront(4)
    r.wavefront_film()
    f = r.features
    wts = torch.stack([f.albedo_w, f.normal_w])
    whole = bool((wts == torch.round(wts)).all() and (wts >= 0).all()
                 and float(f.normal_w.sum()) > 0)
    finite = bool(torch.isfinite(r.denoised_tensor()).all())
    scatter["channels_8"] = scatter_timing(*rec.calls[0], "13d")
    emit(dict(phase="flat_denoiser", card=card, segments=4,
              block_ring=r._wf_cfg.block_ring, feature_weights_whole=whole,
              normal_w_max=float(f.normal_w.max()), denoised_finite=finite,
              scatter=scatter["channels_8"]))
    if r._wf_cfg.block_ring or not (whole and finite):
        raise AssertionError(f"13d: whole weights {whole}, finite {finite}")
    del r, film_k1
    torch.cuda.empty_cache()

    # 13b: the default config (block ring, 4096 groups) with a pool the
    # groups do not divide: render_single_wavefront falls to the flat ring
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single_wavefront(FLAT_SPP, num_tasks=FLAT_POOL)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    lx, plain = counts()
    exact = bool((r._wf_state.spp == FLAT_SPP).all()
                 and (film.weight == FLAT_SPP).all())
    mean = float(r.ldr_image().mean())
    bias = abs(mean - exact_line["tonemapped_mean"]) / \
        exact_line["tonemapped_mean"]
    out = dict(phase="flat_exact", card=card, paths=FLAT_POOL,
               groups=r.config.groups, config_block_ring=r.config.block_ring,
               block_ring=r._wf_cfg.block_ring, spp=FLAT_SPP,
               seconds=elapsed, segments=len(r._wf_counters),
               mrays_per_s=r.perf_mrays(elapsed)["total"],
               spp_and_weight_exact=exact, tonemapped_mean=mean,
               block_ring_run=dict(
                   seconds=exact_line["seconds"],
                   segments=exact_line["segments"],
                   mrays_per_s=exact_line["mrays_per_s"],
                   tonemapped_mean=exact_line["tonemapped_mean"]),
               relative_bias=bias, gate=BIAS_GATE, launches=lx)
    emit(out)
    check_launches(lx, plain, PER_SEGMENT_FLAT, len(r._wf_counters),
                   "13b flat exact path")
    if not (r.config.block_ring and not r._wf_cfg.block_ring and exact
            and bias < BIAS_GATE):
        raise AssertionError(f"13b failed: {out}")
    del r, film
    torch.cuda.empty_cache()

    # 13e: FLT_BLOCK_RING=0 in a subprocess, and the block-ring control
    env_out, ok = flat_env_run(data_dir)
    emit(dict(phase="flat_env", card=card, **env_out))
    if not ok:
        raise AssertionError("13e: FLT_BLOCK_RING=0 was not honoured")

    # 13f: luxball's triangles as an ASCII PLY, loaded cold, then warm
    ply_dir = fresh_dir()
    ply = os.path.join(ply_dir, "luxball.ply")
    tris = write_ply(ply)
    loads = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = make_renderer(1920, 1080, "cuda", ply, data_dir=ply_dir,
                          switches=FLAT)
        loads.append(dict(seconds=time.perf_counter() - t0,
                          cache_hit=r.cache_hit, steps=r.load_seconds))
    r.init_wavefront(1 << 20)
    r.render_wavefront(4)
    film = r.wavefront_film()
    finite = bool(all(torch.isfinite(c).all() for c in film.color))
    out = dict(phase="ply", card=card, triangles=r.scene.num_triangles,
               ply_bytes=os.path.getsize(ply), cold=loads[0],
               warm=loads[1], block_ring=r._wf_cfg.block_ring,
               film_finite=finite,
               pixels_covered=float((film.weight > 0).float().mean()))
    emit(out)
    if not (tris == r.scene.num_triangles == LUXBALL_TRIANGLES and finite
            and loads[0]["cache_hit"] == dict(bvh=False, tables=False)
            and loads[1]["cache_hit"] == dict(bvh=True, tables=True)
            and not r._wf_cfg.block_ring):
        raise AssertionError(f"13f failed: {out}")
    del r, film
    torch.cuda.empty_cache()
    return {k: la[k] + lc[k] for k in la}


def sweep_build_info(kb):
    """Per instantiation of K2, K5 and K9 (closest-hit, any-hit): registers,
    spill bytes and shared memory from ptxas (-Xptxas -v), and for a
    512-ray tile the CTAs (one cluster) per tile, threads per CTA, tiles
    the card holds at once and CTAs per SM (the CUDA occupancy API)."""
    import ctypes
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name in ("trace_rol", "trace_rol_sc", "trace_ros"):
        source = f"{name}.cu"
        fn = getattr(ctypes.CDLL(kb._lib_path(source)), f"{name}_occupancy")
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        modes, cur = {}, None
        for ln in kb.build_log(source).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                # the bool template argument mangles as Lb1E / Lb0E
                cur = modes.setdefault(
                    "any_hit" if "Lb1E" in m.group(1) else "closest", {})
                continue
            if cur is None:
                continue
            for key, pat in (("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
        for mode, flag in (("closest", 0), ("any_hit", 1)):
            occ = (ctypes.c_int * 3)()
            err = fn(flag, 512, occ)
            if err:
                raise RuntimeError(f"{name} occupancy query: CUDA error {err}")
            modes.setdefault(mode, {}).update(
                ctas_per_tile=occ[1], threads_per_cta=occ[2],
                tiles_in_flight=occ[0], ctas_per_sm=occ[0] * occ[1] / sms)
        out[name] = modes
    return out


def main():
    import torch
    global TMP_ROOT
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    from fluctus_tpu_torch import kernel_build as kb
    TMP_ROOT = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(kb)
    finally:
        shutil.rmtree(TMP_ROOT, ignore_errors=True)


def run(kb):
    """Phases 1-13 (see the module docstring)."""
    import torch

    # phase 1: device and build
    card = card_line()
    t0 = time.time()
    per_source = kb.build_all()
    regs = {s: [ln.strip() for ln in kb.build_log(s).splitlines()
                if "registers" in ln or "spill" in ln]
            for s in per_source}
    emit(dict(phase="build", seconds=time.time() - t0, per_source=per_source,
              ptxas=regs, sweep=sweep_build_info(kb),
              device=torch.cuda.get_device_name(0), card=card,
              torch=torch.__version__, cuda=torch.version.cuda))

    # phase 2: kernels vs plain on the luxball path's inputs
    r = make_renderer(1920, 1080, "cuda")
    kres = phase_kernels(r, record_segments(r))
    emit(dict(phase="kernels_vs_plain", card=card, scene=LUXBALL,
              vertex_table_bytes=vertex_table_bytes(r), **kres))

    # phase 7 (luxball): K2, K5 and K9 on edge-case tiles
    check_edges(r.device_scene.mxu, LUXBALL, seed=7)

    # phase 3: luxball path, K2's arguments of its last segment kept, then
    # a profiled look at two more segments
    from fluctus_tpu_torch.accel import mxu_trace as mt
    with LastCalls(mt, "trace_rol") as late:
        launches, main = phase_main(r, card, LUXBALL, SEGMENTS, PER_SEGMENT)
    profile_segments(r, card, main["ms_per_segment"])
    late_res, _ = check_trace(
        "trace_rol", mt.trace_rol, mt.trace_rol_plain,
        {(SEGMENTS, "trace_rol"): [(a, {}) for a in late.calls]}, 256,
        segs=(SEGMENTS,))
    emit(dict(phase="trace_rol_late_segment", card=card, segment=SEGMENTS,
              trace_rol=late_res))
    kres["trace_rol"]["late_segment"] = late_res
    del r, late
    torch.cuda.empty_cache()

    # phase 4: whole-path parity, kernels vs plain versions
    phase_parity(LUXBALL)

    # phases 5 and 6: exact-spp, the megastep, rays on sublanes, pick
    r = make_renderer(1920, 1080, "cuda")
    exact_res, launches_x, exact_mean, exact_line = phase_exact(r, card)
    phase_exact_parity()
    kres.update(exact_res)
    kres["trace_ros"], launches_ros = phase_mk(r, card, exact_mean)
    del r
    torch.cuda.empty_cache()

    # phase 2b: the large path's kernels vs plain
    t0 = time.perf_counter()
    r = make_renderer(1920, 1080, "cuda", LARGE)
    host_s = time.perf_counter() - t0
    sc = r.device_scene.mxu
    scene_info = dict(triangles=r.scene.num_triangles,
                      n_clusters=sc.n_clusters,
                      n_superclusters=sc.n_superclusters,
                      host_seconds=host_s, host_steps=r.load_seconds,
                      cache_hit=r.cache_hit,
                      vertex_table_bytes=vertex_table_bytes(r))
    kres_l, primary_hit = phase_kernels_large(r, record_segments(r))
    emit(dict(phase="kernels_vs_plain", card=card, scene=LARGE, **scene_info,
              **{k: v for k, v in kres_l.items() if k != "tile_order"},
              tile_order_on_supers=kres_l["tile_order"]))
    kres.update(trace_rol_sc=kres_l["trace_rol_sc"],
                resolve_v5s=kres_l["resolve_v5s"])
    check_edges(sc, LARGE, seed=8)           # phase 7 on the 8x8 grid

    # phase 3b: the large path, K5's arguments of its last segment kept
    with LastCalls(mt, "trace_rol_sc") as late:
        launches_l, main_l = phase_main(
            r, card, LARGE, LARGE_SEGMENTS, PER_SEGMENT_LARGE,
            extra=dict(scene_info, primary_hit_share=primary_hit))
    if primary_hit < 0.9:
        raise AssertionError(f"primary-hit share {primary_hit} < 0.9")
    profile_segments(r, card, main_l["ms_per_segment"])
    late_res, _ = check_trace(
        "trace_rol_sc", mt.trace_rol_sc, mt.trace_rol_sc_plain,
        {(LARGE_SEGMENTS, "trace_rol_sc"): [(a, {}) for a in late.calls]},
        512, segs=(LARGE_SEGMENTS,), walk=sc_walk_counts)
    emit(dict(phase="trace_rol_sc_late_segment", card=card,
              segment=LARGE_SEGMENTS, trace_rol_sc=late_res))
    kres["trace_rol_sc"]["late_segment"] = late_res
    del r, late
    torch.cuda.empty_cache()

    # phase 4b: whole-path parity on the large path
    phase_parity(LARGE)

    # phase 8: the K10 route (8a-8c) and the caches (8d)
    kres["resolve_v1"], launches_k10 = phase_k10(card, main)
    phase_caches(card)

    # phase 9: the env map (9a-9e)
    phase_env(card, main)

    # phase 11: the production luxball (11a-11e)
    launches_p, prod = phase_production(card, kres)

    # phase 12: a user's render job: the denoiser (12a), checkpoint and
    # resume (12b), the CLI (12c)
    kres["block_splat"]["channels_8"], launches_d, k4_8 = phase_denoiser(
        card, prod)
    phase_resume(card)
    phase_cli(card)

    # phase 13: the flat pixel ring (13a-13e) and a PLY scene (13f)
    launches_f = phase_flat(card, exact_line, main)

    # phase 10: result lines
    main_launches = {k: launches[k] + launches_l[k] + launches_p.get(k, 0)
                     + launches_d.get(k, 0) + launches_f.get(k, 0)
                     for k in SOURCES}
    main_launches.update(
        block_splat_capped=(launches_x["block_splat_capped"]
                            + launches_p["block_splat_capped"]
                            + launches_d["block_splat_capped"]),
        fetch=launches_x["fetch"] + launches_p["fetch"] + launches_d["fetch"],
        trace_ros=launches_ros["trace_ros"],
        resolve_v1=launches_k10["resolve_v1"])
    kres["block_splat"]["channels_8"]["launches"] = k4_8
    emit(kernels_line(kres, main_launches))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
