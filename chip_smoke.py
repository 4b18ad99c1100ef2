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
14. production scene import. 14a: the 8x8 grid written as a PBRT scene
   (luxball as a PLY, 64 AttributeBegin/Translate/Material/plymesh
   blocks at the grid's positions, the materials cycling through matte,
   plastic, rough metal, glass and mirror, LookAt + Camera at the grid's
   view) loaded at 1080p under split_mode "sbvh", cold (parse, native
   SBVH, tables, upload; host seconds by step), a second time (the
   .flc.npz parse cache and hierarchy_<hash>_sbvh.bin hit; the table
   cache misses once, as in the JAX package: its key hashes the
   materials, python floats from the parse and float32 from the parse
   cache) and warm (all three hit; the PBRT loader is swapped for one
   that raises on every load after the first); the camera is the
   file's; nodes, depth, duplicate share, clusters, superclusters and
   table MiB; K1 (over superclusters), K5, K6 and K4 held to their plain
   versions on the recorded calls of segments 2 and 4, K5's visits per
   tile and times beside phase 2b's SAH numbers; LARGE_SEGMENTS timed
   segments (launches per segment as 3b), 2 profiled. 14b: the PBRT
   luxball (one plymesh) at 256x144, 4 segments under the SAH and under
   the SBVH: the camera is the file's, the tonemapped means within
   BIAS_GATE of each other, the extension rays of one segment traced on
   both trees hit the same triangle on >= 99.9% of the rays with t equal
   there, and phase 4's parity (K1-K4 against their plain versions)
   under the SBVH. 14c: 14a's table cache rewritten without B16 (slim, so
   without attrs: the tables resolve nothing), the trace's third branch
   (closest_hit_mxu_full + reconstruct_hit + resolve_material):
   PBRT_SEGMENTS timed segments with K3, K6 and K10 at 0 launches, K1
   and K5 2 a segment, K4 1, a finite film with whole weights. 14d:
   python -m fluctus_tpu_torch on 14b's file with -s PBRT_CLI_SPP and a
   settings file holding "splitMode": "sbvh": exit 0, the image, the
   SBVH's hierarchy file.
15. a user's interactive session and harness (interactive.py, viewer.py,
   bench/, profiling.py), each through its entry point. 15a:
   run_interactive on luxball at 1080p with 1M paths, depth 10, phase 9's
   env map and phase 3's view, settings.shortcuts[2] the 2x2 grid, over
   REPL_SCRIPT (camera moves, the fast preview, more, tonemap, exposure,
   a material edit, roulette, the spp cap on and off, the denoiser and
   its blend, the exact-spp integrator, the light and sampling cycles,
   pick, scale, scene 2, save, load, png): per command the wall ms, its
   render part (segments, synchronised) and its frame-write part
   (tonemap, copy to the host, PNG encode) and the frame's mean; it
   fails on an error, unknown-command or parse-error line, on a command
   that should write the frame and did not, and on a returned count
   other than the script's length. The kernel calls of segments 2 and 4
   of five commands' renders (w: the block ring at 4 channels; maxspp
   16: K7 and K8; denoise 1: K4 at 8 channels; integrator mk: the exact
   spp; scene 2: the grid's K5) are held bit for bit to their plain
   versions (K1, K2, K3, K4 at 4 and 8 channels, K5, K7, K8). 15b:
   viewer.serve at 1080p in a thread on a free port: the page's widgets,
   /state.json against _widget_state, spp 8, w, depth 5 and exposure 1.7
   POSTed and shown, the frame decoded at 1920x1080, the ms from w's POST
   to the frame, q ending the thread with a count of 5. 15c: a .bm.json
   of luxball on the wavefront (HARNESS_SECONDS) and the production
   luxball by exact-spp steps (HARNESS_SPP) at 1080p: the reference's
   CSV header, rows per scene, the images, the exact scene's spp, its
   Mrays/s beside phase 3's; run_benchmark on luxball at the fixed
   protocol's 1024x1024 for FIXED_SECONDS; profiling.profile_device_ops
   over 2 segments, its rows naming K1-K4, beside phase 3's profile. 15d:
   python -m fluctus_tpu_torch with --interactive (a piped script),
   --serve (w and q POSTed), a shortened .bm.json and --benchmark (its
   scenes absent: the three skip lines), started together, each exit 0.
16. sharding (parallel/) on luxball at 1080p with 1M paths, depth 10,
   phase 3's view and light. SHARD_RANKS gloo ranks, spawned processes
   that share the card (the parent builds the kernels first; they load
   the parent's libraries and its scene caches), each through
   parallel/'s entry points: 16a SEGMENTS segments of wf_segment_sharded
   on the block ring from a fresh sharded reset (after 2 warm-up
   segments), 16b MK_SPP samples of render_sharded, 16c
   SHARD_CAPPED_SEGMENTS segments under the spp cap (K7, K8). The parent
   holds the gathered film, spp and cursors of 16a and 16c bit for bit to
   the same shards' segments run one after another through wf_segment
   with pixel_base, every rank's reduced counters to the sums of the
   local ones, and 16b's film, seeds and stats to the unsharded
   render_sample's; per rank the launches (16a K1 2, K2 2, K3 1, K4 1 a
   segment; 16b K1 2, K2 2, K3 1 a bounce; 16c K1 2, K2 2, K3 1, K7 1, K8
   1) with no plain run; every rank's Scene.hash equal to the parent's;
   16a's tonemapped mean within SHARD_MEAN_GATE of phase 3's. The local
   simulation's last shard (pixel_base not 0: K8 and K4 on local pixel
   ids, G/D groups) records its kernel calls in segment 2 and its last
   segment on both rings, as does one render_sample over the last slice
   of the film, and each call is held bit for bit to its plain version
   (hold_recorded). A rank that
   raises, exits non-zero or outlives RANK_TIMEOUT fails the phase.
   Per-rank ms per segment and the Mrays/s of both ranks are not a
   scaling figure: the ranks share one card. 16d: a 1-rank NCCL group in
   this process: NCCL_SEGMENTS of wf_segment_sharded equal to
   wf_segment's, both timed in turns, and the counters' all_reduce alone.
17. the bitstack BVH route (scenes without tables, accel/traverse.py):
   luxball at 1080p with 1M paths, depth 10, phase 9's env map and phase
   3's light, its scene without tables built from the renderer's host data
   (the triangle arrays, the materials, the renderer's BVH), as the
   reference's Renderer uploads it off its TPU. 17a: the extension and
   shadow rays of segments 2 and 4 (recorded on the table route), through
   the kernel and the plain version (bit for bit: t, tri, u, v), timed,
   with the box and triangle tests counted by the plain version for the
   bound, beside the table route's K1 + K2 on the same segment's recorded
   calls and its whole pair trace; edge-case rays from a numpy seed
   (axis-parallel with +-0 components, origins on node boxes' planes and
   inside boxes, t_max F32_MAX, +inf, 0 and random, any-hit to the hits);
   the share of segment 2's first hits that differ from the table route's.
   17b: BVH_SEGMENTS timed segments on each route from the same seeds
   (bitstack 2 launches a segment, K4 1), ms/segment, Mrays/s, busy share,
   peak memory, the tonemapped means within the 1% bias gate; BVH_SPP
   exact samples on the bitstack route (K7, K8; spp = weight). 17c: one
   megastep sample on each route (3 traces a bounce: the extension ray,
   the env map's shadow ray, the area light's); the bitstack sample's
   traces of bounces BVH_MK_HELD (2M rays each) held bit for bit to the
   plain version, each with a hit. 17d: the 8x8 grid's segment-4 rays
   (1M), the kernel's time beside K1 and K5's on the same recorded calls,
   held to the plain version on a chunk (extension rays strided over the
   pool, shadow rays strided over its pending lanes; each with hits).
   17e: the reference's entry step (quad_scene, quad_setup(64, 64, 3),
   4096 paths): BVH_ENTRY_SEGMENTS wf_segments, each segment's traces
   held bit for bit. 17f: parallel/'s entry points on the bitstack
   luxball over a 1-rank NCCL group: wf_segment_sharded equal to
   wf_segment, render_sharded equal to render_sample, bit for bit.
10. the kernels line (launches including phases 11, 12, 13, 14, 15, 16
   and 17's runs, 16's summed over the ranks, 17's on the bitstack
   route; K4's entry with its 8-channel
   launches, as counted in 12a and 15a), the card line, then the final
   result line.

Every renderer loads with a fresh temporary ``data_dir`` (removed at the
end), so phases 2-6 load cold as before (now writing the caches) and
nothing is written under the repository's data/.

Prints nothing of the result and exits non-zero without CUDA or without
the package beside it.
"""

import contextlib
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
           "resolve_v1": "fluctus_tpu_torch/csrc/resolve_v1.cu",
           "bvh_bitstack": "fluctus_tpu_torch/csrc/bvh_bitstack.cu"}
REPLACES = {"tile_order": "fluctus_tpu/accel/mxu_trace.py:1056",
            "trace_rol": "fluctus_tpu/accel/mxu_trace.py:736",
            "resolve_v5": "fluctus_tpu/accel/mxu_trace.py:1745",
            "block_splat": "fluctus_tpu/core/block_splat.py:103",
            "trace_rol_sc": "fluctus_tpu/accel/mxu_trace.py:832",
            "resolve_v5s": "fluctus_tpu/accel/mxu_trace.py:1894",
            "block_splat_capped": "fluctus_tpu/core/block_splat.py:116",
            "fetch": "fluctus_tpu/core/block_splat.py:147",
            "trace_ros": "fluctus_tpu/accel/mxu_trace.py:630",
            "resolve_v1": "fluctus_tpu/accel/mxu_trace.py:1669",
            "bvh_bitstack": "fluctus_tpu/accel/traverse.py:150 _traverse "
                            "(not a Pallas kernel)"}


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
    from fluctus_tpu_torch.accel import mxu_trace as mt
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol"], _ = check_trace("trace_rol", mt.trace_rol,
                                      mt.trace_rol_plain, rec_calls, 256)
    res["resolve_v5"], _ = check_resolve("resolve_v5", mt.resolve_v5,
                                         mt.resolve_v5_plain, rec_calls)
    check_splats(rec_calls, what)
    return res


def check_splats(rec_calls, what):
    """K4 on its recorded calls of segments 2 and 4, all channels bit for
    bit against its plain version."""
    import torch
    from fluctus_tpu_torch.core import block_splat as bs
    for seg in (2, 4):
        for args, kw in rec_calls[(seg, "splat")]:
            got = bs.splat(*args, **kw)
            ref = bs.splat_plain(*args, **kw)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K4 differs from its plain version "
                                     f"({what}, segment {seg})")


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
    from fluctus_tpu_torch import profiling
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
        if profiling.is_device_op(e):
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
    segments = r._wf_segments
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
        return r._wf_segments
    # the second render runs under the profiler
    profile_segments(r, card, elapsed / segments * 1e3, run=accumulate)
    film = r.film
    again = r._wf_segments
    spp = unpad_pixels(r._wf_state.spp, r.config)
    acc = bool((spp == 2 * EXACT_SPP).all()
               and (film.weight == 2 * EXACT_SPP).all())
    r.render_wavefront(2)
    reinit = (r._wf_cfg.max_spp == 0 and not r._wf_exact_mode
              and float(r.current_film().weight.sum()) > 0)
    emit(dict(phase="exact_accumulate", segments=again,
              wavefront_segments=r._wf_segments, accumulated_exact=acc,
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
    free-running runs (3, 3b, 11, 12a, 13a and 13c on the flat ring,
    where K4, K7 and K8 launch 0 times, 14a on the SBVH grid and 14c on
    its tables without B16), K7 and K8 in the timed exact
    renders (5b, 11c, 12a), K9 in the rays-on-sublanes render (6b), K10 in
    the free-running run on tables without B16 (8b); K1-K5, K7 and K8
    also over 15a's interactive session; K1-K4, K7 and K8 also over phase
    16's sharded runs (both ranks, and 16d's); the bitstack traversal
    (17a, luxball's segment-4 bounce rays) over phase 17's renders on its
    route (17b's timed run and exact render, 17c's megastep sample, 17e's
    entry step, 17f's sharded runs; K4, K7 and K8 also count 17b's and
    17f's launches), with the table route's K1 + K2 time on the same rays and
    its time and K5's on the 8x8 grid's (17d). K4's entry also carries its
    8-channel calls (12a and 15a: the denoiser's features), with their
    launches in those runs."""
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
        for key in ("table_k1_k2_ms", "grid_ms", "grid_k5_closest_ms"):
            if key in k:                # the bitstack kernel's yardsticks
                entry[key] = k[key]
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
    segments = r._wf_segments
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
    from fluctus_tpu_torch import profiling
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
        if profiling.is_device_op(e):
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
    segments = r._wf_segments
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
    segments = r._wf_segments
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
    segments = r._wf_segments
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
               seconds=elapsed, segments=r._wf_segments,
               mrays_per_s=r.perf_mrays(elapsed)["total"],
               spp_and_weight_exact=exact, tonemapped_mean=mean,
               block_ring_run=dict(
                   seconds=exact_line["seconds"],
                   segments=exact_line["segments"],
                   mrays_per_s=exact_line["mrays_per_s"],
                   tonemapped_mean=exact_line["tonemapped_mean"]),
               relative_bias=bias, gate=BIAS_GATE, launches=lx)
    emit(out)
    check_launches(lx, plain, PER_SEGMENT_FLAT, r._wf_segments,
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


# ---------------------------------------------------------------------------
# Phase 14: production scene import: PBRT, the SBVH, the trace's third branch
# ---------------------------------------------------------------------------

# the PBRT grid's materials, cycling over the 64 luxballs: matte, plastic,
# rough metal, glass and mirror (diffuse, glossy, GGX rough reflection,
# ideal dielectric, ideal reflection)
PBRT_MATERIALS = (
    '"matte" "rgb Kd" [0.6 0.6 0.6]',
    '"plastic" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0.4 0.4 0.4] '
    '"float roughness" [0.05]',
    '"metal" "float roughness" [0.2]',
    '"glass" "float index" [1.5]',
    '"mirror" "rgb Kr" [0.9 0.9 0.9]')
SBVH = {"split_mode": "sbvh"}
PBRT_SEGMENTS = 4          # 14b and 14c
PBRT_CLI_SPP = 4
PER_SEGMENT_BARE = {**PER_SEGMENT_LARGE, "resolve_v5s": 0}


def write_pbrt(out_dir, name, view, blocks):
    """``name``.pbrt in ``out_dir``: the camera of ``view`` (a VIEWS
    entry) as LookAt + Camera, then one AttributeBegin block per (x, y,
    z, material) of ``blocks``, each a Translate, a Material and the
    luxball as a plymesh (luxball.ply, written here once). The file's
    path is registered in VIEWS under the view, for its area light."""
    ply = os.path.join(out_dir, "luxball.ply")
    if not os.path.exists(ply):
        write_ply(ply)
    (px, py, pz), (dx, dy, dz) = view[0], view[1]
    lines = [f"LookAt {px} {py} {pz}  {px + dx} {py + dy} {pz + dz}  0 1 0",
             'Camera "perspective" "float fov" [60]', "WorldBegin"]
    for x, y, z, mat in blocks:
        lines += ["AttributeBegin", f"  Translate {x} {y} {z}",
                  f"  Material {mat}",
                  '  Shape "plymesh" "string filename" "luxball.ply"',
                  "AttributeEnd"]
    path = os.path.join(out_dir, f"{name}.pbrt")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["WorldEnd", ""]))
    VIEWS[path] = view
    return path


def write_pbrt_grid(out_dir):
    """Phase 14a's scene: the 8x8 grid's luxballs at the positions of
    scenes/luxball_grid_8x8.sc.json, seen from its view."""
    with open(LARGE) as f:
        entries = json.load(f)
    return write_pbrt(out_dir, "grid", VIEWS[LARGE], [
        (*e["translation"], PBRT_MATERIALS[i % len(PBRT_MATERIALS)])
        for i, e in enumerate(entries)])


def camera_gate(r, what):
    """The renderer's camera is the PBRT file's (dir as normalized by
    _calc_camera_rotation)."""
    import numpy as np
    c, co = r.settings.camera, r.scene.camera_override
    ok = (co is not None and c.pos == co.pos and c.up == co.up
          and c.right == co.right and c.fov == co.fov
          and np.allclose(c.dir, co.dir, rtol=0, atol=1e-7))
    if not ok:
        raise AssertionError(f"{what}: the camera is not the file's")
    return dict(pos=[float(x) for x in c.pos],
                dir=[float(x) for x in c.dir], fov=float(c.fov))


def table_mib(sc):
    """MiB of the device tables' tensors."""
    import torch
    return sum(t.numel() * t.element_size() for t in sc
               if isinstance(t, torch.Tensor)) / 2 ** 20


def load_pbrt_sbvh(path, data_dir, warm):
    """make_renderer at 1080p under split_mode "sbvh"; on a warm load the
    PBRT parse must come from its .flc.npz (the loader is swapped for one
    that raises). Returns (renderer, a line: host seconds by step, the
    cache hits and the SBVH's build line)."""
    import contextlib
    import io
    from fluctus_tpu_torch.scene import pbrt_loader
    parse = pbrt_loader.load_pbrt

    def refuse(*a, **k):
        raise AssertionError("14a: the warm load parsed the .pbrt")
    if warm:
        pbrt_loader.load_pbrt = refuse
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            r = make_renderer(1920, 1080, "cuda", path, data_dir=data_dir,
                              switches=SBVH)
    finally:
        pbrt_loader.load_pbrt = parse
    line = dict(host_seconds=time.perf_counter() - t0,
                load_seconds=r.load_seconds,
                cache_hit=dict(r.cache_hit, parse=warm),
                log=[ln for ln in log.getvalue().splitlines()
                     if ln.startswith(("SBVH", "BVH", "MXU"))])
    return r, line


def phase_pbrt_grid(card, sah_large):
    """Phase 14a: the 8x8 grid as a PBRT scene under the SBVH, cold then
    warm; K1 (over superclusters), K5, K6 and K4 held to their plain
    versions on recorded calls, LARGE_SEGMENTS timed segments, 2
    profiled; K5 beside phase 2b's SAH numbers (``sah_large``). Returns
    (launches of the timed run, the data_dir, the grid's path)."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    d = fresh_dir()
    path = write_pbrt_grid(d)
    loads = []
    for warm in (False, True, True):
        r, line = load_pbrt_sbvh(path, d, warm)
        loads.append(line)
        if len(loads) < 3:
            del r
            torch.cuda.empty_cache()
    cold, second, warm = loads
    bvh, sc = r._bvh_host, r.device_scene.mxu
    m = r.scene.num_triangles
    info = dict(triangles=m, nodes=int(bvh.num_nodes),
                depth=bvh.depth(), references=int(len(bvh.indices)),
                duplicate_share=(len(bvh.indices) - m) / m,
                n_clusters=sc.n_clusters,
                n_superclusters=sc.n_superclusters,
                table_mib=table_mib(sc), camera=camera_gate(r, "14a"))
    emit(dict(phase="pbrt_sbvh_load", card=card, scene=path, cold=cold,
              second=second, warm=warm, **info))
    # the second load misses the table cache once, in both packages: the
    # cache's key hashes the materials, which the parse gives as python
    # floats and the parse cache as float32 (ROADMAP, reference caveats)
    hits = [ld["cache_hit"] for ld in loads]
    if hits != [dict(bvh=False, tables=False, parse=False),
                dict(bvh=True, tables=False, parse=True),
                dict(bvh=True, tables=True, parse=True)]:
        raise AssertionError(f"14a: cache hits {hits}")
    if sc.n_clusters <= mt.SC_THRESHOLD or sc.sc_box is None:
        raise AssertionError("14a: the grid is not on the supercluster tier")
    rec = record_segments(r)
    kres, primary_hit = phase_kernels_large(r, rec)
    check_splats(rec, "14a")
    k5 = kres["trace_rol_sc"]
    emit(dict(phase="kernels_vs_plain", card=card, scene=path,
              split_mode="sbvh", primary_hit_share=primary_hit,
              tile_order_on_supers=kres["tile_order"], trace_rol_sc=k5,
              resolve_v5s=kres["resolve_v5s"], block_splat="bit-equal",
              trace_rol_sc_sah_2b={k: sah_large[k] for k in (
                  "ms", "visits_p50", "visits_p99", "visits_max",
                  "pairs_per_s", "any_hit", "shape")}))
    launches, main = phase_main(r, card, path, LARGE_SEGMENTS,
                                PER_SEGMENT_LARGE,
                                extra=dict(info, split_mode="sbvh"))
    profile_segments(r, card, main["ms_per_segment"])
    del r, rec
    torch.cuda.empty_cache()
    return launches, d, path


def phase_pbrt_parity(card):
    """Phase 14b: the PBRT luxball (one plymesh) at 256x144, 4 segments,
    under the SAH and under the SBVH: the camera is the file's; the
    tonemapped means within BIAS_GATE of each other; from the SBVH run's
    pool after 3 segments, the extension rays traced on both trees hit
    the same triangle on >= 99.9% of the rays, with t equal where they
    do; K1-K4 held to their plain versions by phase 4's parity under the
    SBVH."""
    import torch
    from fluctus_tpu_torch.core.trace import trace_extension
    d = fresh_dir()
    view = VIEWS[LUXBALL]
    path = write_pbrt(d, "luxball", view,
                      [(0.0, 0.0, 0.0, PBRT_MATERIALS[0])])
    runs = {}
    for mode in ("sah", "sbvh"):
        r = make_renderer(256, 144, "cuda", path,
                          switches={"split_mode": mode})
        cam = camera_gate(r, "14b")
        r.init_wavefront(1 << 16)
        r.render_wavefront(PBRT_SEGMENTS - 1)
        pool = r._wf_state.pool
        r.render_wavefront(1)
        runs[mode] = dict(r=r, mean=float(r.ldr_image().mean()),
                          rays=(pool.orig, pool.dir))
    o, dr = runs["sbvh"]["rays"]
    hits = {mode: trace_extension(o, dr, runs[mode]["r"].device_scene, None,
                                  False) for mode in runs}
    a, b = hits["sah"], hits["sbvh"]
    same = a.i == b.i
    share = float(same.float().mean())
    t_equal = bool(torch.equal(a.t[same], b.t[same]))
    ma, mb = runs["sah"]["mean"], runs["sbvh"]["mean"]
    rel = abs(mb - ma) / max(abs(ma), 1e-12)
    trees = {mode: dict(nodes=int(runs[mode]["r"]._bvh_host.num_nodes),
                        references=int(len(runs[mode]["r"]._bvh_host
                                           .indices)),
                        n_clusters=runs[mode]["r"].device_scene.mxu
                        .n_clusters) for mode in runs}
    del runs, hits, a, b
    parity = phase_parity(path, switches=SBVH)
    out = dict(phase="pbrt_tree_parity", card=card, scene=path,
               triangles=LUXBALL_TRIANGLES, camera=cam, trees=trees,
               image_mean_sah=ma, image_mean_sbvh=mb, mean_rel_diff=rel,
               hit_share_same_triangle=share, t_equal_where_same=t_equal,
               rays=int(same.numel()),
               kernel_parity_film_max_abs_err=parity["film_max_abs_err"])
    emit(out)
    if rel > BIAS_GATE or share < 0.999 or not t_equal:
        raise AssertionError(f"14b failed: {out}")
    return path


def phase_third_branch(card, data_dir, path):
    """Phase 14c: the grid's SBVH table cache (14a's) rewritten without
    B16 (slim, so without attrs too): the tables resolve nothing, the
    trace takes its third branch (closest_hit_mxu_full, reconstruct_hit,
    resolve_material). PBRT_SEGMENTS timed segments after one warm-up:
    K3, K6 and K10 launch 0 times, K1 and K5 twice a segment, K4 once; a
    finite film with whole weights. Returns the timed run's launches."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core.trace import has_resolve_tables
    from fluctus_tpu_torch.renderer import table_cache_path
    from fluctus_tpu_torch.scene import Scene
    scene = Scene()
    scene.load_model(path)
    cache = table_cache_path(data_dir, scene, "sbvh", True)
    host, statics = mt.load_table_cache(cache)
    mt.write_table_cache(cache, dict(host, b16t=None, attr_b16=None),
                         statics)
    del host, scene
    r = make_renderer(1920, 1080, "cuda", path, data_dir=data_dir,
                      switches=SBVH)
    ds = r.device_scene
    if has_resolve_tables(ds) or ds.tris is None or ds.mats is None:
        raise AssertionError("14c: the tables still resolve")
    r.init_wavefront(1 << 20)
    r.render_wavefront(1)
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    r.render_wavefront(PBRT_SEGMENTS)
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kb.KERNELS.values()}
    plain = {k.name: k.plain_runs for k in kb.KERNELS.values()}
    film = r.wavefront_film()
    w = film.weight
    finite = bool(all(torch.isfinite(c).all() for c in film.color))
    whole = bool(torch.equal(w, torch.round(w)))
    out = dict(phase="third_branch", card=card, scene=path,
               segments=PBRT_SEGMENTS, paths=1 << 20,
               ms_per_segment=elapsed / PBRT_SEGMENTS * 1e3,
               txy_t=ds.mxu.txy_t is not None, table_mib=table_mib(ds.mxu),
               launches=launches, plain_runs=plain, film_finite=finite,
               whole_weights=whole, cache_hit=r.cache_hit,
               pixels_covered=float((w > 0).float().mean()))
    emit(out)
    want = {k: v * PBRT_SEGMENTS for k, v in PER_SEGMENT_BARE.items()}
    if {k: launches[k] for k in want} != want or any(plain.values()) \
            or not (finite and whole and float(w.sum()) > 0):
        raise AssertionError(f"14c failed: {out}")
    del r, ds, film
    torch.cuda.empty_cache()
    return launches


def phase_pbrt_cli(card, path):
    """Phase 14d: python -m fluctus_tpu_torch on the PBRT luxball (14b's
    file) with -s PBRT_CLI_SPP and a settings file holding
    "splitMode": "sbvh" (the reference's key) in a fresh directory: exit
    0, the image written, the SBVH built and cached under data/."""
    cwd = fresh_dir()
    settings = os.path.join(cwd, "sbvh.json")
    with open(settings, "w") as f:
        json.dump({"release": {"splitMode": "sbvh"}, "debug": {}}, f)
    rc, out, err, secs = run_cli(
        cwd, os.path.abspath(path), "-x", "1920", "-y", "1080", "-s",
        str(PBRT_CLI_SPP), "--settings", settings, "-o", "pbrt.png")
    hier = os.path.join(cwd, "data", "hierarchies")
    files = sorted(os.listdir(hier)) if os.path.isdir(hier) else []
    line = dict(phase="pbrt_cli", card=card, exit=rc, seconds=secs,
                hierarchies=files, outputs=sorted(os.listdir(cwd)),
                stdout=out.strip().splitlines()[-6:],
                stderr=err.strip().splitlines()[-4:])
    emit(line)
    if rc or "SBVH(native):" not in out or not any(
            f.endswith("_sbvh.bin") for f in files) or not os.path.exists(
            os.path.join(cwd, "pbrt.png")):
        raise AssertionError("14d: the CLI run failed")


# ---------------------------------------------------------------------------
# Phase 15: the interactive session, the viewer, the harness, the CLI
# ---------------------------------------------------------------------------

GRID2 = "fluctus_tpu_torch/scenes/luxball_grid_2x2.sc.json"
SESSION_SIZE = (1920, 1080)
SESSION_PATHS = 1 << 20
FIXED_SIZE = (1024, 1024)   # the fixed protocol's (tracer.cpp:391)
# 15a's script; the commands on which a route's kernel calls are recorded
# (segments 2 and 4 of the command's render) and held to the plain versions
REPL_SCRIPT = ["spp 8", "w", "look 10 0", "preview 1", "d", "preview 0",
               "more 8", "tonemap 2", "exposure 1.5", "mats",
               "mat 0 kd 0.8 0.2 0.2", "rr 1", "maxspp 16", "maxspp 0",
               "denoise 1", "blend 0.5", "denoise 0", "integrator mk",
               "more 4", "integrator wf", "light", "sampling",
               "pick 0.35 0.45", "scale 0.5", "scale 1", "scene 2", "save",
               "load", "png {png}", "q"]
REPL_ROUTES = {"w": "block ring, 4 channels", "maxspp 16": "spp cap",
               "denoise 1": "8 channels", "integrator mk": "exact spp",
               "scene 2": "2x2 grid"}
# the commands that write the frame (a restart, a refinement or a repost)
FRAME_OPS = {"w", "look", "d", "more", "tonemap", "exposure", "mat", "rr",
             "maxspp", "denoise", "blend", "integrator", "light",
             "sampling", "pick", "scale", "scene", "load"}
REPL_FAULTS = ("  error:", "  ?", "  parse error")
WIDGET_IDS = ("integrator", "depth", "rr", "maxspp", "scale", "fov",
              "speed", "aperture", "tonemap", "exposure", "denoise",
              "blend", "envstrength", "al_size", "al_int", "al_color")
# the reference's CSV schema (tracer.cpp:428), byte for byte
CSV_HEADER = "scene;time;primary;extension;shadow;total;samples"
HARNESS_SECONDS = 6
HARNESS_SPP = 4
FIXED_SECONDS = 5
CONTROL_SECONDS = 3
# the kernels phase 15 must launch: K4 at 4 and 8 channels, K7, K8, K5
PHASE15_KERNELS = ("tile_order", "trace_rol", "resolve_v5", "block_splat",
                   "trace_rol_sc", "block_splat_capped", "fetch")


class SessionRecorder(Recorder):
    """The kernel wrappers' arguments in segments 2 and 4 of the commands
    that ``command(i, route)`` names a route for, keyed ((route, segment),
    kernel); segments are counted by the renderer's calls of
    wf_trace_phase (free-running) and wf_segment (exact spp)."""

    def __init__(self):
        super().__init__()
        from fluctus_tpu_torch.core import block_splat as bs
        self.targets.append((bs, "fetch"))
        self.route, self.seg = None, 0

    def command(self, route):
        self.route, self.seg, self.active = route, 0, None

    def __enter__(self):
        super().__enter__()
        import fluctus_tpu_torch.renderer as rmod
        self.rmod = rmod
        self.rorig = (rmod.wf_trace_phase, rmod.wf_segment)

        def counted(fn):
            def run(*a, **k):
                self.seg += 1
                self.active = ((self.route, self.seg) if self.route
                               and self.seg in (2, 4) else None)
                return fn(*a, **k)
            return run
        rmod.wf_trace_phase, rmod.wf_segment = map(counted, self.rorig)
        return self

    def __exit__(self, *exc):
        self.rmod.wf_trace_phase, self.rmod.wf_segment = self.rorig
        super().__exit__(*exc)


def frame_sig(path):
    """(mtime_ns, inode, size) of a file, or None: os.replace of a new
    frame changes it even when the image is the same."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return (st.st_mtime_ns, st.st_ino, st.st_size)


def png_mean(path):
    """The mean 8-bit value of a PNG file and its (width, height)."""
    import numpy as np
    from PIL import Image
    with Image.open(path) as im:
        return float(np.asarray(im.convert("RGB")).mean()), im.size


class TimedScript:
    """run_interactive's input: yields the script's lines and records, per
    command, the wall ms from its line to the REPL asking for the next,
    the render part (the render calls, each ended by a synchronize), the
    frame-write part (save_image / save_denoised: tonemap, copy to the
    host, PNG encode) and whether the frame file was rewritten."""

    def __init__(self, r, lines, frame, rec):
        import torch
        self.lines, self.frame, self.rec, self.rows = lines, frame, rec, []
        self.parts = {}
        for name, part in (("render_wavefront", "render"),
                           ("render_single", "render"),
                           ("wavefront_preview_film", "render"),
                           ("save_image", "write"),
                           ("save_denoised", "write")):
            setattr(r, name, self._timed(getattr(r, name), part, torch))

    def _timed(self, fn, part, torch):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.parts[part] = self.parts.get(part, 0.0) \
                + time.perf_counter() - t0
            return out
        return run

    def __iter__(self):
        for line in self.lines:
            self.rec.command(REPL_ROUTES.get(line))
            before = frame_sig(self.frame)
            self.parts = {}
            t0 = time.perf_counter()
            yield line + "\n"
            wall = time.perf_counter() - t0
            after = frame_sig(self.frame)
            render = self.parts.get("render", 0.0)
            write = self.parts.get("write", 0.0)
            row = dict(cmd=line, wall_ms=wall * 1e3, render_ms=render * 1e3,
                       write_ms=write * 1e3,
                       other_ms=(wall - render - write) * 1e3,
                       frame_written=after is not None and after != before)
            if row["frame_written"]:
                row["frame_mean"], row["frame_size"] = png_mean(self.frame)
            self.rows.append(row)


PHASE15_HELD = {"tile_order", "trace_rol", "trace_rol_sc", "resolve_v5",
                "block_splat", "block_splat_8", "block_splat_capped",
                "fetch"}


def hold_recorded(calls, want=PHASE15_HELD, what="15a"):
    """Every recorded call against its kernel's plain version, bit for
    bit: K1 order and skey, the trace kernels' t (bits), columns and
    visits, the resolve rows (max |difference| 0), K4 at each channel
    count, K7 and K8, the bitstack traversal's t, tri, u, v (bits; the
    rays and hits of each call noted); phase ``what`` fails on a difference
    or when a kernel of ``want`` has no recorded call. Returns {kernel:
    {calls, max_abs_err, routes}}."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.accel import traverse as tt
    from fluctus_tpu_torch.core import block_splat as bs
    held = {}

    def note(key, route, err=0.0):
        h = held.setdefault(key, dict(calls=0, max_abs_err=0.0, routes=[]))
        h["calls"] += 1
        h["max_abs_err"] = max(h["max_abs_err"], err)
        if route not in h["routes"]:
            h["routes"].append(route)

    def splat_args(local, data, film, groups, remaining=None):
        return local, data, film, groups, remaining

    def fetch_args(local, table, groups):
        return local, table, groups

    def traverse_args(orig, d, tris, bvh, t_max, any_hit):
        return orig, d, tris, bvh, t_max, any_hit
    for ((route, seg), name), lst in calls.items():
        for args, kw in lst:
            where = f"{route}, segment {seg}"
            if name == "tile_order":
                diff = tile_order_diffs(mt.tile_order(*args),
                                        tile_order_chain_plain(*args))
                if any(diff.values()):
                    raise AssertionError(f"{what}: K1 differs ({where}): "
                                         f"{diff}")
                note(name, route)
            elif name in ("trace_rol", "trace_rol_sc"):
                plain = getattr(mt, f"{name}_plain")
                diff = trace_diffs(getattr(mt, name)(*args),
                                   trace_plain_chunked(
                                       plain, *args,
                                       chunk=256 if name == "trace_rol"
                                       else 512))
                if any(diff.values()):
                    raise AssertionError(f"{what}: {name} differs ({where}): "
                                         f"{diff}")
                note(name, route)
            elif name.startswith("resolve_"):
                got = getattr(mt, name)(*args)
                ref = getattr(mt, f"{name}_plain")(*args)
                err = float((got - ref).abs().max())
                if err != 0.0:
                    raise AssertionError(f"{what}: {name} differs ({where}): "
                                         f"max |diff| {err}")
                note(name, route, err)
            elif name == "splat":
                local, data, film, g, rem = splat_args(*args, **kw)
                if rem is None:
                    key = "block_splat" if data.shape[0] == 4 \
                        else f"block_splat_{data.shape[0]}"
                    got = bs.splat(local, data, film, groups=g)
                    ref = bs.splat_plain(local, data, film, g)
                else:
                    key = "block_splat_capped"
                    got = bs.splat(local, data, film, groups=g,
                                   remaining=rem)
                    ref = bs.splat_capped_plain(local, data, film, g, rem)
                if not torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32)):
                    raise AssertionError(f"{what}: {key} differs ({where})")
                note(key, route)
            elif name == "fetch":
                local, table, g = fetch_args(*args, **kw)
                if not torch.equal(bs.fetch(local, table, groups=g),
                                   bs.fetch_plain(local, table, g)):
                    raise AssertionError(f"{what}: K8 differs ({where})")
                note("fetch", route)
            elif name == "traverse":
                args = traverse_args(*args, **kw)
                got = tt.traverse(*args)
                diff, err = bvh_compare(got, traverse_plain_chunked(*args))
                if diff:
                    raise AssertionError(f"{what}: bvh_bitstack differs "
                                         f"({where}): {diff} rays")
                note("bvh_bitstack", route, err)
                h = held["bvh_bitstack"]
                h.setdefault("rays", []).append(got[1].shape[0])
                h.setdefault("hits", []).append(int((got[1] >= 0).sum()))
    if not want <= set(held):
        raise AssertionError(f"{what}: no recorded call of "
                             f"{sorted(want - set(held))}")
    return held


def phase_repl(card):
    """Phase 15a: run_interactive at 1080p with 1M paths (see the module
    docstring). Returns (launches by kernel, K4's 8-channel launches)."""
    import contextlib
    import io
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.interactive import run_interactive
    out_dir = fresh_dir()
    frame = os.path.join(out_dir, "frame.png")
    png = os.path.join(out_dir, "shot.png")
    script = [c.format(png=png) for c in REPL_SCRIPT]
    r = make_renderer(*SESSION_SIZE, "cuda", env_map=ENV_FILE,
                      switches={"shortcuts": {2: GRID2}})
    r.num_tasks = SESSION_PATHS
    echo = io.StringIO()
    with SessionRecorder() as rec:
        timed = TimedScript(r, script, frame, rec)
        torch.cuda.synchronize()
        kb.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(echo):
            count = run_interactive(r, out_path=frame, input_stream=timed)
        seconds = time.perf_counter() - t0
        launches, plain = counts()
        k4_by = dict(kb.KERNELS["block_splat"].launches_by)
    lines = echo.getvalue().splitlines()
    faults = [ln for ln in lines if ln.startswith(REPL_FAULTS)]
    stale = [row["cmd"] for row in timed.rows
             if row["cmd"].split()[0] in FRAME_OPS
             and not row["frame_written"]]
    rows = timed.rows
    out = dict(phase="repl_session", card=card, scene=LUXBALL,
               size=list(SESSION_SIZE), paths=SESSION_PATHS, depth=10,
               env_map=ENV_FILE, commands=len(script), returned=count,
               seconds=seconds, launches=launches, plain_runs=plain,
               k4_launches_by_channels=k4_by, faults=faults,
               stale_frames=stale, png_written=os.path.exists(png),
               final=dict(triangles=r.scene.num_triangles, width=r.width,
                          height=r.height, clusters=r.device_scene.mxu
                          .n_clusters, exposure=r.exposure),
               commands_timed=rows,
               echo=[ln for ln in lines if ln.startswith("  ")][:60])
    emit(out)
    if faults or stale or count != len(script) or not out["png_written"]:
        raise AssertionError(f"15a: faults {faults}, frames not written by "
                             f"{stale}, returned {count} of {len(script)}")
    if any(plain.values()):
        raise AssertionError(f"15a: a plain version ran: {plain}")
    missing = [k for k in PHASE15_KERNELS if not launches.get(k)]
    if missing or not k4_by.get(8):
        raise AssertionError(f"15a: never launched: {missing}, K4 by "
                             f"channels {k4_by}")
    held = hold_recorded(rec.calls)
    del rec, timed
    emit(dict(phase="repl_kernels_vs_plain", card=card, held=held))
    def split(cmds):
        return {key: [row[f"{key}_ms"] for row in rows if row["cmd"] in cmds]
                for key in ("wall", "render", "write")}
    emit(dict(phase="repl_latency", card=card,
              refresh_8_segments=split(("w", "look 10 0")),
              preview_2_segments=split(("d",)),
              frame_write_ms_median=statistics.median(
                  row["write_ms"] for row in rows if row["write_ms"])))
    del r
    torch.cuda.empty_cache()
    return launches, k4_by.get(8, 0)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, cmd=None, timeout=60):
    """GET ``url``, or POST the command ``cmd`` to it as the page's form
    does. Returns the body."""
    import urllib.parse
    import urllib.request
    data = None if cmd is None else \
        urllib.parse.urlencode({"c": cmd}).encode()
    with urllib.request.urlopen(url, data=data, timeout=timeout) as f:
        return f.read()


def post_quit(base):
    """POST q; its 303's follow-up GET races the server's shutdown."""
    try:
        http(base + "/cmd", "q")
    except OSError:
        pass


def phase_viewer(card):
    """Phase 15b: viewer.serve at 1080p in a thread (see the module
    docstring)."""
    import contextlib
    import io
    import threading
    import torch
    from fluctus_tpu_torch import viewer
    r = make_renderer(*SESSION_SIZE, "cuda")
    frame = os.path.join(fresh_dir(), "frame.png")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    ready = threading.Event()
    result = {}

    def run():
        result["n"] = viewer.serve(r, port=port, out_path=frame,
                                   ready_event=ready)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not ready.wait(60):
            raise AssertionError("15b: the viewer did not start")
        page = http(base + "/").decode()
        state0 = json.loads(http(base + "/state.json"))
        http(base + "/cmd", "spp 8")
        t_w = time.perf_counter()
        http(base + "/cmd", "w")
        while not os.path.exists(frame):
            if time.perf_counter() - t_w > 60:
                raise AssertionError("15b: no frame after w")
            time.sleep(0.002)
        w_to_frame = time.perf_counter() - t_w
        http(base + "/cmd", "depth 5")
        http(base + "/cmd", "exposure 1.7")
        deadline = time.perf_counter() + 60
        while True:
            state = json.loads(http(base + "/state.json"))
            if state["depth"] == 5 and state["exposure"] == 1.7:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"15b: edits not shown: {state}")
            time.sleep(0.01)
        png = http(base + "/frame.png")
        size = png_mean(io.BytesIO(png))[1]
        post_quit(base)
        t.join(60)
    missing = [w for w in WIDGET_IDS if f'id="{w}"' not in page]
    out = dict(phase="viewer", card=card, size=list(SESSION_SIZE),
               w_post_to_frame_ms=w_to_frame * 1e3, frame_size=list(size),
               frame_bytes=len(png), widgets_missing=missing,
               state_keys_equal=set(state0) == set(viewer._widget_state(r)),
               state=state, returned=result.get("n"), ended=not t.is_alive(),
               log=[ln for ln in log.getvalue().splitlines()
                    if ln.startswith("viewer:")])
    emit(out)
    if missing or not out["state_keys_equal"] or \
            state != viewer._widget_state(r) or size != SESSION_SIZE or \
            t.is_alive() or result.get("n") != 5:
        raise AssertionError(f"15b: the viewer check failed: {out}")
    del r
    torch.cuda.empty_cache()


def harness_spec(prod_scene):
    """15c's .bm.json: phase 3's view, luxball on the wavefront for
    HARNESS_SECONDS, the production luxball by exact-spp steps to
    HARNESS_SPP."""
    pos, dir_, lpos, lsize = VIEWS[LUXBALL]
    return {"settings": {"windowWidth": SESSION_SIZE[0],
                         "windowHeight": SESSION_SIZE[1],
                         "wfBufferSize": SESSION_PATHS,
                         "camera": {"pos": list(pos), "dir": list(dir_)},
                         "areaLight": {"pos": list(lpos), "N": [0, -1, 0],
                                       "E": [50.0], "size": list(lsize)}},
            "scenes": [{"file": os.path.abspath(LUXBALL),
                        "settings": {"useWavefront": True,
                                     "maxRenderTime": HARNESS_SECONDS}},
                       {"file": prod_scene,
                        "settings": {"useWavefront": False,
                                     "maxSpp": HARNESS_SPP}}],
            "outputFolder": "results"}


@contextlib.contextmanager
def working_dir(path):
    """Run the block in ``path`` (the harness keeps its caches under
    ./data, as the CLI)."""
    here = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(here)


def phase_harness(card, main_line, prof_line):
    """Phase 15c: the .bm.json harness, the fixed protocol at its size, and
    profiling.profile_device_ops (see the module docstring). Returns the
    .bm.json spec for 15d."""
    import torch
    from fluctus_tpu_torch import profiling
    from fluctus_tpu_torch.bench import harness
    from fluctus_tpu_torch.settings import Settings
    cwd = fresh_dir()
    prod = write_production_scene(os.path.join(cwd, "production"))
    spec = harness_spec(prod)
    path = os.path.join(cwd, "x.bm.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    with working_dir(cwd):
        res = harness.run_benchmark_file(path)
    bm_s = time.perf_counter() - t0
    folder = os.path.join(cwd, "results")
    with open(os.path.join(folder, "results.csv")) as f:
        csv = f.read().splitlines()
    names = [x.scene for x in res]
    rows = {n: sum(ln.startswith(n + ";") for ln in csv[1:]) for n in names}
    files = sorted(os.listdir(folder))
    lux = res[0].averages if res else {}
    exact = res[1].averages if len(res) > 1 else {}
    out = dict(phase="harness_bm_json", card=card, seconds=bm_s,
               scenes=names, csv_header_equal=bool(csv) and
               csv[0] == CSV_HEADER, csv_rows=rows, files=files,
               wavefront=lux, exact=exact,
               mrays_per_s=lux.get("total"),
               phase3_mrays_per_s=main_line["mrays_per_s"])
    emit(out)
    stems = [os.path.splitext(os.path.basename(e["file"]))[0]
             for e in spec["scenes"]]
    want = {f"{n}.{e}" for n in stems for e in ("png", "hdr")} | \
        {"results.csv", "results.txt"}
    if names != stems or not out["csv_header_equal"] \
            or min(rows.values()) < 1 or set(files) != want or \
            exact.get("spp") != HARNESS_SPP:
        raise AssertionError(f"15c: the .bm.json run failed: {out}")

    # the fixed protocol's size (1024x1024) and time, phase 3's view,
    # the wavefront route
    s = Settings()
    s.import_json(spec["settings"])
    s.use_wavefront = True
    scene = os.path.abspath(LUXBALL)
    with working_dir(fresh_dir()):
        fixed = harness.run_benchmark(scenes=[scene],
                                      width=FIXED_SIZE[0],
                                      height=FIXED_SIZE[1],
                                      seconds=FIXED_SECONDS, settings=s)
    av = fixed[0].averages

    # profile_device_ops over 2 segments of phase 3's path
    r = make_renderer(*SESSION_SIZE, "cuda")
    r.init_wavefront(SESSION_PATHS)
    r.render_wavefront(2)
    rows_p = profiling.profile_device_ops(lambda: r.render_wavefront(2),
                                          top=1000)
    named = {m.group(1) for name, _, _ in rows_p
             for m in [re.search(r"(?:^|\s)(\w+)_kernel[<(]", name)] if m}
    emit(dict(phase="harness_fixed_and_profile", card=card,
              fixed=dict(size=list(FIXED_SIZE), seconds=FIXED_SECONDS,
                         mrays_per_s=av["total"], spp=av["spp"],
                         elapsed=av["elapsed"]),
              phase3_mrays_per_s=main_line["mrays_per_s"],
              profile_rows=len(rows_p),
              device_ms_per_segment=sum(ms for _, ms, _ in rows_p) / 2,
              profile_top=[dict(name=n[:90], ms_per_segment=ms / 2,
                                count=c) for n, ms, c in rows_p[:10]],
              phase3_profile_top=prof_line["top"][:6],
              kernels_named=sorted(named)))
    need = {"tile_order", "trace_rol", "resolve_v5", "block_splat"}
    if not need <= named or av["total"] <= 0:
        raise AssertionError(f"15c: profile rows name {sorted(named)}, "
                             f"fixed protocol {av}")

    # the harness's wavefront loop (a synchronize every 8 segments, the
    # counters read every 0.5 s) against one timed run of 2 x SEGMENTS
    # segments, on this renderer, in turns
    def direct():
        r.init_wavefront(SESSION_PATHS)
        r.render_wavefront(2)
        r.init_wavefront(SESSION_PATHS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.render_wavefront(2 * SEGMENTS)
        dt = time.perf_counter() - t
        st = r.wavefront_stats()
        return (st.primary_rays + st.extension_rays + st.shadow_rays) \
            / dt / 1e6

    def loop():
        r.init_wavefront(SESSION_PATHS)
        r.render_wavefront(2)
        av, _ = harness._render_timed_wavefront(r, CONTROL_SECONDS, 0,
                                                "control")
        t = time.perf_counter()
        r.wavefront_stats()
        return av["total"], r._wf_segments, time.perf_counter() - t
    runs = [direct(), loop(), direct(), loop()]
    emit(dict(phase="harness_loop_control", card=card,
              direct_mrays_per_s=runs[0::2],
              harness_loop_mrays_per_s=[x[0] for x in runs[1::2]],
              harness_loop_segments=[x[1] for x in runs[1::2]],
              counters_read_ms=[x[2] * 1e3 for x in runs[1::2]],
              seconds=CONTROL_SECONDS))
    del r
    torch.cuda.empty_cache()
    return spec


def phase_cli_session(card, spec):
    """Phase 15d: the CLI's --interactive, --serve, .bm.json and
    --benchmark as subprocesses (see the module docstring), started
    together; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("FLT_FORCE_CPU", None)
    scene = os.path.abspath(LUXBALL)
    size = ["-x", str(SESSION_SIZE[0]), "-y", str(SESSION_SIZE[1]),
            "--tasks", str(SESSION_PATHS)]
    dirs = {k: fresh_dir() for k in ("interactive", "serve", "bm", "fixed")}
    short = json.loads(json.dumps(spec))
    short["scenes"][0]["settings"]["maxRenderTime"] = 2
    short["scenes"][1]["settings"]["maxSpp"] = 1
    short["scenes"][1]["file"] = os.path.abspath(LUXBALL)
    with open(os.path.join(dirs["bm"], "short.bm.json"), "w") as f:
        json.dump(short, f)
    port = free_port()
    cmds = {"interactive": [scene, *size, "--interactive", "-o",
                            "frame.png"],
            "serve": [scene, *size, "--serve", str(port), "-o", "frame.png"],
            "bm": ["short.bm.json"],
            "fixed": ["--benchmark"]}
    script = os.path.join(dirs["interactive"], "script.txt")
    with open(script, "w") as f:
        f.write("spp 4\nw\npng shot.png\nq\n")
    t0 = time.perf_counter()
    with open(script) as stdin:
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "fluctus_tpu_torch", *a], cwd=dirs[k],
            env=env, stdin=stdin if k == "interactive" else
            subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for k, a in cmds.items()}
    results = {}
    try:
        base = f"http://127.0.0.1:{port}"
        frame = os.path.join(dirs["serve"], "frame.png")
        deadline = time.perf_counter() + 300
        while True:          # the scene loads before the server starts
            try:
                http(base + "/state.json", timeout=5)
                break
            except OSError:
                if procs["serve"].poll() is not None or \
                        time.perf_counter() > deadline:
                    raise AssertionError("15d: the --serve viewer did not "
                                         "start")
                time.sleep(0.1)
        http(base + "/cmd", "w")
        while not os.path.exists(frame):
            if time.perf_counter() > deadline:
                raise AssertionError("15d: no frame from --serve")
            time.sleep(0.01)
        post_quit(base)
        for k, p in procs.items():
            out, err = p.communicate(timeout=300)
            results[k] = dict(exit=p.returncode,
                              seconds=time.perf_counter() - t0,
                              stdout=out.strip().splitlines()[-5:],
                              stderr=err.strip().splitlines()[-3:],
                              files=sorted(os.listdir(dirs[k])))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    bm_files = os.listdir(os.path.join(dirs["bm"], "results")) \
        if os.path.isdir(os.path.join(dirs["bm"], "results")) else []
    skips = [f"skipping missing scene ./{f}" for f in
             ("assets/egyptcat/egyptcat.obj",
              "assets/conference/conference.obj",
              "assets/country_kitchen/Country-Kitchen.obj")]
    emit(dict(phase="cli_session", card=card, port=port, bm_results=sorted(
        bm_files), **results))
    bad = [k for k, v in results.items() if v["exit"] != 0]
    if bad or len(results) != 4 or \
            not {"frame.png", "shot.png"} <= set(results["interactive"]
                                                  ["files"]) or \
            "  error" in "\n".join(results["interactive"]["stdout"]) or \
            "frame.png" not in results["serve"]["files"] or \
            "results.csv" not in bm_files or \
            results["fixed"]["stdout"] != skips:
        raise AssertionError(f"15d: the CLI runs failed: {bad or results}")


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


# ---------------------------------------------------------------------------
# Phase 16: sharding (parallel/) over ranks of torch.distributed
# ---------------------------------------------------------------------------

SHARD_RANKS = 2            # 16a-16c: gloo ranks, both on the one card
SHARD_PATHS = 1 << 20
SHARD_CAPPED_SEGMENTS = 8  # 16c
SHARD_CAP_SPP = 2          # 16c's spp cap
NCCL_SEGMENTS = 16         # 16d, per timed run
ALL_REDUCE_REPS = 50       # 16a and 16d: the counters' all_reduce alone
SHARD_MEAN_GATE = 0.05     # tests/test_wf_sharded.py:77-101
RANK_TIMEOUT = 420         # seconds for the ranks of 16a-16c to finish


def _cut(tree, k, d):
    """Shard k of d of every tensor's leading dim in a NamedTuple tree: the
    local simulation's slicing, written apart from shard_wf_state."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        m = tree.shape[0] // d
        return tree[k * m:(k + 1) * m].contiguous()
    return type(tree)(*(_cut(x, k, d) for x in tree))


def _tree_to(tree, device):
    """Every tensor of a NamedTuple tree on ``device``."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    parts = (_tree_to(x, device) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def all_reduce_ms(group, device):
    """Host ms of one all_reduce of the 4 int64 counters on ``group``
    through to the card (mean of ALL_REDUCE_REPS, synchronised)."""
    import torch
    import torch.distributed as dist
    v = torch.zeros(4, dtype=torch.int64, device=device)
    dist.all_reduce(v, group=group)
    torch.cuda.synchronize()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(ALL_REDUCE_REPS):
        dist.all_reduce(v, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ALL_REDUCE_REPS * 1e3


def _sharded_segments(r, mesh, scene, config, params, segments):
    """``segments`` of wf_segment_sharded from a fresh sharded reset, the
    kernel counts set to 0 just before and read just after. Returns the
    rank's seconds, the reduced counters of each segment, its launches
    and plain runs, and the gathered state (None off shard 0)."""
    import torch
    import torch.distributed as dist
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import wf_reset
    from fluctus_tpu_torch.parallel.mesh import (gather_wf_state,
                                                 shard_wf_state,
                                                 wf_segment_sharded)
    st = shard_wf_state(wf_reset(config, SHARD_PATHS,
                                 world_radius=r.world_radius,
                                 device=r.device), mesh)
    torch.cuda.synchronize()
    dist.barrier()
    kb.reset_counts()
    t0 = time.perf_counter()
    cnts = []
    for _ in range(segments):
        st, c = wf_segment_sharded(scene, params, st, config, mesh)
        cnts.append(torch.stack(list(c)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = counts()
    return dict(seconds=seconds, counters=torch.stack(cnts).tolist(),
                launches=launches, plain_runs=plain,
                state=_tree_to(gather_wf_state(st, mesh), "cpu"))


def rank16(rank, world, init, out_dir, data_dir):
    """One gloo rank of phase 16, in a spawned process on cuda:0: the
    1080p luxball renderer loaded from the parent's caches, then 16a (the
    block ring), 16b (the megastep) and 16c (the block ring under the spp
    cap) through parallel/'s entry points; its results (the gathered
    films on shard 0) go to out_dir/rank<k>.pt."""
    import torch
    import torch.distributed as dist
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_mk import Film
    from fluctus_tpu_torch.parallel import (make_mesh, render_sharded,
                                            replicate_scene)
    from fluctus_tpu_torch.parallel.mesh import gather_film, shard_film
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, device="cuda:0")
        r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
        scene = replicate_scene(r.device_scene, mesh)
        cfg = r.config
        out = dict(rank=rank, shard=mesh.get_coordinate()[0],
                   scene_hash=r.scene.hash, cache_hit=r.cache_hit)
        _sharded_segments(r, mesh, scene, cfg, r.params, 2)   # warm-up
        torch.cuda.reset_peak_memory_stats()
        out["wf"] = _sharded_segments(r, mesh, scene, cfg, r.params,
                                      SEGMENTS)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

        cfg_mk = cfg.replace(use_roulette=False)
        n = cfg_mk.num_pixels
        film, seed = shard_film(
            Film.zeros(n, r.device),
            torch.arange(n, dtype=torch.int64, device=r.device), mesh)
        torch.cuda.synchronize()
        dist.barrier()
        kb.reset_counts()
        t0 = time.perf_counter()
        stats = []
        for _ in range(MK_SPP):
            film, seed, st = render_sharded(scene, r.params, film, seed,
                                            cfg_mk, mesh)
            stats.append(list(st))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = counts()
        out["mk"] = dict(seconds=seconds, stats=stats, launches=launches,
                         plain_runs=plain, film=_tree_to(
                             gather_film(film, seed, mesh), "cpu"))

        params_c = r.params._replace(max_spp=torch.tensor(
            SHARD_CAP_SPP, dtype=torch.int32, device=r.device))
        out["capped"] = _sharded_segments(
            r, mesh, scene, cfg.replace(max_spp=1, use_roulette=False),
            params_c, SHARD_CAPPED_SEGMENTS)
        out["all_reduce_ms"] = all_reduce_ms(mesh.get_group("px"), r.device)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks16(data_dir):
    """Start rank16 in SHARD_RANKS spawned processes (the kernels are built:
    they load the parent's libraries) and wait for them; a rank that
    raises or exits non-zero, or one still running after RANK_TIMEOUT
    seconds, fails the phase (every rank is stopped first). Returns the
    ranks' results and the wall seconds."""
    import torch
    import torch.multiprocessing as mp
    init = os.path.join(fresh_dir(), "rendezvous")
    out_dir = fresh_dir()
    t0 = time.perf_counter()
    ctx = mp.start_processes(rank16, args=(SHARD_RANKS, init, out_dir,
                                           data_dir),
                             nprocs=SHARD_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"phase 16: ranks still running after "
                                     f"{RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)
    codes = [p.exitcode for p in ctx.processes]
    if any(codes):
        raise AssertionError(f"phase 16: rank exit codes {codes}")
    wall = time.perf_counter() - t0
    return [torch.load(os.path.join(out_dir, f"rank{k}.pt"),
                       weights_only=False)
            for k in range(SHARD_RANKS)], wall


def shard_recorder():
    """A Recorder of the kernel wrappers phase 16 runs, K8 among them."""
    from fluctus_tpu_torch.core import block_splat as bs
    rec = Recorder()
    rec.targets.append((bs, "fetch"))
    return rec


def _local_segments(r, config, params, segments, d, what, want):
    """The sharded wavefront simulated in this process: shard k's slice of
    the same reset runs ``segments`` of wf_segment with pixel_base k*L,
    one shard after another. The last shard's calls of the kernels in
    segment 2 and in its last segment are recorded and held to their
    plain versions (the kernels of ``want`` each at least once). Returns
    (the shards' states, the summed counters of each segment, what
    hold_recorded held)."""
    import torch
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    st0 = wf_reset(config, SHARD_PATHS, world_radius=r.world_radius,
                   device=r.device)
    local = st0.film.weight.shape[0] // d
    states, total = [], 0
    with shard_recorder() as rec:
        for k in range(d):
            curr = (_cut(st0.curr_pixel, k, d) if st0.curr_pixel.ndim else
                    torch.zeros((), dtype=torch.int32, device=r.device))
            st = st0._replace(pool=_cut(st0.pool, k, d),
                              film=_cut(st0.film, k, d),
                              spp=_cut(st0.spp, k, d), curr_pixel=curr)
            cnts = []
            for seg in range(1, segments + 1):
                rec.active = ((f"{what} shard {k}", seg) if k == d - 1
                              and seg in (2, segments) else None)
                st, c = wf_segment(r.device_scene, params, st, config,
                                   pixel_base=k * local)
                cnts.append(torch.stack([x.to(torch.int64) for x in c]))
            states.append(st._replace(pool=None))
            total = total + torch.stack(cnts)
    held = hold_recorded(rec.calls, want, what)
    return states, total.tolist(), held


def _check_gathered(what, got, states, device):
    """A gathered sharded state (film, spp, cursors) bit-equal to the
    concatenated local shards'."""
    import torch
    cat = lambda get: torch.cat([get(s) for s in states])
    pairs = [(f"rgb.{c}", got.film.color[i].to(device),
              cat(lambda s: s.film.color[i])) for i, c in enumerate("xyz")]
    pairs += [("weight", got.film.weight.to(device),
               cat(lambda s: s.film.weight)),
              ("spp", got.spp.to(device), cat(lambda s: s.spp)),
              ("cursors", got.curr_pixel.to(device),
               cat(lambda s: s.curr_pixel))]
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{what}: {bad} differ from the local "
                             f"simulation")


@contextlib.contextmanager
def nccl_mesh():
    """A 1-rank NCCL group in this process (on a free localhost port) and
    its 1-D mesh on cuda:0; the group is destroyed on exit."""
    import socket
    import torch.distributed as dist
    from fluctus_tpu_torch.parallel import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, device="cuda:0")
    finally:
        dist.destroy_process_group()


def phase_nccl(card, r):
    """16d: a 1-rank NCCL group in this process. NCCL_SEGMENTS of
    wf_segment_sharded equal the plain wf_segment's from the same reset
    (film, spp, cursors and counters); both timed in turns (plain,
    sharded, sharded, plain) after a warm-up run of each (the first
    all_reduce sets NCCL's communicator up), and one all_reduce of the
    counters alone."""
    import torch
    import torch.distributed as dist
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    from fluctus_tpu_torch.parallel.mesh import (shard_wf_state,
                                                 wf_segment_sharded)
    with nccl_mesh() as mesh:
        cfg = r.config

        def run(sharded):
            st = wf_reset(cfg, SHARD_PATHS, world_radius=r.world_radius,
                          device=r.device)
            if sharded:
                st = shard_wf_state(st, mesh)
            torch.cuda.synchronize()
            kb.reset_counts()
            t0 = time.perf_counter()
            cnts = []
            for _ in range(NCCL_SEGMENTS):
                if sharded:
                    st, c = wf_segment_sharded(r.device_scene, r.params, st,
                                               cfg, mesh)
                else:
                    st, c = wf_segment(r.device_scene, r.params, st, cfg)
                cnts.append(torch.stack([x.to(torch.int64) for x in c]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / NCCL_SEGMENTS * 1e3
            return ms, st, torch.stack(cnts).tolist(), counts()
        warm = run(False), run(True)
        p1, s1, s2, p2 = run(False), run(True), run(True), run(False)
        _check_gathered("16d", s1[1], [p1[1]], r.device)
        if s1[2] != p1[2]:
            raise AssertionError(f"16d: counters {s1[2]} != {p1[2]}")
        check_launches(*s1[3], PER_SEGMENT, NCCL_SEGMENTS, "16d sharded")
        group = mesh.get_group("px")
        out = dict(phase="sharded_nccl", card=card, ranks=1,
                   backend=dist.get_backend(group), segments=NCCL_SEGMENTS,
                   warm_up_ms_per_segment=dict(plain=warm[0][0],
                                               sharded=warm[1][0]),
                   plain_ms_per_segment=[p1[0], p2[0]],
                   sharded_ms_per_segment=[s1[0], s2[0]],
                   all_reduce_ms=all_reduce_ms(group, r.device),
                   equal_to_plain=True)
        emit(out)
        return out, s1[3][0]


def phase_sharded(card, main):
    """Phase 16 (see the module docstring). Returns the kernel launches of
    the sharded runs (16a-16c summed over the ranks, and 16d's first
    sharded run)."""
    import torch
    from fluctus_tpu_torch.core.integrator_mk import Film, render_sample
    from fluctus_tpu_torch.core.integrator_wf import unpad_pixels
    from fluctus_tpu_torch.vec import Vec3
    t_phase = time.perf_counter()
    data_dir = fresh_dir()
    r = make_renderer(1920, 1080, "cuda", data_dir=data_dir)
    cfg = r.config
    d = SHARD_RANKS
    res, ranks_wall = run_ranks16(data_dir)
    if [x["shard"] for x in res] != list(range(d)):
        raise AssertionError(f"16: shards {[x['shard'] for x in res]}")
    hashes = {x["scene_hash"] for x in res} | {r.scene.hash}
    if len(hashes) != 1:
        raise AssertionError(f"16: scene hashes differ: {hashes}")
    launches = {}

    def add(l):
        for k, v in l.items():
            launches[k] = launches.get(k, 0) + v

    # 16a: the block ring against its local simulation
    states, sums, held_a = _local_segments(
        r, cfg, r.params, SEGMENTS, d, "16a",
        {"tile_order", "trace_rol", "resolve_v5", "block_splat"})
    got = res[0]["wf"]["state"]
    _check_gathered("16a", got, states, r.device)
    for x in res:
        if x["wf"]["counters"] != sums:
            raise AssertionError(f"16a rank {x['rank']}: reduced counters "
                                 f"differ from the local sums")
        check_launches(x["wf"]["launches"], x["wf"]["plain_runs"],
                       PER_SEGMENT, SEGMENTS, f"16a rank {x['rank']}")
        add(x["wf"]["launches"])
    film = Film(Vec3(*(unpad_pixels(c.to(r.device), cfg)
                       for c in got.film.color)),
                unpad_pixels(got.film.weight.to(r.device), cfg))
    mean = float(r.ldr_image(film).mean())
    mean_rel = abs(mean - main["image_mean"]) / max(main["image_mean"], 1e-9)
    rays = sum(sums[s][0] + sums[s][1] + sums[s][2] for s in range(SEGMENTS))
    slowest = max(x["wf"]["seconds"] for x in res)
    wf_line = dict(
        phase="sharded_wavefront", card=card, ranks=d, backend="gloo",
        shared_card=True, note="both ranks share one card: not a scaling "
        "figure", width=r.width, height=r.height, paths=SHARD_PATHS,
        segments=SEGMENTS, depth=cfg.max_bounces,
        ms_per_segment_by_rank=[x["wf"]["seconds"] / SEGMENTS * 1e3
                                for x in res],
        mrays_per_s_both_ranks=rays / slowest / 1e6,
        main_path_mrays_per_s=main["mrays_per_s"],
        main_path_ms_per_segment=main["ms_per_segment"],
        peak_mem_bytes_by_rank=[x["peak_mem_bytes"] for x in res],
        launches_by_rank=[x["wf"]["launches"] for x in res],
        equal_to_local_simulation=True, held_to_plain=held_a,
        image_mean=mean,
        main_path_image_mean=main["image_mean"], mean_rel_diff=mean_rel,
        all_reduce_ms_by_rank=[x["all_reduce_ms"] for x in res],
        ranks_wall_seconds=ranks_wall, cache_hit_by_rank=[
            x["cache_hit"] for x in res])
    emit(wf_line)
    if mean_rel > SHARD_MEAN_GATE:
        raise AssertionError(f"16a: tonemapped mean differs from phase 3's "
                             f"by {mean_rel}")

    # 16b: the megastep against the unsharded render_sample
    cfg_mk = cfg.replace(use_roulette=False)
    n = cfg_mk.num_pixels
    film_u = Film.zeros(n, r.device)
    seed_u = torch.arange(n, dtype=torch.int64, device=r.device)
    stats_u = []
    for _ in range(MK_SPP):
        film_u, seed_u, st = render_sample(r.device_scene, r.params, film_u,
                                           seed_u, cfg_mk)
        stats_u.append(list(st))
    # the last shard's slice of the first sample, its kernels recorded
    with shard_recorder() as rec:
        rec.active = (f"16b shard {d - 1}", 1)
        render_sample(r.device_scene, r.params,
                      _cut(Film.zeros(n, r.device), d - 1, d),
                      _cut(torch.arange(n, dtype=torch.int64,
                                        device=r.device), d - 1, d),
                      cfg_mk, pixel_base=(d - 1) * (n // d))
    held_b = hold_recorded(rec.calls, {"tile_order", "trace_rol",
                                       "resolve_v5"}, "16b")
    del rec
    (film_s, seed_s) = res[0]["mk"]["film"]
    diffs = {name: int((a.to(r.device) != b).sum()) for name, a, b in (
        ("rgb.x", film_s.color.x, film_u.color.x),
        ("rgb.y", film_s.color.y, film_u.color.y),
        ("rgb.z", film_s.color.z, film_u.color.z),
        ("weight", film_s.weight, film_u.weight), ("seed", seed_s, seed_u))}
    depth = cfg.max_bounces
    for x in res:
        check_launches(x["mk"]["launches"], x["mk"]["plain_runs"],
                       PER_BOUNCE_MK, (depth + 1) * MK_SPP,
                       f"16b rank {x['rank']}")
        add(x["mk"]["launches"])
    mk_rays = sum(s[0] + s[1] + s[2] for s in stats_u)
    emit(dict(phase="sharded_megastep", card=card, ranks=d, backend="gloo",
              shared_card=True, spp=MK_SPP, depth=depth,
              seconds_per_sample_by_rank=[x["mk"]["seconds"] / MK_SPP
                                          for x in res],
              mrays_per_s_both_ranks=mk_rays / max(
                  x["mk"]["seconds"] for x in res) / 1e6,
              lanes_differing=diffs, held_to_plain=held_b, stats=stats_u,
              stats_equal=all(x["mk"]["stats"] == stats_u for x in res)))
    if any(diffs.values()) or not all(x["mk"]["stats"] == stats_u
                                      for x in res):
        raise AssertionError(f"16b: sharded megastep differs from the "
                             f"unsharded one: {diffs}")

    # 16c: the block ring under the spp cap
    cfg_c = cfg.replace(max_spp=1, use_roulette=False)
    params_c = r.params._replace(max_spp=torch.tensor(
        SHARD_CAP_SPP, dtype=torch.int32, device=r.device))
    states, sums, held_c = _local_segments(
        r, cfg_c, params_c, SHARD_CAPPED_SEGMENTS, d, "16c",
        {"tile_order", "trace_rol", "resolve_v5", "block_splat_capped",
         "fetch"})
    got = res[0]["capped"]["state"]
    _check_gathered("16c", got, states, r.device)
    live = got.spp < (1 << 29)
    capped_ok = bool((got.spp[live] <= SHARD_CAP_SPP).all()
                     and torch.equal(got.film.weight[live],
                                     got.spp[live].float()))
    for x in res:
        if x["capped"]["counters"] != sums:
            raise AssertionError(f"16c rank {x['rank']}: reduced counters "
                                 f"differ from the local sums")
        check_launches(x["capped"]["launches"], x["capped"]["plain_runs"],
                       PER_SEGMENT_EXACT, SHARD_CAPPED_SEGMENTS,
                       f"16c rank {x['rank']}")
        add(x["capped"]["launches"])
    emit(dict(phase="sharded_capped", card=card, ranks=d, backend="gloo",
              segments=SHARD_CAPPED_SEGMENTS, cap_spp=SHARD_CAP_SPP,
              ms_per_segment_by_rank=[
                  x["capped"]["seconds"] / SHARD_CAPPED_SEGMENTS * 1e3
                  for x in res],
              pixels_at_cap=float((got.spp[live] == SHARD_CAP_SPP)
                                  .float().mean()),
              weight_equals_spp=capped_ok,
              launches_by_rank=[x["capped"]["launches"] for x in res],
              equal_to_local_simulation=True, held_to_plain=held_c))
    if not capped_ok:
        raise AssertionError("16c: spp over the cap or weight != spp")

    # 16d: a 1-rank NCCL group
    _, nccl_launches = phase_nccl(card, r)
    add(nccl_launches)
    emit(dict(phase="phase_16", card=card,
              seconds=time.perf_counter() - t_phase))
    del r
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the bitstack BVH route (scenes without cluster tables)
# ---------------------------------------------------------------------------

BVH_SEGMENTS = 8           # 17b: timed segments on each route
BVH_SPP = 4                # 17b: the exact render on the bitstack route
BVH_EDGE_RAYS = 4096       # 17a: rays of each edge-case kind
BVH_GRID_CHUNK = 1 << 16   # 17d: rays held to the plain version
BVH_MK_HELD = (0, 2)       # 17c: the bounces whose traces are held
BVH_ENTRY_SEGMENTS = 4     # 17e
BVH_SHARD_SEGMENTS = 4     # 17f
BOX_OPS = 25               # FP32 operations of a box test (22 + 3 compares)
TRI_OPS = 53               # of a triangle test (46 + 7 compares)
PER_SEGMENT_BVH = {"bvh_bitstack": 2, "tile_order": 0, "trace_rol": 0,
                   "resolve_v5": 0, "block_splat": 1, **_ZERO}
PER_SEGMENT_BVH_EXACT = {**PER_SEGMENT_BVH, "block_splat": 0,
                         "block_splat_capped": 1, "fetch": 1}
# the megastep under the env map and the area light: the extension ray and
# a shadow ray to each light, every bounce
PER_BOUNCE_BVH = {"bvh_bitstack": 3, "tile_order": 0, "trace_rol": 0,
                  "resolve_v5": 0, "block_splat": 0, **_ZERO}
MK_TRACES = ("extension", "env shadow", "area shadow")   # a bounce's order


def bvh_scene(r):
    """r's scene without tables, as the reference's Renderer uploads it off
    its TPU (renderer.py:140-147): the triangle arrays, the materials and
    the renderer's host BVH on the card, beside its atlas, env map and
    normal-map frames."""
    from fluctus_tpu_torch.accel.traverse import BVHDevice
    from fluctus_tpu_torch.core.trace import TrianglesDevice
    return r.device_scene._replace(
        mxu=None,
        tris=TrianglesDevice.from_arrays(*r.scene.triangle_arrays(),
                                         device=r.device),
        mats=r.scene.device_materials(device=r.device),
        bvh=BVHDevice.from_host(r._bvh_host, device=r.device))


def bvh_compare(got, ref):
    """(lanes where t, tri, u or v differ in any bit, max |difference| of
    t, u, v where both are finite)."""
    import torch
    bad = torch.zeros_like(got[1], dtype=torch.bool)
    err = 0.0
    for a, b in zip(got, ref):
        if a.dtype == torch.float32:
            bad |= a.view(torch.int32) != b.view(torch.int32)
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                err = max(err, float((a - b).abs()[fin].max()))
        else:
            bad |= a != b
    return int(bad.sum()), err


def traverse_plain_chunked(orig, d, tris, bvh, t_max, any_hit,
                           chunk=1 << 20):
    """The traversal's plain version a chunk of rays at a time (the rays
    are independent; this bounds the lockstep loop's temporaries)."""
    import torch
    from fluctus_tpu_torch.accel import traverse as tt
    n = orig.x.shape[0]
    cut = lambda v, k: type(v)(*(c[k:k + chunk] for c in v))
    per_ray = torch.is_tensor(t_max) and t_max.ndim > 0
    outs = [tt.traverse_plain(cut(orig, k), cut(d, k), tris, bvh,
                              t_max[k:k + chunk] if per_ray else t_max,
                              any_hit) for k in range(0, n, chunk)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(4))


def once_ms(fn):
    """fn() once between CUDA events: (its result, ms)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def bvh_bound(n, boxes, tests, scene, any_hit):
    """(ms, "bytes" or "operations") of a bitstack trace of n rays that
    made ``boxes`` box tests and ``tests`` triangle tests: each ray read
    once (28 B) and its result written once (16 B; any-hit 1 B), the tree
    (36 B a node, 4 an index) and the triangles (36 B) read once."""
    bvh = scene.bvh
    nb = n * (28 + (1 if any_hit else 16)) + 36 * bvh.parent.shape[0] \
        + 4 * bvh.indices.shape[0] + 36 * scene.tris.v0.x.shape[0]
    return bound(boxes * BOX_OPS + tests * TRI_OPS, nb)


def bvh_check(scene, o, d, tmax, any_hit, what, timed=True):
    """The kernel against the plain version on one ray set: bit-equal or
    AssertionError. With ``timed`` the kernel's device time, the plain
    version's (one run), the tests the rays made and the bound."""
    import torch
    from fluctus_tpu_torch.accel import traverse as tt
    got = tt.traverse(o, d, scene.tris, scene.bvh, tmax, any_hit)
    ref, plain_ms = once_ms(lambda: tt.traverse_plain(
        o, d, scene.tris, scene.bvh, tmax, any_hit, counts=True))
    diff, err = bvh_compare(got, ref[:4])
    n = o.x.shape[0]
    out = dict(rays=n, differing_rays=diff, max_abs_err=err,
               hits=int((got[1] >= 0).sum()))
    if torch.is_tensor(tmax) and tmax.ndim:
        out["t_max_positive"] = int((tmax > 0).sum())
    if diff:
        raise AssertionError(f"bvh_bitstack differs from its plain version "
                             f"on {diff} rays ({what})")
    if not timed:
        return out
    boxes, tests = int(ref[4].sum()), int(ref[5].sum())
    b_ms, b_by = bvh_bound(n, boxes, tests, scene, any_hit)
    del ref
    torch.cuda.empty_cache()
    return dict(out, **kernel_ms(lambda: tt.traverse(
        o, d, scene.tris, scene.bvh, tmax, any_hit)), plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, box_tests=boxes,
        triangle_tests=tests, box_tests_per_ray=boxes / n,
        triangle_tests_per_ray=tests / n)


def bvh_edge_rays(bvh, tris, n, seed):
    """Edge-case rays on a host BVH, made from a numpy seed: axis-parallel
    directions (the other components +0 or -0) from origins on a node
    box's plane (the slab's 0 * inf = NaN: no hit) and from random
    origins, random directions from origins inside node boxes, rays
    toward the triangles' centroids from inside the scene's bounds.
    Returns (origins, directions) as Vec3 on the card, 4n rays."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.vec import Vec3
    rng = np.random.default_rng(seed)
    axes = []
    for a in range(3):
        for sign, zero in ((1.0, 0.0), (-1.0, 0.0), (1.0, -0.0),
                           (-1.0, -0.0)):
            v = [zero] * 3
            v[a] = sign
            axes.append(v)
    axes = np.array(axes)
    pick = rng.integers(0, bvh.num_nodes, n)
    lo, hi = bvh.box_min[pick], bvh.box_max[pick]
    inside = lo + rng.random((n, 3)) * (hi - lo)
    plane = inside.copy()
    ax, side = rng.integers(0, 3, n), rng.integers(0, 2, n)
    rows = np.arange(n)
    plane[rows, ax] = np.where(side, hi[rows, ax], lo[rows, ax])
    plane_d = axes[4 * ((ax + 1 + side) % 3) + rng.integers(0, 4, n)]
    slo, shi = bvh.box_min[0], bvh.box_max[0]
    rand_o = slo + rng.random((n, 3)) * (shi - slo)
    v0 = tris.v0
    k = rng.integers(0, v0.x.shape[0], n)
    cen = np.stack([c.cpu().numpy()[k] for c in v0], 1)
    dirs = rng.normal(size=(n, 3))
    to_tri = cen - rand_o
    o = np.concatenate([plane, rand_o, inside, rand_o])
    d = np.concatenate([plane_d, axes[rng.integers(0, 12, n)],
                        dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
                        to_tri / np.maximum(np.linalg.norm(
                            to_tri, axis=1, keepdims=True), 1e-12)])
    col = lambda a, j: torch.from_numpy(
        np.ascontiguousarray(a[:, j], np.float32)).cuda()
    return (Vec3(col(o, 0), col(o, 1), col(o, 2)),
            Vec3(col(d, 0), col(d, 1), col(d, 2)))


def bvh_edges(scene, host_bvh, seed):
    """17a's edge cases: the edge rays in both modes, with t_max F32_MAX,
    +inf, 0 and random (a quarter each), and any-hit to the closest hits
    found."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.accel import traverse as tt
    o, d = bvh_edge_rays(host_bvh, scene.tris, BVH_EDGE_RAYS, seed)
    n = o.x.shape[0]
    rng = np.random.default_rng(seed + 1)
    kinds = rng.integers(0, 4, n)
    vals = np.select([kinds == 0, kinds == 1, kinds == 2],
                     [np.float32(tt.F32_MAX), np.inf, 0.0],
                     rng.random(n) * float(np.linalg.norm(
                         host_bvh.box_max[0] - host_bvh.box_min[0])))
    tmax = torch.from_numpy(vals.astype(np.float32)).cuda()
    out = {}
    for name, tm in (("closest_f32max", tt.F32_MAX), ("closest_mixed", tmax),
                     ("any_mixed", tmax)):
        out[name] = bvh_check(scene, o, d, tm, name.startswith("any"),
                              f"edge rays, {name}", timed=False)
    t_hit = tt.traverse(o, d, scene.tris, scene.bvh, tt.F32_MAX, False)[0]
    out["any_to_hit"] = bvh_check(scene, o, d, t_hit, True,
                                  "edge rays, any-hit to the hit",
                                  timed=False)
    return out


def bvh_recorder():
    """A Recorder of the kernel wrappers with the bitstack traversal's
    (accel.traverse.traverse) among them."""
    from fluctus_tpu_torch.accel import traverse as tt
    rec = Recorder()
    rec.targets.append((tt, "traverse"))
    return rec


def record_bvh_rays(r, segs=(2, 4)):
    """Segments 1-4 from a fresh 1M-path pool on r's (table) route: the
    rays each of ``segs`` traces (its pool's extension rays, its shadow
    rays with the non-pending lanes' tmax 0) and the kernel wrappers'
    arguments in those segments."""
    import torch
    from fluctus_tpu_torch.vec import Vec3
    rays = {}
    with Recorder() as rec:
        r.init_wavefront(1 << 20)
        for seg in range(1, 5):
            rec.active = seg if seg in segs else None
            if seg in segs:
                p = r._wf_state.pool
                c = lambda v: Vec3(*(x.clone() for x in v))
                rays[seg] = dict(
                    orig=c(p.orig), dir=c(p.dir), sorig=c(p.shadow_orig),
                    sdir=c(p.shadow_dir),
                    smax=torch.where(p.shadow_pending, p.shadow_len, 0.0))
            r.render_wavefront(1)
        rec.active = None
    return rays, rec.calls


def table_trace_ms(rec_calls, seg, k1, trace):
    """The table route's kernels on a segment's recorded calls: K1 (all
    its calls), the trace kernel ``trace`` closest-hit and any-hit."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    fn = {"tile_order": mt.tile_order, "trace_rol": mt.trace_rol,
          "trace_rol_sc": mt.trace_rol_sc}
    out = {f"{k1}_ms": sum(kernel_ms(lambda a=a, kw=kw: fn[k1](*a, **kw))
                           ["ms"] for a, kw in rec_calls[(seg, k1)])}
    for a, kw in rec_calls[(seg, trace)]:
        kind = "any_hit" if a[-1] else "closest"
        out[f"{trace}_{kind}_ms"] = kernel_ms(
            lambda a=a, kw=kw: fn[trace](*a, **kw))["ms"]
    out["table_ms"] = sum(out.values())
    return out


def bvh_rays_vs_tables(r, scene, rays, rec_calls, segs, k1, trace, what):
    """Per recorded segment: the kernel against the plain version on its
    extension rays (closest) and shadow rays (any-hit), timed with their
    bound, beside the table route's kernels and its whole pair trace
    (trace_pair_mxu: sort, K1, the traces, unsort) on the same rays."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.accel import traverse as tt
    out = {}
    for seg in segs:
        x = rays[seg]
        ext = bvh_check(scene, x["orig"], x["dir"], tt.F32_MAX, False,
                        f"{what} segment {seg}, extension")
        shd = bvh_check(scene, x["sorig"], x["sdir"], x["smax"], True,
                        f"{what} segment {seg}, shadow")
        pair = time_ms(lambda: mt.trace_pair_mxu(
            x["orig"], x["dir"], x["sorig"], x["sdir"], x["smax"],
            r.device_scene.mxu), reps=5)
        out[seg] = dict(closest=ext, any_hit=shd,
                        bitstack_ms=ext["ms"] + shd["ms"],
                        **table_trace_ms(rec_calls, seg, k1, trace),
                        table_pair_trace_ms=pair)
    return out


def bvh_first_hits(scene, table, x):
    """The share of a segment's extension rays whose first hit (triangle,
    -1 on a miss) differs between the bitstack and the table route."""
    from fluctus_tpu_torch.accel import traverse as tt
    from fluctus_tpu_torch.core.trace import trace_extension
    tri = tt.closest_hit(x["orig"], x["dir"], scene.tris, scene.bvh)[1]
    ref = trace_extension(x["orig"], x["dir"], table, None, False).i
    return float((tri != ref).float().mean())


def bvh_timed_run(r, card, scene, route):
    """BVH_SEGMENTS timed segments of r on ``scene`` (2 warm-up segments,
    then a fresh pool: the same seeds on either route). Returns (launches,
    its line)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    r.device_scene = scene
    r.init_wavefront(1 << 20)
    r.render_wavefront(2)
    r.init_wavefront(1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_counts()
    t0 = time.perf_counter()
    r.render_wavefront(BVH_SEGMENTS)
    elapsed = time.perf_counter() - t0
    launches, plain = counts()
    st = r.wavefront_stats()
    rays = st.primary_rays + st.extension_rays + st.shadow_rays
    film = r.wavefront_film()
    line = dict(route=route, segments=BVH_SEGMENTS, seconds=elapsed,
                ms_per_segment=elapsed / BVH_SEGMENTS * 1e3,
                mrays_per_s=rays / elapsed / 1e6,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                image_mean=float(r.ldr_image().mean()),
                film_finite=bool(torch.isfinite(film.color.x).all()),
                pixels_covered=float((film.weight > 0).float().mean()),
                launches=launches, plain_runs=plain, card=card)
    check_launches(launches, plain, PER_SEGMENT_BVH if route == "bitstack"
                   else PER_SEGMENT, BVH_SEGMENTS, f"17b {route}")
    if not line["film_finite"]:
        raise AssertionError(f"17b: a non-finite film on the {route} route")
    prof = profile_segments(r, card, line["ms_per_segment"])
    line.update(device_ms_per_segment=prof["device_ms_per_segment"],
                device_busy_share=prof["device_busy_share"],
                kernels_us_per_segment=prof["kernels_us_per_segment"])
    return launches, line


def bvh_exact(r, card, scene):
    """BVH_SPP exact samples per pixel on the bitstack route (K7, K8):
    spp = weight on every pixel. Returns (launches, its line)."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    r.device_scene = scene
    r.reset()
    torch.cuda.synchronize()
    kb.reset_counts()
    t0 = time.perf_counter()
    film = r.render_single(BVH_SPP)
    elapsed = time.perf_counter() - t0
    launches, plain = counts()
    segments = launches["block_splat_capped"]
    spp = r._wf_exact_state.spp
    line = dict(spp=BVH_SPP, seconds=elapsed, segments=segments,
                weight_exact=bool((film.weight == BVH_SPP).all()),
                spp_exact=bool((spp[spp < (1 << 29)] == BVH_SPP).all()),
                mrays_per_s=r.perf_mrays(elapsed)["total"],
                launches=launches, plain_runs=plain, card=card)
    emit(dict(phase="bitstack_exact", **line))
    check_launches(launches, plain, PER_SEGMENT_BVH_EXACT, segments,
                   "17b exact")
    if not (line["weight_exact"] and line["spp_exact"]):
        raise AssertionError("17b exact: spp != weight on the bitstack route")
    return launches


def bvh_hold_mk(calls):
    """17c's recorded traversal calls of bounces BVH_MK_HELD (a bounce's
    calls in MK_TRACES order, 2M rays each) held bit for bit to the plain
    version; each held call must have a hit. Returns what was held."""
    def any_hit_of(orig, d, tris, bvh, t_max, any_hit):
        return any_hit
    pick = {}
    for b in BVH_MK_HELD:
        for j, kind in enumerate(MK_TRACES):
            args, kw = calls[len(MK_TRACES) * b + j]
            if any_hit_of(*args, **kw) != (j > 0):
                raise AssertionError(f"17c: bounce {b}'s calls are not in "
                                     f"the order {MK_TRACES}")
            pick[((f"17c bounce {b} {kind}", 1), "traverse")] = [(args, kw)]
    held = hold_recorded(pick, {"bvh_bitstack"}, "17c")["bvh_bitstack"]
    if min(held["hits"]) == 0:
        raise AssertionError(f"17c: a held call without a hit: {held}")
    return held


def bvh_mk(r, card, scene, route):
    """One megastep sample (render_sample under FORCE_MK) on ``scene``; on
    the bitstack route its traversal calls are recorded and some held to
    the plain version (bvh_hold_mk). Returns (launches, its line)."""
    import torch
    from fluctus_tpu_torch import flags
    from fluctus_tpu_torch import kernel_build as kb
    r.device_scene = scene
    saved = flags.FORCE_MK
    flags.FORCE_MK = True
    try:
        r.reset()
        r.render_single(1)               # warm-up
        r.reset()
        with bvh_recorder() as rec:
            torch.cuda.synchronize()
            kb.reset_counts()
            rec.active = ("17c", 1) if route == "bitstack" else None
            t0 = time.perf_counter()
            film = r.render_single(1)
            elapsed = time.perf_counter() - t0
            rec.active = None
    finally:
        flags.FORCE_MK = saved
    launches, plain = counts()
    if not bool((film.weight == 1).all()):
        raise AssertionError(f"17c: weight != 1 on the {route} route")
    line = dict(seconds_per_sample=elapsed,
                mrays_per_s=r.perf_mrays(elapsed)["total"],
                image_mean=float(r.hdr_image().mean()))
    if route == "bitstack":
        check_launches(launches, plain, PER_BOUNCE_BVH,
                       r.config.max_bounces + 1, "17c")
        line["held_to_plain"] = bvh_hold_mk(rec.calls[(("17c", 1),
                                                       "traverse")])
    del rec
    torch.cuda.empty_cache()
    return launches, line


def bvh_entry(card):
    """17e: the reference's entry step (__graft_entry__.entry): the port's
    quad_scene (no tables) and quad_setup(64, 64, 3), wf_reset(config,
    4096), BVH_ENTRY_SEGMENTS wf_segments, every trace of each segment
    held to the plain version. Returns the launches."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    from fluctus_tpu_torch.testing import quad_scene, quad_setup
    scene = quad_scene()
    params, config = quad_setup(width=64, height=64, max_bounces=3)
    state = wf_reset(config, 4096, device="cuda")
    kb.reset_counts()
    counters = []
    with bvh_recorder() as rec:
        for seg in range(1, BVH_ENTRY_SEGMENTS + 1):
            rec.active = ("17e", seg)
            state, cnt = wf_segment(scene, params, state, config)
            rec.active = None
            counters.append([int(c) for c in cnt])
    launches = counts()[0]       # before the holds launch the kernel again
    held = hold_recorded(rec.calls, {"bvh_bitstack"},
                         "17e")["bvh_bitstack"]["calls"]
    w = state.film.weight
    emit(dict(phase="bitstack_entry", card=card, segments=len(counters),
              counters=counters, held_calls=held,
              launches=launches["bvh_bitstack"],
              film_weight=float(w.sum()),
              film_finite=bool(torch.isfinite(state.film.color.x).all())))
    if launches["bvh_bitstack"] != 2 * BVH_ENTRY_SEGMENTS or held != \
            2 * BVH_ENTRY_SEGMENTS or not float(w.sum()) > 0:
        raise AssertionError("17e: launches, holds or film wrong")
    return launches


def bvh_sharded(card, r, scene):
    """17f: parallel/'s entry points on the bitstack scene over a 1-rank
    NCCL group: BVH_SHARD_SEGMENTS of wf_segment_sharded from a sharded
    reset equal to wf_segment's from the same reset (film, spp, cursors,
    counters), and one render_sharded sample equal to render_sample's
    (film, seed, stats), the traversal launched for every trace. Returns
    the sharded runs' launches."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core.integrator_mk import Film, render_sample
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    from fluctus_tpu_torch.parallel import render_sharded, replicate_scene
    from fluctus_tpu_torch.parallel.mesh import (gather_film, shard_film,
                                                 shard_wf_state,
                                                 wf_segment_sharded)
    cfg = r.config
    cfg_mk = cfg.replace(use_roulette=False)
    n = cfg_mk.num_pixels
    fresh = lambda: (Film.zeros(n, r.device),
                     torch.arange(n, dtype=torch.int64, device=r.device))
    with nccl_mesh() as mesh:
        sc = replicate_scene(scene, mesh)
        runs = []
        for sharded in (False, True):
            st = wf_reset(cfg, SHARD_PATHS, world_radius=r.world_radius,
                          device=r.device)
            if sharded:
                st = shard_wf_state(st, mesh)
            torch.cuda.synchronize()
            kb.reset_counts()
            cnts = []
            for _ in range(BVH_SHARD_SEGMENTS):
                if sharded:
                    st, c = wf_segment_sharded(sc, r.params, st, cfg, mesh)
                else:
                    st, c = wf_segment(scene, r.params, st, cfg)
                cnts.append([int(x) for x in c])
            runs.append((st, cnts, counts()))
        (p_st, p_cnt, _), (s_st, s_cnt, (lw, pw)) = runs
        _check_gathered("17f", s_st, [p_st], r.device)
        if s_cnt != p_cnt:
            raise AssertionError(f"17f: counters {s_cnt} != {p_cnt}")
        check_launches(lw, pw, PER_SEGMENT_BVH, BVH_SHARD_SEGMENTS,
                       "17f wf_segment_sharded")
        del runs, p_st, s_st
        film_u, seed_u, st_u = render_sample(scene, r.params, *fresh(),
                                             cfg_mk)
        film, seed = shard_film(*fresh(), mesh)
        torch.cuda.synchronize()
        kb.reset_counts()
        film, seed, st_s = render_sharded(sc, r.params, film, seed, cfg_mk,
                                          mesh)
        lm, pm = counts()
        film_s, seed_s = gather_film(film, seed, mesh)
    check_launches(lm, pm, PER_BOUNCE_BVH, cfg.max_bounces + 1,
                   "17f render_sharded")
    diffs = {name: int((a != b).sum()) for name, a, b in (
        ("rgb.x", film_s.color.x, film_u.color.x),
        ("rgb.y", film_s.color.y, film_u.color.y),
        ("rgb.z", film_s.color.z, film_u.color.z),
        ("weight", film_s.weight, film_u.weight), ("seed", seed_s, seed_u))}
    stats = [[int(x) for x in st] for st in (st_s, st_u)]
    emit(dict(phase="bitstack_sharded", card=card, ranks=1, backend="nccl",
              segments=BVH_SHARD_SEGMENTS, counters=s_cnt,
              wf_launches=lw["bvh_bitstack"], mk_launches=lm["bvh_bitstack"],
              mk_lanes_differing=diffs, mk_stats=stats))
    if any(diffs.values()) or stats[0] != stats[1]:
        raise AssertionError(f"17f: render_sharded differs from "
                             f"render_sample: {diffs}, {stats}")
    return {k: lw[k] + lm[k] for k in lw}


def phase_bitstack(card):
    """Phase 17 (see the module docstring). Returns (the kernel's entry for
    the kernels line, its launches on the main paths of 17b, 17c, 17e,
    17f)."""
    import torch
    t_phase = time.perf_counter()
    r = make_renderer(1920, 1080, "cuda", env_map=ENV_FILE)
    table = r.device_scene
    scene = bvh_scene(r)
    info = dict(triangles=r.scene.num_triangles,
                nodes=int(scene.bvh.parent.shape[0]),
                max_leaf=scene.bvh.max_leaf, depth=r._bvh_host.depth())

    # 17a: the kernel against its plain version on luxball's recorded rays
    rays, rec = record_bvh_rays(r)
    seg = bvh_rays_vs_tables(r, scene, rays, rec, (2, 4), "tile_order",
                             "trace_rol", "luxball")
    if not any(seg[k]["any_hit"]["hits"] for k in (2, 4)):
        raise AssertionError("17a: no recorded shadow ray was occluded")
    edges = bvh_edges(scene, r._bvh_host, seed=17)
    first = bvh_first_hits(scene, table, rays[2])
    emit(dict(phase="bitstack_vs_plain", card=card, scene=LUXBALL,
              env_map=ENV_FILE, **info, segments=seg, edge_cases=edges,
              first_hit_differs_share=first))
    del rec
    torch.cuda.empty_cache()

    # 17b: the wavefront on each route, the same seeds; the exact render
    launches = {}

    def add(more):
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
    _, tab_line = bvh_timed_run(r, card, table, "tables")
    lb, bvh_line = bvh_timed_run(r, card, scene, "bitstack")
    add(lb)
    rel = abs(bvh_line["image_mean"] - tab_line["image_mean"]) / max(
        tab_line["image_mean"], 1e-9)
    emit(dict(phase="bitstack_path", card=card, scene=LUXBALL,
              env_map=ENV_FILE, width=r.width, height=r.height,
              paths=1 << 20, bitstack=bvh_line, tables=tab_line,
              mean_rel_diff=rel, bias_gate=BIAS_GATE,
              first_hit_differs_share=first))
    if rel > BIAS_GATE:
        raise AssertionError(f"17b: the bitstack film's mean differs by "
                             f"{rel} from the table route's")
    add(bvh_exact(r, card, scene))

    # 17c: one megastep sample on each route
    lm, mk_b = bvh_mk(r, card, scene, "bitstack")
    add(lm)
    _, mk_t = bvh_mk(r, card, table, "tables")
    emit(dict(phase="bitstack_mk", card=card, depth=r.config.max_bounces,
              bitstack=mk_b, tables=mk_t))

    # 17f: parallel/'s entry points on the bitstack scene
    add(bvh_sharded(card, r, scene))
    r.device_scene = table
    del r, scene, table, rays
    torch.cuda.empty_cache()

    # 17d: the 8x8 grid's recorded rays, beside K5
    from fluctus_tpu_torch.accel import traverse as tt
    g = make_renderer(1920, 1080, "cuda", LARGE)
    gscene = bvh_scene(g)
    grays, grec = record_bvh_rays(g, segs=(4,))
    x = grays[4]
    # the chunks: lanes strided over the pool, and for any-hit over its
    # pending lanes
    strided = lambda i: i[::max(1, i.shape[0] // BVH_GRID_CHUNK)][
        :BVH_GRID_CHUNK]
    lanes = strided(torch.arange(x["smax"].shape[0],
                                 device=x["smax"].device))
    pending = strided((x["smax"] > 0).nonzero()[:, 0])
    cut = lambda v, k: type(v)(*(c[k] for c in v))
    held = dict(
        closest=bvh_check(gscene, cut(x["orig"], lanes),
                          cut(x["dir"], lanes), tt.F32_MAX, False,
                          "grid chunk", timed=False),
        any_hit=bvh_check(gscene, cut(x["sorig"], pending),
                          cut(x["sdir"], pending), x["smax"][pending], True,
                          "grid chunk, shadow", timed=False),
        shadow_pending=int((x["smax"] > 0).sum()))
    grid = {}
    for kind, (o, d, tm, anyh) in dict(
            closest=(x["orig"], x["dir"], tt.F32_MAX, False),
            any_hit=(x["sorig"], x["sdir"], x["smax"], True)).items():
        grid[kind] = kernel_ms(lambda: tt.traverse(o, d, gscene.tris,
                                                   gscene.bvh, tm, anyh))
    grid.update(table_trace_ms(grec, 4, "tile_order", "trace_rol_sc"))
    emit(dict(phase="bitstack_grid", card=card, scene=LARGE,
              triangles=g.scene.num_triangles,
              nodes=int(gscene.bvh.parent.shape[0]),
              depth=g._bvh_host.depth(), rays=x["orig"].x.shape[0],
              held_on_chunk=held, **grid))
    if not (held["closest"]["hits"] and held["any_hit"]["hits"]):
        raise AssertionError(f"17d: a held chunk without a hit: {held}")
    del g, gscene, grays, grec
    torch.cuda.empty_cache()

    # 17e: the reference's entry step on the port's quad_scene
    add(bvh_entry(card))

    s4 = seg[4]["closest"]
    entry = dict(max_abs_err=max(seg[k][m]["max_abs_err"] for k in (2, 4)
                                 for m in ("closest", "any_hit")),
                 ms=s4["ms"], plain_ms=s4["plain_ms"],
                 bound_ms=s4["bound_ms"], bound_by=s4["bound_by"],
                 library_ms=None, any_hit_ms=seg[4]["any_hit"]["ms"],
                 table_k1_k2_ms=seg[4]["table_ms"],
                 grid_ms=grid["closest"]["ms"],
                 grid_k5_closest_ms=grid["trace_rol_sc_closest_ms"])
    emit(dict(phase="phase_17", card=card,
              seconds=time.perf_counter() - t_phase,
              launches=launches["bvh_bitstack"]))
    return entry, launches


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
    """Phases 1-17 (see the module docstring)."""
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
    prof_main = profile_segments(r, card, main["ms_per_segment"])
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
                      cache_hit=r.cache_hit, table_mib=table_mib(sc),
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

    # phase 14: PBRT scenes under the SBVH (14a, 14b), the trace's third
    # branch (14c), the CLI on a PBRT scene (14d)
    launches_s, grid_dir, grid = phase_pbrt_grid(card, kres["trace_rol_sc"])
    lux_pbrt = phase_pbrt_parity(card)
    launches_t = phase_third_branch(card, grid_dir, grid)
    phase_pbrt_cli(card, lux_pbrt)

    # phase 15: the REPL (15a), the viewer (15b), the harness and
    # profiling (15c), the CLI's session and benchmark options (15d)
    t0 = time.perf_counter()
    launches_r, k4_8_r = phase_repl(card)
    phase_viewer(card)
    spec = phase_harness(card, main, prof_main)
    phase_cli_session(card, spec)
    emit(dict(phase="phase_15", card=card,
              seconds=time.perf_counter() - t0))

    # phase 16: sharding over 2 gloo ranks on the card (16a-16c) and a
    # 1-rank NCCL group (16d)
    launches_16 = phase_sharded(card, main)

    # phase 17: the bitstack BVH route (17a-17e)
    kres["bvh_bitstack"], launches_17 = phase_bitstack(card)

    # phase 10: result lines
    main_launches = {k: launches[k] + launches_l[k] + launches_p.get(k, 0)
                     + launches_d.get(k, 0) + launches_f.get(k, 0)
                     + launches_s.get(k, 0) + launches_t.get(k, 0)
                     + launches_r.get(k, 0) + launches_16.get(k, 0)
                     + launches_17.get(k, 0) for k in SOURCES}
    main_launches.update(
        block_splat_capped=(launches_x["block_splat_capped"]
                            + launches_p["block_splat_capped"]
                            + launches_d["block_splat_capped"]
                            + launches_r["block_splat_capped"]
                            + launches_16["block_splat_capped"]
                            + launches_17["block_splat_capped"]),
        fetch=(launches_x["fetch"] + launches_p["fetch"]
               + launches_d["fetch"] + launches_r["fetch"]
               + launches_16["fetch"] + launches_17["fetch"]),
        trace_ros=launches_ros["trace_ros"],
        resolve_v1=launches_k10["resolve_v1"])
    kres["block_splat"]["channels_8"]["launches"] = k4_8 + k4_8_r
    emit(kernels_line(kres, main_launches))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
