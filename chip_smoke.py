#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fluctus_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, one JSON line each; any failure raises and exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), then
   every kernel of csrc/ built from source in parallel.
2. kernel vs plain: the inputs K1-K4 receive on the luxball path (the 1M
   camera rays of the second segment and the bounce rays of the fourth, as
   the pair trace sorts them) go through each kernel and through its plain
   PyTorch version on the card; the outputs are held to the stated
   tolerances and both are timed (CUDA events, median), with one PyTorch
   library call computing the same function as a yardstick where one
   exists.
3. luxball path: Renderer(1920, 1080) on luxball with a 1M-path pool, 2
   warm-up segments, a fresh pool, then SEGMENTS timed segments; Mrays/s
   (primary + extension + shadow rays, as bench.py counts them),
   ms/segment, peak memory; every kernel's launch count must equal
   segments x its launches per segment, no plain version may run, the
   film must be finite with weight > 0 on >= 99% of pixels. Then two
   more segments under torch.profiler: device time by kernel and the
   device's busy share.
4. whole-path parity: 4 segments at 256x144 with 64k paths through the
   kernels and, from the same reset, through the plain versions on the
   card.
2b, 3b, 4b: the same three phases on the large-scene path: the 8x8
   luxball grid (361,088 triangles, 2,056 clusters, past both tier
   switches), so each segment runs K1 over superclusters, K5 twice, K6
   and K4. 2b holds K1, K5 (both modes) and K6 to their plain versions
   and times K3 on K6's inputs; 3b times LARGE_SEGMENTS segments and
   checks the primary-hit share.
5. the kernels line, the card line, then the final result line.

Prints nothing of the result and exits non-zero without CUDA or without
the package beside it.
"""

import json
import os
import statistics
import subprocess
import sys
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
PER_SEGMENT = {"tile_order": 2, "trace_rol": 2, "resolve_v5": 1,
               "block_splat": 1, "trace_rol_sc": 0, "resolve_v5s": 0}
PER_SEGMENT_LARGE = {"tile_order": 2, "trace_rol_sc": 2, "resolve_v5s": 1,
                     "block_splat": 1, "trace_rol": 0, "resolve_v5": 0}
SOURCES = {"tile_order": "fluctus_tpu_torch/csrc/tile_order.cu",
           "trace_rol": "fluctus_tpu_torch/csrc/trace_rol.cu",
           "resolve_v5": "fluctus_tpu_torch/csrc/resolve_v5.cu",
           "block_splat": "fluctus_tpu_torch/csrc/block_splat.cu",
           "trace_rol_sc": "fluctus_tpu_torch/csrc/trace_rol_sc.cu",
           "resolve_v5s": "fluctus_tpu_torch/csrc/resolve_v5s.cu"}
REPLACES = {"tile_order": "fluctus_tpu/accel/mxu_trace.py:1056",
            "trace_rol": "fluctus_tpu/accel/mxu_trace.py:736",
            "resolve_v5": "fluctus_tpu/accel/mxu_trace.py:1745",
            "block_splat": "fluctus_tpu/core/block_splat.py:103",
            "trace_rol_sc": "fluctus_tpu/accel/mxu_trace.py:832",
            "resolve_v5s": "fluctus_tpu/accel/mxu_trace.py:1894"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_renderer(width, height, device, scene=LUXBALL):
    """A main path's renderer: luxball with the camera of
    tools/make_goldens.py and an area light above the ball, or the 8x8
    grid seen from above its near edge with a 12x12 light over its
    centre."""
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    pos, dir_, lpos, lsize = VIEWS[scene]
    s = Settings()
    s.camera.pos, s.camera.dir = pos, dir_
    a = s.area_light
    a.pos, a.N, a.right, a.up = lpos, (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E, a.size = (50.0, 50.0, 50.0), lsize
    r = Renderer(width, height, settings=s, device=device)
    r.load_scene(scene)
    return r


class Recorder:
    """Record the arguments of the kernel wrappers during chosen segments
    (the wrappers run as usual)."""

    def __init__(self):
        from fluctus_tpu_torch.accel import mxu_trace as mt
        from fluctus_tpu_torch.core import block_splat as bs
        self.targets = [(mt, "tile_order"), (mt, "trace_rol"),
                        (mt, "resolve_v5"), (bs, "splat"),
                        (mt, "trace_rol_sc"), (mt, "resolve_v5s")]
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
    """Swap every kernel wrapper for its plain PyTorch version (phase 4's
    reference run); returns the undo function."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs
    swaps = [(mt, "tile_order", mt.tile_order_plain),
             (mt, "trace_rol", mt.trace_rol_plain),
             (mt, "resolve_v5", mt.resolve_v5_plain),
             (bs, "splat", bs.splat_plain),
             (mt, "trace_rol_sc", mt.trace_rol_sc_plain),
             (mt, "resolve_v5s", mt.resolve_v5s_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)

    def undo():
        for m, n, f in saved:
            setattr(m, n, f)
    return undo


def time_ms(fn, reps=10, warm=2):
    """Median ms of fn() on the card (CUDA events around each call)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_tile_order(mt, rec_calls):
    """K1 vs plain on every recorded call of segments 2 and 4 (cons and
    the sorted order equal); returns the timing dict of segment 4's."""
    import torch
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "tile_order")]:
            rays, tm, boxes = args
            got = mt.tile_order(rays, tm, boxes)
            ref = mt.tile_order_plain(rays, tm, boxes)
            if not torch.equal(got, ref):
                raise AssertionError(f"K1 cons differ (segment {seg})")
            if not torch.equal(mt._candidate_order(got)[0],
                               mt._candidate_order(ref)[0]):
                raise AssertionError(f"K1 order differs (segment {seg})")
    rays, tm, boxes = rec_calls[(4, "tile_order")][0][0]
    nt, _, rt = rays.shape
    ncl = boxes.shape[0]
    cons = mt.tile_order(rays, tm, boxes)
    b_ms, b_by = bound(nt * ncl * rt * 25, nbytes(rays, tm, boxes, cons))
    return dict(
        max_abs_err=0.0, ms=time_ms(lambda: mt.tile_order(rays, tm, boxes)),
        plain_ms=time_ms(lambda: mt.tile_order_plain(rays, tm, boxes), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{nt} tiles x {rt} rays x {ncl} boxes")


def check_trace(name, kernel, plain, rec_calls, chunk):
    """A trace kernel vs its plain version on every recorded call of
    segments 2 and 4: winner columns / verdicts equal on >= 0.9999 of the
    rays (1.0 expected), t equal where they agree, visit counts equal.
    Returns (timing dict of segment 4's closest-hit call, segment 2's
    closest-hit kernel output)."""
    import torch
    worst, agree, calls, seg2 = 0.0, [], [], None
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, name)]:
            got = kernel(*args)
            ref = trace_plain_chunked(plain, *args, chunk=chunk)
            same = got[1] == ref[1]
            frac = float(same.float().mean())
            agree.append(frac)
            if frac < 0.9999:
                raise AssertionError(f"{name} col agreement {frac} (segment "
                                     f"{seg}, any_hit={args[-1]})")
            if not torch.equal(got[2], ref[2]):
                raise AssertionError(f"{name} visit counts differ (segment "
                                     f"{seg})")
            worst = max(worst, float((got[0] - ref[0])[same].abs().max()))
            calls.append((seg, args, int(got[2].sum())))
            if seg == 2 and not args[-1]:
                seg2 = got
    seg, args, visits = calls[-2]          # segment 4, closest-hit
    rays, order, tc = args[0], args[2], args[-2]
    nt, _, rt = rays.shape
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    b_ms, b_by = bound(visits * tc * rt * 30, nbytes(*tensors) + nt * rt * 8)
    return dict(
        max_abs_err=worst, ms=time_ms(lambda: kernel(*args)),
        plain_ms=time_ms(lambda: trace_plain_chunked(plain, *args,
                                                     chunk=chunk), 2, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        col_agreement_min=min(agree), visited_clusters=visits,
        shape=f"{nt} tiles x {rt} rays x {order.shape[1]} candidates, "
              "closest-hit, bounce rays"), seg2


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
        max_abs_err=worst, ms=time_ms(lambda: kernel(*args)),
        plain_ms=time_ms(lambda: plain(*args), 3, 1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.index_select(b16r, 0, safe)),
        library_call="torch.index_select of the winners' B16 rows",
        shape=f"{b} rays, {int(hit.sum())} hits, {winners} distinct "
              f"winners, table {b16r.shape[0]} rows"), args


def phase_kernels(r, rec_calls):
    """Phase 2: every recorded kernel call vs its plain version."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol"], _ = check_trace("trace_rol", mt.trace_rol,
                                      mt.trace_rol_plain, rec_calls, 256)
    res["resolve_v5"], _ = check_resolve("resolve_v5", mt.resolve_v5,
                                         mt.resolve_v5_plain, rec_calls)

    # K4: splat
    worst = 0.0
    for seg in (2, 4):
        for args, kw in rec_calls[(seg, "splat")]:
            got = bs.splat(*args, **kw)
            ref = bs.splat_plain(*args, **kw)
            if not torch.equal(got[3], ref[3]):
                raise AssertionError(f"K4 weight channel differs ({seg})")
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)
            worst = max(worst, float((got - ref).abs().max()))
    (local, data, film), kw = rec_calls[(4, "splat")][0]
    g = kw["groups"]
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
    res["block_splat"] = dict(
        max_abs_err=worst, ms=time_ms(lambda: bs.splat(local, data, film,
                                                      groups=g)),
        plain_ms=time_ms(lambda: bs.splat_plain(local, data, film, g), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        library_call="Tensor.index_add_ on the flattened film",
        shape=f"{g} groups x {s} lanes, Pk={pk}, {int((local >= 0).sum())} "
              "splats")
    return res


def phase_kernels_large(r, rec_calls):
    """Phase 2b: the large path's recorded K1 (over superclusters), K5 and
    K6 calls vs their plain versions; K3 timed on K6's inputs. Returns
    (results, primary-hit share of segment 2's camera rays)."""
    from fluctus_tpu_torch.accel import mxu_trace as mt
    res = {"tile_order": check_tile_order(mt, rec_calls)}
    res["trace_rol_sc"], seg2 = check_trace(
        "trace_rol_sc", mt.trace_rol_sc, mt.trace_rol_sc_plain, rec_calls,
        512)
    res["resolve_v5s"], args = check_resolve(
        "resolve_v5s", mt.resolve_v5s, mt.resolve_v5s_plain, rec_calls)
    res["resolve_v5_on_large"] = dict(
        ms=time_ms(lambda: mt.resolve_v5(*args)),
        shape=res["resolve_v5s"]["shape"])
    # segment 2 traces the camera rays of every lane (segment 1 gives each
    # pre-birth lane its first camera ray)
    return res, float((seg2[1] >= 0).float().mean())


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
    st = r.wavefront_stats()
    rays = st.primary_rays + st.extension_rays + st.shadow_rays
    film = r.wavefront_film()
    finite = bool(torch.isfinite(film.color.x).all()
                  and torch.isfinite(film.color.y).all()
                  and torch.isfinite(film.color.z).all())
    covered = float((film.weight > 0).float().mean())
    out = dict(phase="main_path", scene=scene, width=r.width,
               height=r.height, paths=1 << 20, segments=segments,
               seconds=elapsed, mrays_per_s=rays / elapsed / 1e6,
               ms_per_segment=elapsed / segments * 1e3,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               rays=dict(primary=st.primary_rays,
                         extension=st.extension_rays,
                         shadow=st.shadow_rays, samples=st.samples),
               launches=launches, plain_runs=plain, film_finite=finite,
               pixels_covered=covered, card=card, **(extra or {}))
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


def profile_segments(r, card, ms_per_segment, n=2):
    """Device time by kernel over n more segments (torch.profiler, CUPTI):
    where a segment's time goes. The busy share divides the device time
    per segment by the timed run's unprofiled wall time per segment; the
    profiled segments' own wall time (profiler overhead included) stands
    beside it, since later segments of a pool can cost more than the
    timed run's average. The kernels' own launch counts over the same
    segments stand beside the profiler's call counts, which show any
    events the profiler lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fluctus_tpu_torch import kernel_build as kb
    torch.cuda.synchronize()
    kb.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render_wavefront(n)             # ends in torch.cuda.synchronize
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
    emit(dict(phase="profile", segments=n, card=card,
              device_ms_per_segment=dev_ms,
              device_busy_share=dev_ms / ms_per_segment,
              profiled_wall_ms_per_segment=wall_ms,
              launches_per_segment=launches,
              top=[dict(name=k[:90], us_per_segment=dt / n,
                        calls_per_segment=c / n)
                   for dt, k, c in rows[:14]]))


def phase_parity(scene=LUXBALL, width=256, height=144, paths=1 << 16,
                 device="cuda"):
    """Phase 4 / 4b: 4 segments through the kernels and through the plain
    versions on the card, from the same reset."""
    import torch
    runs = []
    for use_plain in (False, True):
        undo = plain_versions() if use_plain else (lambda: None)
        try:
            r = make_renderer(width, height, device, scene)
            r.init_wavefront(paths)
            r.render_wavefront(4)
            runs.append((r._wf_state, r.wavefront_stats()))
        finally:
            undo()
    (a, sa), (b, sb) = runs
    out = dict(phase="parity", scene=scene, width=width, height=height,
               paths=paths,
               segments=4, counters_kernel=list(sa), counters_plain=list(sb))
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
    emit(out)
    if sa != sb:
        raise AssertionError(f"parity: counters {sa} != {sb}")
    torch.testing.assert_close(fa, fb, rtol=1e-4, atol=1e-6)


def kernels_line(kres, launches):
    """One entry per ported kernel: its checks and times from phase 2 (K1-K4,
    luxball) or 2b (K5, K6), and its launches summed over the two main-path
    runs (each counted from 0)."""
    out = []
    for name in SOURCES:
        k = kres[name]
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"]))
    return {"kernels": out}


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    from fluctus_tpu_torch import kernel_build as kb

    # phase 1: device and build
    card = card_line()
    t0 = time.time()
    per_source = kb.build_all()
    regs = {s: [ln.strip() for ln in kb.build_log(s).splitlines()
                if "registers" in ln or "spill" in ln]
            for s in per_source}
    emit(dict(phase="build", seconds=time.time() - t0, per_source=per_source,
              ptxas=regs, device=torch.cuda.get_device_name(0), card=card,
              torch=torch.__version__, cuda=torch.version.cuda))

    # phase 2: kernels vs plain on the luxball path's inputs
    r = make_renderer(1920, 1080, "cuda")
    kres = phase_kernels(r, record_segments(r))
    emit(dict(phase="kernels_vs_plain", card=card, scene=LUXBALL, **kres))

    # phase 3: luxball path, then a profiled look at two more segments
    launches, main = phase_main(r, card, LUXBALL, SEGMENTS, PER_SEGMENT)
    profile_segments(r, card, main["ms_per_segment"])
    del r
    torch.cuda.empty_cache()

    # phase 4: whole-path parity, kernels vs plain versions
    phase_parity(LUXBALL)

    # phase 2b: the large path's kernels vs plain
    t0 = time.perf_counter()
    r = make_renderer(1920, 1080, "cuda", LARGE)
    host_s = time.perf_counter() - t0
    sc = r.device_scene.mxu
    scene_info = dict(triangles=r.scene.num_triangles,
                      n_clusters=sc.n_clusters,
                      n_superclusters=sc.n_superclusters,
                      host_seconds=host_s, host_steps=r.load_seconds)
    kres_l, primary_hit = phase_kernels_large(r, record_segments(r))
    emit(dict(phase="kernels_vs_plain", card=card, scene=LARGE, **scene_info,
              **{k: v for k, v in kres_l.items() if k != "tile_order"},
              tile_order_on_supers=kres_l["tile_order"]))
    kres.update(trace_rol_sc=kres_l["trace_rol_sc"],
                resolve_v5s=kres_l["resolve_v5s"])

    # phase 3b: the large path
    launches_l, main_l = phase_main(
        r, card, LARGE, LARGE_SEGMENTS, PER_SEGMENT_LARGE,
        extra=dict(scene_info, primary_hit_share=primary_hit))
    if primary_hit < 0.9:
        raise AssertionError(f"primary-hit share {primary_hit} < 0.9")
    profile_segments(r, card, main_l["ms_per_segment"])
    del r
    torch.cuda.empty_cache()

    # phase 4b: whole-path parity on the large path
    phase_parity(LARGE)

    # phase 5: result lines
    emit(kernels_line(kres, {k: launches[k] + launches_l[k]
                             for k in SOURCES}))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
