#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fluctus_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, one JSON line each; any failure raises and exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), then
   every kernel of csrc/ built from source in parallel.
2. kernel vs plain: the inputs K1-K4 receive on the main path (luxball
   tables, the 1M camera rays of the second segment and the bounce rays of
   the fourth, as the pair trace sorts them) go through each kernel and
   through its plain PyTorch version on the card; the outputs are held to
   the stated tolerances and both are timed (CUDA events, median), with
   one PyTorch library call computing the same function as a yardstick
   where one exists.
3. main path: Renderer(1920, 1080) on luxball with a 1M-path pool, 2
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
LUXBALL = "data/luxball/luxball.obj"
PEAK_FP32 = 67e12          # H100 SXM FP32 (non-tensor) FLOP/s, data sheet
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s, data sheet
PER_SEGMENT = {"tile_order": 2, "trace_rol": 2, "resolve_v5": 1,
               "block_splat": 1}
SOURCES = {"tile_order": "fluctus_tpu_torch/csrc/tile_order.cu",
           "trace_rol": "fluctus_tpu_torch/csrc/trace_rol.cu",
           "resolve_v5": "fluctus_tpu_torch/csrc/resolve_v5.cu",
           "block_splat": "fluctus_tpu_torch/csrc/block_splat.cu"}
REPLACES = {"tile_order": "fluctus_tpu/accel/mxu_trace.py:1056",
            "trace_rol": "fluctus_tpu/accel/mxu_trace.py:736",
            "resolve_v5": "fluctus_tpu/accel/mxu_trace.py:1745",
            "block_splat": "fluctus_tpu/core/block_splat.py:103"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_renderer(width, height, device):
    """The main path's renderer: luxball with the camera of
    tools/make_goldens.py and an area light above the ball."""
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    s = Settings()
    s.camera.pos = (0.0, 1.6, 4.5)
    s.camera.dir = (0.0, -0.12, -1.0)
    a = s.area_light
    a.pos, a.N, a.right, a.up = (0, 4, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E, a.size = (50.0, 50.0, 50.0), (0.5, 0.5)
    r = Renderer(width, height, settings=s, device=device)
    r.load_scene(LUXBALL)
    return r


class Recorder:
    """Record the arguments of the kernel wrappers during chosen segments
    (the wrappers run as usual)."""

    def __init__(self):
        from fluctus_tpu_torch.accel import mxu_trace as mt
        from fluctus_tpu_torch.core import block_splat as bs
        self.targets = [(mt, "tile_order"), (mt, "trace_rol"),
                        (mt, "resolve_v5"), (bs, "splat")]
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
             (bs, "splat", bs.splat_plain)]
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


def trace_plain_chunked(mt, rays, tm, order, cons, t12, boxes, ncl, tc,
                        any_hit, chunk=256):
    """K2's plain version over all tiles, a chunk of tiles at a time (the
    tiles are independent; this bounds the [tiles, tc, rt] temporaries)."""
    import torch
    outs = [mt.trace_rol_plain(rays[k:k + chunk], tm[k:k + chunk],
                               order[k:k + chunk], cons[k:k + chunk], t12,
                               boxes, ncl, tc, any_hit)
            for k in range(0, rays.shape[0], chunk)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def phase_kernels(r, rec_calls):
    """Phase 2: every recorded kernel call vs its plain version."""
    import torch
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs
    res = {}

    # K1: tile order
    worst = 0.0
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
    res["tile_order"] = dict(
        max_abs_err=worst, ms=time_ms(lambda: mt.tile_order(rays, tm, boxes)),
        plain_ms=time_ms(lambda: mt.tile_order_plain(rays, tm, boxes), 3, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{nt} tiles x {rt} rays x {ncl} clusters")

    # K2: trace, closest (extension) and any-hit (shadow) calls
    worst = 0.0
    agree = []
    k2 = []
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "trace_rol")]:
            got = mt.trace_rol(*args)
            ref = trace_plain_chunked(mt, *args)
            same = got[1] == ref[1]
            frac = float(same.float().mean())
            agree.append(frac)
            if frac < 0.9999:
                raise AssertionError(f"K2 col agreement {frac} (segment {seg},"
                                     f" any_hit={args[-1]})")
            if not torch.equal(got[2], ref[2]):
                raise AssertionError(f"K2 visit counts differ (segment {seg})")
            worst = max(worst, float((got[0] - ref[0])[same].abs().max()))
            k2.append((seg, args, int(got[2].sum())))
    seg, args, visits = k2[-2]          # segment 4, closest-hit
    rays, tm, order, cons_, t12, boxes, ncl_, tc, _ = args
    nt, _, rt = rays.shape
    b_ms, b_by = bound(visits * tc * rt * 30,
                       nbytes(rays, tm, order, cons_, t12, boxes) +
                       nt * rt * 8)
    res["trace_rol"] = dict(
        max_abs_err=worst, ms=time_ms(lambda: mt.trace_rol(*args)),
        plain_ms=time_ms(lambda: trace_plain_chunked(mt, *args), 2, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        col_agreement_min=min(agree), visited_clusters=visits,
        shape=f"{nt} tiles x {rt} rays, closest-hit, bounce rays")

    # K3: resolve
    worst = 0.0
    ints = [mt.ATTR_MAT, mt.ATTR_TYPE, mt.ATTR_MAP_KD, mt.ATTR_MAP_KS,
            mt.ATTR_MAP_N, mt.ATTR_TRI]
    for seg in (2, 4):
        for args, _ in rec_calls[(seg, "resolve_v5")]:
            got = mt.resolve_v5(*args)
            ref = mt.resolve_v5_plain(*args)
            if not torch.equal(got[ints], ref[ints]):
                raise AssertionError(f"K3 integer rows differ (segment {seg})")
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)
            worst = max(worst, float((got - ref).abs().max()))
    args = rec_calls[(4, "resolve_v5")][0][0]
    col, o4, d4, b16r, t16r = args
    b = col.shape[0]
    safe = col.clamp_min(0)
    b_ms, b_by = bound(b * 60, b * (4 + 32 + 160) + nbytes(b16r, t16r))
    res["resolve_v5"] = dict(
        max_abs_err=worst, ms=time_ms(lambda: mt.resolve_v5(*args)),
        plain_ms=time_ms(lambda: mt.resolve_v5_plain(*args), 3, 1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.index_select(b16r, 0, safe)),
        library_call="torch.index_select of the winners' B16 rows",
        shape=f"{b} rays, {int((col >= 0).sum())} hits")

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


def phase_main(r, card):
    """Phase 3: the main path at 1080p with 1M paths."""
    import torch
    from fluctus_tpu_torch import kernel_build as kb
    r.init_wavefront(1 << 20)
    r.render_wavefront(2)
    r.init_wavefront(1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_counts()
    t0 = time.perf_counter()
    r.render_wavefront(SEGMENTS)          # ends in torch.cuda.synchronize
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
    out = dict(phase="main_path", scene=LUXBALL, width=r.width,
               height=r.height, paths=1 << 20, segments=SEGMENTS,
               seconds=elapsed, mrays_per_s=rays / elapsed / 1e6,
               ms_per_segment=elapsed / SEGMENTS * 1e3,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               rays=dict(primary=st.primary_rays,
                         extension=st.extension_rays,
                         shadow=st.shadow_rays, samples=st.samples),
               launches=launches, plain_runs=plain, film_finite=finite,
               pixels_covered=covered, card=card)
    emit(out)
    for name, per in PER_SEGMENT.items():
        if launches.get(name) != per * SEGMENTS:
            raise AssertionError(f"{name}: {launches.get(name)} launches, "
                                 f"expected {per * SEGMENTS}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    if not finite or covered < 0.99:
        raise AssertionError(f"film check failed: finite={finite}, "
                             f"covered={covered}")
    return launches, out


def profile_segments(r, card, ms_per_segment, n=2):
    """Device time by kernel over n more segments (torch.profiler, CUPTI):
    where a segment's time goes. The busy share divides the device time
    per segment by phase 3's unprofiled wall time per segment."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render_wavefront(n)
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
              top=[dict(name=k[:90], us_per_segment=dt / n,
                        calls_per_segment=c / n)
                   for dt, k, c in rows[:14]]))


def phase_parity(width=256, height=144, paths=1 << 16, device="cuda"):
    """Phase 4: 4 segments through the kernels and through the plain
    versions on the card, from the same reset."""
    import torch
    runs = []
    for use_plain in (False, True):
        undo = plain_versions() if use_plain else (lambda: None)
        try:
            r = make_renderer(width, height, device)
            r.init_wavefront(paths)
            r.render_wavefront(4)
            runs.append((r._wf_state, r.wavefront_stats()))
        finally:
            undo()
    (a, sa), (b, sb) = runs
    out = dict(phase="parity", width=width, height=height, paths=paths,
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

    # phase 2: kernels vs plain on the main path's inputs
    r = make_renderer(1920, 1080, "cuda")
    with Recorder() as rec:
        r.init_wavefront(1 << 20)
        for seg in range(1, 5):
            rec.active = seg if seg in (2, 4) else None
            r.render_wavefront(1)
        rec.active = None
    kres = phase_kernels(r, rec.calls)
    del rec
    emit(dict(phase="kernels_vs_plain", card=card, **{
        k: {kk: vv for kk, vv in v.items()} for k, v in kres.items()}))

    # phase 3: main path, then a profiled look at two more segments
    launches, main = phase_main(r, card)
    profile_segments(r, card, main["ms_per_segment"])
    del r
    torch.cuda.empty_cache()

    # phase 4: whole-path parity, kernels vs plain versions
    phase_parity()

    # phase 5: result lines
    kernels = []
    for name in PER_SEGMENT:
        k = kres[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"]))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
