#!/usr/bin/env python3
"""Time the Hopper sweep's kernels — K2 (trace_rol), K5 (trace_rol_sc) and
K9 (trace_ros) — K1 (tile_order) and K8 (fetch) under other shapes on one
GPU.

Each trace kernel picks its shape per mode in its source, as
``Config<rays per thread, ray groups per CTA, CTAs per tile>``
(fluctus_tpu_torch/csrc/trace_rol.cu, trace_rol_sc.cu, trace_ros.cu; the
sweep is csrc/sweep_hopper.cuh); K1 its ``RAYS_PER_THREAD``
(csrc/tile_order.cu). This script copies csrc/ once per shape set,
rewrites those lines in the copy, builds every copy with nvcc (in
parallel), and times each on the same recorded inputs:

- K2: the closest-hit and any-hit calls of segments 4 and 24 of the
  wavefront on luxball (1920x1080, 1M paths), of segment PROD_SEGMENT of
  the benchmark's production cell (luxball_prod.wavefront: its
  configuration through the harness's make_renderer, a steady-state
  segment after the cell's 12 warm ones), and of bounce 2 of the megastep
  (rays sorted, as the single-set trace hands them to K2);
- K9: the closest-hit and the any-hit call of bounce 2 of the megastep
  with SORT_RAYS off (luxball, 1920x1080, rays in lane order);
- K5: the closest-hit and any-hit calls of segments 4 and 12 of the
  wavefront on the 8x8 luxball grid (1920x1080, 1M paths);
- K1: its first call of segments 4 and 24 of the luxball wavefront, of
  bounce 2 of the megastep (4,050 tiles) and of segment 4 of the 8x8
  grid (over its superclusters);
- K8: its call of segment 2 of a 16-spp exact render (luxball,
  1920x1080, 1M paths), with 1, 2, 4 and 8 lanes per thread
  (``LANES_PER_THREAD`` in csrc/fetch.cu) and, at the committed lanes,
  cached instead of streaming loads, write-back instead of streaming
  stores, and CTAs of 128 or 512 threads (K8_VERSIONS); each held bit for
  bit to fetch_plain, timed in turns (each version, then again in
  reverse order) beside torch.take of the same pixels, and, with
  ``--baseline``, the fetch.cu of DIR in the same turns; beside them a
  copy of its local array into its output, a kernel that moves 8 bytes
  per lane without a gather.

Every copy's t (as bits), columns and visit counts (K1: order and skey as
bits) must equal those of the committed build; times are device times
(CUDA events, median of 5, a spin kernel hiding the launch, as
chip_smoke.py times kernels). K1 is also timed with its box tests left
out and with its ray loads left out (K1_PARTS; those copies compute
something else and are not compared), and its committed line carries the
share of its warps that take the octant path. Prints the card line, one
JSON line per shape set and call, and a summary line.

With ``--baseline DIR`` (another csrc/ directory with the same launchers,
for example that of an earlier commit) it also builds K2, K5, K7
(block_splat_capped), K9, K4 (block_splat) and K1 from DIR and times them
on the same calls: K1 of DIR as the chain that commit ran (its kernel
writing the bounds, then _candidate_order's stable sort), K4 on its call
of segment 4 of the luxball wavefront and K7 on its call of segment 2 of
a 16-spp exact render, each in turns (DIR, committed, committed, DIR).
It also profiles two luxball segments with each K1 (torch.profiler):
device operations and device ms per segment. Two versions are so
compared within one run on one card.

``--queue-study`` runs K2's tile study alone, on its luxball and
production calls: per call the per-tile visits (p50, p99, max, total),
K1's live-candidate count per tile (the slots before the first -1 of its
candidate list) and how it ranks the heavy tiles (the share of the 5%
heaviest tiles by visits that fall in the top 10% by count, and the rank
correlation), and K2's time on the same tiles in three launch orders:
index order, heaviest first by visits and heaviest first by K1's count
(the tile arrays permuted on the host, the outputs permuted back and held
bit for bit to index order's), in turns.

``--k2-only`` runs K2's shape sets alone, on its luxball, production and
megastep calls, and prints each mode's least worst-case loss (a shape's
worst ratio to the fastest shape of a call, over the calls).

``--fetch-only`` runs K8's part alone. ``--splat-only`` runs K4 alone:
its 4-channel call of segment 4 of the luxball wavefront (1920x1080, 1M
paths), the committed build and, with ``--baseline``, the block_splat.cu
of DIR, in turns (DIR, committed, committed, DIR, three times), each bit
for bit against splat_plain.

Run from the repository root:
``python3 sweep_shapes.py [--baseline DIR] [--fetch-only | --splat-only |
--queue-study | --k2-only]``.
"""

import argparse
import json
import os
import re
import shutil
import sys
import tempfile

SOURCES = ("trace_rol.cu", "trace_rol_sc.cu", "trace_ros.cu", "tile_order.cu")
KERNEL_OF = {"trace_rol": "trace_rol.cu", "trace_rol_sc": "trace_rol_sc.cu",
             "trace_ros": "trace_ros.cu", "tile_order": "tile_order.cu"}
# per source (closest-hit, any-hit) shapes, K1's rays per thread; a source
# left out keeps its committed shapes. The first set is the committed one.
SHAPE_SETS = [
    ("committed", {}),
    ("a", {"trace_rol_sc.cu": ((2, 4, 1), (1, 2, 2)),
           "trace_ros.cu": ((2, 2, 1), (1, 2, 1)),
           "trace_rol.cu": ((2, 1, 1), (1, 1, 1)),
           "tile_order.cu": 1}),
    ("b", {"trace_rol_sc.cu": ((2, 2, 2), (1, 1, 4)),
           "trace_ros.cu": ((1, 2, 1), (2, 1, 1)),
           "trace_rol.cu": ((2, 4, 2), (1, 2, 2)),
           "tile_order.cu": 2}),
    ("c", {"trace_rol_sc.cu": ((2, 1, 4), (2, 4, 2)),
           "trace_ros.cu": ((4, 2, 1), (2, 2, 1)),
           "trace_rol.cu": ((2, 2, 1), (1, 2, 1)),
           "tile_order.cu": 8}),
    ("d", {"trace_rol_sc.cu": ((2, 1, 8), (2, 2, 2)),
           "trace_ros.cu": ((2, 4, 1), (1, 1, 1)),
           "trace_rol.cu": ((2, 4, 1), (1, 1, 4))}),
    ("e", {"trace_rol_sc.cu": ((4, 4, 2), (1, 1, 2)),
           "trace_ros.cu": ((2, 1, 1), (1, 1, 1)),
           "trace_rol.cu": ((2, 1, 2), (2, 1, 1))}),
    ("f", {"trace_rol.cu": ((2, 1, 4), (2, 2, 2))}),
]
LINE = {"closest": re.compile(r"using Closest = hs::Config<[^>]*>;"),
        "any_hit": re.compile(r"using AnyHit = hs::Config<[^>]*>;")}
# a steady-state segment of the production cell (12 warm segments, then
# chunks of 4)
PROD_SEGMENT = 16
K1_LINE = re.compile(r"constexpr int RAYS_PER_THREAD = \d+;")
K8_LINE = re.compile(r"constexpr int LANES_PER_THREAD = \d+;")
# K8's versions: lanes per thread, then the committed lanes with one
# other choice each: [(name, lanes or None for the committed, edits)]
K8_VERSIONS = [(f"lanes {v}", v, []) for v in (1, 2, 4, 8)] + [
    ("cached loads", None, [("__ldcs(", "__ldg(")]),
    ("write-back stores", None, [("__stcs(", "__stwb(")]),
    ("128 threads", None, [("THREADS = 256;", "THREADS = 128;")]),
    ("512 threads", None, [("THREADS = 256;", "THREADS = 512;")])]
# K1 with one part left out, to split its time between its ray loads and
# its box tests (these copies compute another function; their outputs are
# not compared): (name, [(text, replacement)] in csrc/tile_order.cu)
_RAY_ROWS = [("o0[k] = T[0 * rt + r];", "o0[k] = 0.001f * r;"),
             ("o1[k] = T[1 * rt + r];", "o1[k] = 0.002f * r;"),
             ("o2[k] = T[2 * rt + r];", "o2[k] = -0.001f * r;"),
             ("i0[k] = safe_inv(T[4 * rt + r]);", "i0[k] = 1.0f + r;"),
             ("i1[k] = safe_inv(T[5 * rt + r]);", "i1[k] = 2.0f + r;"),
             ("i2[k] = safe_inv(T[6 * rt + r]);", "i2[k] = 3.0f + r;"),
             ("tmax[k] = tm[tile * rt + r];", "tmax[k] = 1e30f;")]
K1_PARTS = [
    ("k1 without its box tests",
     [("    for (int c = 0; c < ncl; ++c) {",
       "    for (int c = 0; c < 0; ++c) {")]),
    ("k1 without its ray loads (one octant)", _RAY_ROWS),
]


def shaped_copy(csrc, root, name, shapes):
    """A copy of csrc/ with the shape lines of the sources in ``shapes``
    ({source: (closest, any_hit)}, or K1's rays per thread) rewritten."""
    d = os.path.join(root, name)
    shutil.copytree(csrc, d)
    for source, shape in shapes.items():
        path = os.path.join(d, source)
        with open(path) as f:
            text = f.read()
        if source == "tile_order.cu":
            edits = [(K1_LINE, f"constexpr int RAYS_PER_THREAD = {shape};")]
        else:
            edits = [(LINE[mode], f"using {kind} = hs::Config<{c[0]}, "
                      f"{c[1]}, {c[2]}>;")
                     for mode, kind, c in (("closest", "Closest", shape[0]),
                                           ("any_hit", "AnyHit", shape[1]))]
        for pattern, line in edits:
            text, n = pattern.subn(line, text)
            if n != 1:
                raise RuntimeError(f"{source}: no line {pattern.pattern}")
        with open(path, "w") as f:
            f.write(text)
    return d


def part_copy(csrc, root, name, edits):
    """A copy of csrc/ with K1_PARTS' ``edits`` made in tile_order.cu."""
    d = os.path.join(root, re.sub(r"\W+", "_", name))
    shutil.copytree(csrc, d)
    path = os.path.join(d, "tile_order.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) < 1:
            raise RuntimeError(f"tile_order.cu: no line {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return d


def committed_shapes(csrc):
    """{source: (closest, any_hit), or K1's rays per thread} as the
    sources in csrc/ set them."""
    out = {}
    for source in SOURCES:
        with open(os.path.join(csrc, source)) as f:
            text = f.read()
        if source == "tile_order.cu":
            out[source] = int(re.findall(r"\d+", K1_LINE.search(text)[0])[0])
            continue
        out[source] = tuple(
            tuple(int(x) for x in re.findall(r"\d+",
                                             LINE[mode].search(text)[0]))
            for mode in ("closest", "any_hit"))
    return out


def record_calls(cs, mt, bs, flags):
    """The recorded (kernel, what, args) calls, in the order timed, and K4's
    arguments in segment 4 of the luxball wavefront."""
    calls = []
    r = cs.make_renderer(1920, 1080, "cuda")
    saved = flags.FORCE_MK, flags.SORT_RAYS
    try:
        flags.FORCE_MK, flags.SORT_RAYS = True, False
        r.reset()
        with cs.RosRecorder(keep=(4, 5)) as rec:
            r.render_single(1)
        for args in rec.calls.values():
            calls.append(("trace_ros", f"bounce 2, any_hit={bool(args[-1])}",
                          args))
        flags.SORT_RAYS = True
        r.reset()
        with cs.RosRecorder(keep=(4, 5), name="trace_rol") as rec, \
                cs.RosRecorder(keep=(4,), name="tile_order") as rec1:
            r.render_single(1)
        for args in rec.calls.values():
            calls.append(("trace_rol", f"megastep bounce 2, "
                          f"any_hit={bool(args[-1])}", args))
        calls.append(("tile_order", "megastep bounce 2", rec1.calls[4]))
    finally:
        flags.FORCE_MK, flags.SORT_RAYS = saved
    r.init_wavefront(1 << 20)
    for seg in range(1, 25):
        with cs.LastCalls(mt, "trace_rol") as last, \
                cs.LastCalls(mt, "tile_order") as k1, \
                cs.LastCalls(bs, "splat", keep=1) as k4:
            r.render_wavefront(1)
        if seg in (4, 24):
            for args in last.calls:
                calls.append(("trace_rol", f"segment {seg}, "
                              f"any_hit={bool(args[-1])}", args))
            calls.append(("tile_order", f"segment {seg}", k1.calls[0]))
        if seg == 4:
            k4_args = k4.calls[0]
    del r
    calls += production_calls(cs, mt)
    r = cs.make_renderer(1920, 1080, "cuda", cs.LARGE)
    r.init_wavefront(1 << 20)
    for seg in range(1, 13):
        with cs.LastCalls(mt, "trace_rol_sc") as last, \
                cs.LastCalls(mt, "tile_order") as k1:
            r.render_wavefront(1)
        if seg in (4, 12):
            for args in last.calls:
                calls.append(("trace_rol_sc", f"segment {seg}, "
                              f"any_hit={bool(args[-1])}", args))
        if seg == 4:
            calls.append(("tile_order", "8x8 segment 4, superclusters",
                          k1.calls[0]))
    return calls, k4_args


def production_calls(cs, mt, segment=PROD_SEGMENT):
    """K2's two calls and K1's first call of segment ``segment`` of the
    benchmark's production cell, luxball_prod.wavefront: its configuration
    (benchmark/configs/luxball_prod.json) through the harness's own
    make_renderer (1920x1080, 1M paths, the env map and the area light)."""
    import torch
    from benchmark.bm import harness
    cfg = harness.load_json(harness.BENCH, "configs", "luxball_prod.json")
    r = harness.make_renderer(cfg, torch.device("cuda"))
    r.init_wavefront()
    r.render_wavefront(segment - 1)
    with cs.LastCalls(mt, "trace_rol") as k2, \
            cs.LastCalls(mt, "tile_order") as k1:
        r.render_wavefront(1)
    del r
    calls = [("trace_rol", f"production segment {segment}, "
              f"any_hit={bool(args[-1])}", args) for args in k2.calls]
    calls.append(("tile_order", f"production segment {segment}",
                  k1.calls[0]))
    return calls


def luxball_calls(cs, mt, segs=(4, 24)):
    """K2's two calls of the segments ``segs`` of the luxball wavefront
    (1920x1080, 1M paths)."""
    r = cs.make_renderer(1920, 1080, "cuda")
    r.init_wavefront(1 << 20)
    calls = []
    for seg in range(1, max(segs) + 1):
        with cs.LastCalls(mt, "trace_rol") as last:
            r.render_wavefront(1)
        if seg in segs:
            calls += [("trace_rol", f"segment {seg}, "
                       f"any_hit={bool(args[-1])}", args)
                      for args in last.calls]
    del r
    return calls


def megastep_calls(cs, mt, flags):
    """K2's two calls of bounce 2 of the megastep on luxball (1920x1080,
    rays sorted, as the single-set trace hands them to K2)."""
    r = cs.make_renderer(1920, 1080, "cuda")
    saved = flags.FORCE_MK, flags.SORT_RAYS
    try:
        flags.FORCE_MK, flags.SORT_RAYS = True, True
        r.reset()
        with cs.RosRecorder(keep=(4, 5), name="trace_rol") as rec:
            r.render_single(1)
    finally:
        flags.FORCE_MK, flags.SORT_RAYS = saved
    del r
    return [("trace_rol", f"megastep bounce 2, any_hit={bool(args[-1])}",
             args) for args in rec.calls.values()]


def least_worst_loss(table, kernel):
    """Per mode of ``kernel`` (closest-hit, any-hit), each shape's worst loss
    over the calls timed (ms over the call's fastest shape, less 1), and
    the shape with the least such loss."""
    out = {}
    for mode in ("any_hit=False", "any_hit=True"):
        rows = {k: v for k, v in table.items()
                if k.startswith(f"{kernel}: ") and k.endswith(mode)}
        shapes = set.intersection(*(set(v) for v in rows.values()))
        worst = {sh: max(v[sh] / min(v.values()) - 1 for v in rows.values())
                 for sh in shapes}
        out[mode] = dict(worst_loss=worst, pick=min(worst, key=worst.get))
    return out


def ranks_of(x):
    """Ranks 0..n-1 of x (ties in index order)."""
    import torch
    r = torch.empty_like(x, dtype=torch.float64)
    r[torch.argsort(x, stable=True)] = torch.arange(
        x.numel(), dtype=torch.float64, device=x.device)
    return r


def queue_study(cs, mt, calls, card, heavy=0.05, top=0.10):
    """K2's tiles on each recorded call: visits, K1's counts and how they
    rank the heavy tiles, and K2's time in three launch orders (see the
    module docstring). Prints one line per call; returns them."""
    import torch
    lines = []
    for kernel, what, args in calls:
        if kernel != "trace_rol":
            continue
        ref = mt.trace_rol(*args)
        visits, counts = ref[2], mt.live_counts(args[2])
        nt = visits.numel()
        v = visits.double()
        q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=v.device)
        qv, qc = torch.quantile(v, q), torch.quantile(counts.double(), q)
        kh, kt = max(1, int(nt * heavy)), max(1, int(nt * top))
        by_visits = torch.argsort(visits, descending=True, stable=True)
        by_count = torch.argsort(counts, descending=True, stable=True)
        rv, rc = ranks_of(visits), ranks_of(counts)
        rv, rc = rv - rv.mean(), rc - rc.mean()
        line = dict(
            kernel=kernel, call=what, tiles=nt, card=card,
            visits_p50=float(qv[0]), visits_p99=float(qv[1]),
            visits_max=int(visits.max()), visits_total=int(visits.sum()),
            k1_count_p50=float(qc[0]), k1_count_p99=float(qc[1]),
            k1_count_max=int(counts.max()),
            heavy_in_top_by_k1=float(torch.isin(
                by_visits[:kh], by_count[:kt]).float().mean()),
            heavy_share=heavy, top_share=top,
            rank_correlation=float((rv * rc).sum() / (
                rv.norm() * rc.norm()).clamp_min(1e-30)),
            heaviest_visits_share=float(visits[by_visits[:kh]].sum()
                                        / visits.sum().clamp_min(1)))
        orders = {"index": None, "visits": by_visits, "k1_count": by_count}
        runs = {}
        for name, idx in orders.items():
            sub = args if idx is None else (
                [a[idx].contiguous() for a in args[:4]] + list(args[4:]))
            got = mt.trace_rol(*sub)
            if idx is not None:
                back = []
                for x in got:
                    y = torch.empty_like(x)
                    y[idx] = x
                    back.append(y)
                got = tuple(back)
            diff = cs.trace_diffs(got, ref)
            if any(diff.values()):
                raise AssertionError(f"K2 in {name} order differs from index "
                                     f"order ({what}): {diff}")
            runs[name] = sub
        ms = {}
        for name in list(runs) + list(reversed(runs)):
            ms.setdefault(name, []).append(
                cs.time_ms(lambda: mt.trace_rol(*runs[name]), 10))
        line["ms"] = ms
        line["ms_median"] = {k: sorted(x)[len(x) // 2] for k, x in
                             ms.items()}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def exact_calls(cs):
    """K7's and K8's arguments in segment 2 of a 16-spp exact render
    (luxball, 1920x1080, 1M paths)."""
    r = cs.make_renderer(1920, 1080, "cuda")
    r.reset()
    with cs.ExactRecorder() as rec:
        r.render_single(cs.EXACT_SPP)
    return rec.early[1], rec.early[2]


def sweep_fetch(cs, kb, bs, card, baseline, fetch_args):
    """K8's K8_VERSIONS, and the fetch.cu of ``baseline`` when given, on
    the recorded call: bit-equal to fetch_plain, timed in turns. Prints
    one line per version and turn; returns {version: [ms, ms]}."""
    import ctypes
    import torch
    local, table, groups = fetch_args
    n = local.shape[0]
    dims = (n, n // groups, table.shape[1] // groups)
    versions = {}
    for name, lanes, edits in K8_VERSIONS:
        d = os.path.join(cs.TMP_ROOT, re.sub(r"\W+", "_", f"k8 {name}"))
        shutil.copytree(kb.CSRC, d)
        path = os.path.join(d, "fetch.cu")
        with open(path) as f:
            text = f.read()
        if lanes is not None:
            text, k = K8_LINE.subn(
                f"constexpr int LANES_PER_THREAD = {lanes};", text)
            if k != 1:
                raise RuntimeError("fetch.cu: no LANES_PER_THREAD line")
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"fetch.cu: no {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        versions[name] = d
    if baseline:
        versions["baseline"] = baseline
    csrc = kb.CSRC
    kernels = {}
    try:
        jobs = []
        for d in versions.values():
            kb.CSRC = d
            jobs.append(kb._start_build("fetch.cu"))
        for job in jobs:
            kb._finish_build(*job)
        for name, d in versions.items():
            kb.CSRC = d
            k = kb.Kernel(f"fetch {name}", "fetch.cu", "fetch_launch",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)
            del kb.KERNELS[k.name]         # not one of the port's kernels
            k._load()
            kernels[name] = k
    finally:
        kb.CSRC = csrc
    ref = bs.fetch_plain(local, table, groups)
    out = torch.empty_like(ref)

    def run(k):
        k(kb.ptr(local), kb.ptr(table), kb.ptr(out), *dims)
    lane = torch.arange(n, device=local.device) // dims[1]
    pid = lane * dims[2] + local.long()
    order = list(kernels) + list(reversed(kernels))
    # yardsticks: the library call, and a copy of local into out (4 B read
    # and 4 B written per lane, no gather: a 1M-lane kernel's floor)
    yard = {"torch.take": lambda: torch.take(table, pid),
            "copy of local": lambda: out.copy_(local.view(torch.float32))}
    times = {}
    for name in order + 2 * list(yard):
        if name in yard:
            ms = cs.time_ms(yard[name])
            differ = 0
        else:
            out.fill_(float("nan"))
            run(kernels[name])
            differ = int((out.view(torch.int32)
                          != ref.view(torch.int32)).sum())
            ms = cs.time_ms(lambda: run(kernels[name]))
        print(json.dumps(dict(kernel="fetch", version=name, ms=ms,
                              differ=differ, card=card,
                              call="exact segment 2, "
                                   f"{n} lanes")), flush=True)
        if differ:
            raise AssertionError(f"K8 {name} differs from fetch_plain")
        times.setdefault(name, []).append(ms)
    return times


def parent_k1(kb, mt):
    """K1 as the commit whose csrc/ kb.CSRC names ran it: its kernel
    writes the entry bounds [nt, ncl_pad], then _candidate_order sorts
    them (a stable torch.sort, a where, a cast, two copies). Loads the
    library now."""
    import ctypes
    import torch
    k = kb.Kernel("tile_order_parent", "tile_order.cu", "tile_order_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
    del kb.KERNELS[k.name]                 # not one of the port's kernels
    k._load()

    def chain(rays, tm, boxes):
        nt, _, rt = rays.shape
        ncl = boxes.shape[0]
        ncl_pad = ncl + (-ncl) % 8
        cons = torch.empty((nt, ncl_pad), dtype=torch.float32,
                           device=rays.device)
        k(kb.ptr(rays), kb.ptr(tm), kb.ptr(boxes), kb.ptr(cons), nt, rt, ncl,
          ncl_pad)
        return mt._candidate_order(cons)
    return chain


def profile_wavefront(cs, r, n=2):
    """Device operations (kernels, copies, fills) and device ms per segment
    over n luxball segments (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fluctus_tpu_torch import profiling
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render_wavefront(n)
        torch.cuda.synchronize()
    ops, dev_us = 0, 0.0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0) or 0
        if profiling.is_device_op(e):
            ops += e.count
            dev_us += dt
    return dict(device_ops_per_segment=ops / n,
                device_ms_per_segment=dev_us / n / 1e3)


def sweep_splat(cs, kb, bs, card, baseline):
    """K4 on its call of segment 4 of the luxball wavefront, the committed
    build and the block_splat.cu of ``baseline`` (when given) in turns,
    each bit-equal to splat_plain. Prints one line per turn; returns
    {version: [ms, ...]}."""
    import ctypes
    import torch
    r = cs.make_renderer(1920, 1080, "cuda")
    (local, data, film), kw = cs.record_segments(r)[(4, "splat")][0]
    del r
    g = kw["groups"]
    c, n = data.shape
    dims = (c, n, g, n // g, film.shape[1] // g)
    bs.K4._load()
    kernels = {"committed": bs.K4}
    if baseline:
        csrc = kb.CSRC
        try:
            kb.CSRC = baseline
            k = kb.Kernel("block_splat baseline", "block_splat.cu",
                          "block_splat_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)
            del kb.KERNELS[k.name]         # not one of the port's kernels
            k._load()
        finally:
            kb.CSRC = csrc
        kernels["baseline"] = k
    plain = bs.splat_plain(local, data, film, g)
    out = torch.empty_like(film)
    turns = ["baseline", "committed", "committed", "baseline"] * 3 \
        if baseline else ["committed"] * 6
    times = {}
    for name in turns:
        k = kernels[name]

        def run():
            k(kb.ptr(local), kb.ptr(data), kb.ptr(film), kb.ptr(out), *dims)
        run()
        torch.cuda.synchronize()
        differ = int((out.view(torch.int32) != plain.view(torch.int32))
                     .sum())
        line = dict(set=name, kernel="block_splat", call="luxball segment 4",
                    channels=c, ms=cs.time_ms(run), differ=differ, card=card)
        print(json.dumps(line), flush=True)
        if differ:
            raise AssertionError(f"block_splat of {name} differs from its "
                                 "plain version")
        times.setdefault(name, []).append(line["ms"])
    return times


def sweep_k2(cs, kb, mt, flags, card):
    """K2's SHAPE_SETS on its luxball (segments 4 and 24), production
    (segment PROD_SEGMENT) and megastep (bounce 2) calls, each copy bit-equal
    to the committed build; one line per set and call, then each mode's
    least worst-case loss."""
    import torch
    csrc = kb.CSRC
    base = committed_shapes(csrc)
    sets = [(n, {**base, **s}) for n, s in SHAPE_SETS
            if n == "committed" or "trace_rol.cu" in s]
    dirs = {n: shaped_copy(csrc, cs.TMP_ROOT, n,
                           {"trace_rol.cu": s["trace_rol.cu"]})
            for n, s in sets}
    jobs = []
    for d in dirs.values():                     # one nvcc per copy, at once
        kb.CSRC = d
        jobs.append(kb._start_build("trace_rol.cu"))
    for job in jobs:
        kb._finish_build(*job)
    kb.CSRC = dirs["committed"]
    mt.K2._fn = None
    calls = [c for c in luxball_calls(cs, mt) + production_calls(cs, mt)
             + megastep_calls(cs, mt, flags) if c[0] == "trace_rol"]
    torch.cuda.empty_cache()
    refs = [mt.trace_rol(*a) for _, _, a in calls]
    table = {}
    for name, shapes in sets:
        kb.CSRC = dirs[name]
        mt.K2._fn = None
        for (kernel, what, args), ref in zip(calls, refs):
            got = mt.trace_rol(*args)
            diff = cs.trace_diffs(got, ref)
            shape = shapes["trace_rol.cu"][bool(args[-1])]
            line = dict(set=name, kernel=kernel, call=what,
                        visits=int(got[2].sum()), differ=diff,
                        ms=cs.time_ms(lambda: mt.trace_rol(*args), 5),
                        shape=dict(rays_per_thread=shape[0],
                                   groups_per_cta=shape[1],
                                   ctas_per_tile=shape[2]), card=card)
            print(json.dumps(line), flush=True)
            if any(diff.values()):
                raise AssertionError(f"{name} differs from the committed "
                                     f"build: {line}")
            table.setdefault(f"{kernel}: {what}", {})[str(shape)] = \
                line["ms"]
    kb.CSRC = csrc
    mt.K2._fn = None
    print(json.dumps({"least_worst_loss": least_worst_loss(table,
                                                           "trace_rol"),
                      "ms": table}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another csrc/ directory to build "
                    "and time beside the committed one")
    ap.add_argument("--fetch-only", action="store_true",
                    help="time K8's shapes (and the baseline's) alone")
    ap.add_argument("--splat-only", action="store_true",
                    help="time K4 (and the baseline's) alone")
    ap.add_argument("--k2-only", action="store_true",
                    help="K2's shape sets alone, on its luxball, production "
                    "and megastep calls, with each mode's least worst-case "
                    "loss")
    ap.add_argument("--queue-study", action="store_true",
                    help="K2's per-tile visits, K1's counts and K2 in three "
                    "launch orders, alone")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_shapes: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    baseline = os.path.abspath(opts.baseline) if opts.baseline else None
    os.chdir(here)
    sys.path.insert(0, here)
    import chip_smoke as cs
    from fluctus_tpu_torch import flags
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.accel import mxu_trace as mt
    from fluctus_tpu_torch.core import block_splat as bs
    cs.TMP_ROOT = tempfile.mkdtemp(prefix="sweep_shapes_")
    try:
        card = cs.card_line()
        print(card, flush=True)
        kb.build_all()                  # the committed kernels, at once
        if opts.queue_study:
            calls = luxball_calls(cs, mt) + production_calls(cs, mt)
            torch.cuda.empty_cache()
            print(json.dumps(dict(sweep=cs.sweep_build_info(kb)["trace_rol"],
                                  card=card)), flush=True)
            queue_study(cs, mt, calls, card)
            return 0
        if opts.k2_only:
            return sweep_k2(cs, kb, mt, flags, card)
        if opts.splat_only:
            times = sweep_splat(cs, kb, bs, card, baseline)
            print(json.dumps({"ms": {"block_splat: luxball segment 4":
                                     times}}), flush=True)
            return 0
        k7_args, k8_args = exact_calls(cs)
        k8_times = sweep_fetch(cs, kb, bs, card, baseline, k8_args)
        if opts.fetch_only:
            print(json.dumps({"ms": {"fetch: exact segment 2": k8_times}}),
                  flush=True)
            return 0
        csrc = kb.CSRC
        base = committed_shapes(csrc)
        sets = [(n, {**base, **s}) for n, s in SHAPE_SETS]
        dirs = {n: shaped_copy(csrc, cs.TMP_ROOT, n, s) for n, s in sets}
        builds = {n: SOURCES for n in dirs}
        for name, edits in K1_PARTS:
            dirs[name] = part_copy(csrc, cs.TMP_ROOT, name, edits)
            builds[name] = ("tile_order.cu",)
        builds["committed"] = tuple(sorted(
            f for f in os.listdir(csrc) if f.endswith(".cu")))
        if baseline:
            dirs["baseline"] = shutil.copytree(
                baseline, os.path.join(cs.TMP_ROOT, "baseline"))
            builds["baseline"] = SOURCES + ("block_splat_capped.cu",
                                            "block_splat.cu")
        jobs = []
        for n, d in dirs.items():               # one nvcc per copy, at once
            kb.CSRC = d
            jobs += [kb._start_build(source) for source in builds[n]]
        for job in jobs:
            kb._finish_build(*job)

        def use(name):
            kb.CSRC = dirs[name]
            for k in (mt.K2, mt.K5, mt.K9, bs.K7, bs.K4):
                k._fn = None
            if name != "baseline":
                mt.K1._fn = None

        if baseline:
            kb.CSRC = dirs["baseline"]
            k1_parent = parent_k1(kb, mt)
        use("committed")
        calls, k4_args = record_calls(cs, mt, bs, flags)
        torch.cuda.empty_cache()
        wrappers = {"trace_ros": lambda a: mt.trace_ros(*a),
                    "trace_rol": lambda a: mt.trace_rol(*a),
                    "trace_rol_sc": lambda a: mt.trace_rol_sc(*a),
                    "tile_order": lambda a: mt.tile_order(*a)}
        refs = [wrappers[k](a) for k, _, a in calls]
        table = {}
        runs = sets + ([("baseline", None)] if baseline else [])
        for name, shapes in runs:
            use(name)
            for (kernel, what, args), ref in zip(calls, refs):
                run = wrappers[kernel]
                if kernel == "tile_order" and name == "baseline":
                    run = lambda a: k1_parent(*a)   # noqa: E731
                got = run(args)
                if kernel == "tile_order":
                    diff = cs.tile_order_diffs(got, ref)
                    line = dict(set=name, kernel=kernel, call=what)
                else:
                    diff = cs.trace_diffs(got, ref)
                    line = dict(set=name, kernel=kernel, call=what,
                                visits=int(got[2].sum()))
                line.update(ms=cs.time_ms(lambda: run(args), 5),
                            differ=diff, card=card)
                if kernel == "tile_order" and name == "committed":
                    line["octant_warps"] = cs.octant_warps(
                        args[0], base["tile_order.cu"])
                key = name
                if shapes is not None:
                    shape = shapes[KERNEL_OF[kernel]]
                    if kernel == "tile_order":
                        line["shape"] = dict(rays_per_thread=shape)
                    else:
                        shape = shape[bool(args[-1])]
                        line["shape"] = dict(rays_per_thread=shape[0],
                                             groups_per_cta=shape[1],
                                             ctas_per_tile=shape[2])
                    key = str(shape)
                print(json.dumps(line), flush=True)
                if any(diff.values()):
                    raise AssertionError(f"{name} differs from the committed "
                                         f"build: {line}")
                table.setdefault(f"{kernel}: {what}", {})[key] = line["ms"]
        for name, _ in K1_PARTS:
            use(name)
            for kernel, what, args in calls:
                if kernel == "tile_order":
                    ms = cs.time_ms(lambda: mt.tile_order(*args), 5)
                    print(json.dumps(dict(set=name, kernel=kernel, call=what,
                                          ms=ms, card=card)), flush=True)
                    table.setdefault(f"{kernel}: {what}, parts", {})[
                        name] = ms
        if baseline:
            splats = [("block_splat", "luxball segment 4", k4_args, None),
                      ("block_splat_capped", "exact segment 2", k7_args,
                       True)]
            for kernel, what, args, capped in splats:
                local, data, film, g = args[:4]
                rem = args[4] if capped else None
                plain = (bs.splat_plain(local, data, film, g) if rem is None
                         else bs.splat_capped_plain(local, data, film, g,
                                                    rem))
                for name in ("baseline", "committed", "committed",
                             "baseline"):
                    use(name)
                    out = bs.splat(local, data, film, g, remaining=rem)
                    differ = int((out.view(torch.int32)
                                  != plain.view(torch.int32)).sum())
                    ms = cs.time_ms(lambda: bs.splat(local, data, film, g,
                                                     remaining=rem))
                    line = dict(set=name, kernel=kernel, call=what, ms=ms,
                                differ=differ, card=card)
                    print(json.dumps(line), flush=True)
                    if differ:
                        raise AssertionError(f"{kernel} of {name} differs "
                                             f"from its plain version")
                    table.setdefault(f"{kernel}: {what}", {}).setdefault(
                        name, []).append(ms)
            # device operations per luxball segment with each K1
            use("committed")
            r = cs.make_renderer(1920, 1080, "cuda")
            r.init_wavefront(1 << 20)
            r.render_wavefront(2)
            fused = mt.tile_order
            for name, k1 in (("baseline", k1_parent), ("committed", fused),
                             ("committed", fused), ("baseline", k1_parent)):
                mt.tile_order = k1
                try:
                    prof = profile_wavefront(cs, r)
                finally:
                    mt.tile_order = fused
                print(json.dumps(dict(set=name, what="luxball wavefront, "
                                      "per segment", card=card, **prof)),
                      flush=True)
        use("committed")
        table["fetch: exact segment 2"] = k8_times
        fastest = {k: min((n for n in v if n not in ("torch.take",
                                                      "copy of local")),
                          key=lambda n: min(v[n]) if isinstance(
                              v[n], list) else v[n])
                   for k, v in table.items() if not k.endswith(", parts")}
        print(json.dumps({"fastest": fastest, "ms": table}), flush=True)
        return 0
    finally:
        kb.CSRC = os.path.join(here, "fluctus_tpu_torch", "csrc")
        shutil.rmtree(cs.TMP_ROOT, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
