#!/usr/bin/env python3
"""Time the Hopper sweep's kernels — K2 (trace_rol), K5 (trace_rol_sc) and
K9 (trace_ros) — under other sweep shapes on one GPU.

Each kernel picks its shape per mode in its source, as
``Config<rays per thread, ray groups per CTA, CTAs per tile>``
(fluctus_tpu_torch/csrc/trace_rol.cu, trace_rol_sc.cu, trace_ros.cu; the
sweep is csrc/sweep_hopper.cuh). This script copies csrc/ once per shape
set, rewrites those lines in the copy, builds every copy with nvcc (in
parallel), and times each on the same recorded inputs:

- K2: the closest-hit and any-hit calls of segments 4 and 24 of the
  wavefront on luxball (1920x1080, 1M paths), and of bounce 2 of the
  megastep (rays sorted, as the single-set trace hands them to K2);
- K9: the closest-hit and the any-hit call of bounce 2 of the megastep
  with SORT_RAYS off (luxball, 1920x1080, rays in lane order);
- K5: the closest-hit and any-hit calls of segments 4 and 12 of the
  wavefront on the 8x8 luxball grid (1920x1080, 1M paths).

Every copy's t (as bits), columns and visit counts must equal those of the
committed build; times are device times (CUDA events, median of 5, a spin
kernel hiding the launch, as chip_smoke.py times kernels). Prints the card
line, one JSON line per shape set and call, and a summary line.

With ``--baseline DIR`` (another csrc/ directory with the same launchers,
for example that of an earlier commit) it also builds K2, K5, K7
(block_splat_capped) and K9 from DIR and times them on the same calls,
and K7 of both builds on its call of segment 2 of a 16-spp exact render:
two versions compared within one run on one card.

Run from the repository root: ``python3 sweep_shapes.py [--baseline DIR]``.
"""

import argparse
import json
import os
import re
import shutil
import sys
import tempfile

SOURCES = ("trace_rol.cu", "trace_rol_sc.cu", "trace_ros.cu")
KERNEL_OF = {"trace_rol": "trace_rol.cu", "trace_rol_sc": "trace_rol_sc.cu",
             "trace_ros": "trace_ros.cu"}
# per source (closest-hit, any-hit) shapes; a source left out keeps its
# committed shapes. The first set is the committed one.
SHAPE_SETS = [
    ("committed", {}),
    ("a", {"trace_rol_sc.cu": ((2, 4, 1), (1, 2, 2)),
           "trace_ros.cu": ((2, 2, 1), (1, 2, 1)),
           "trace_rol.cu": ((2, 1, 1), (1, 1, 1))}),
    ("b", {"trace_rol_sc.cu": ((2, 2, 2), (1, 1, 4)),
           "trace_ros.cu": ((1, 2, 1), (2, 1, 1)),
           "trace_rol.cu": ((2, 4, 2), (1, 2, 2))}),
    ("c", {"trace_rol_sc.cu": ((2, 1, 4), (2, 4, 2)),
           "trace_ros.cu": ((4, 2, 1), (2, 2, 1)),
           "trace_rol.cu": ((2, 2, 1), (1, 2, 1))}),
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


def shaped_copy(csrc, root, name, shapes):
    """A copy of csrc/ with the Config lines of the sources in ``shapes``
    ({source: (closest, any_hit)}) rewritten."""
    d = os.path.join(root, name)
    shutil.copytree(csrc, d)
    for source, (closest, any_hit) in shapes.items():
        path = os.path.join(d, source)
        with open(path) as f:
            text = f.read()
        for mode, shape in (("closest", closest), ("any_hit", any_hit)):
            kind = "Closest" if mode == "closest" else "AnyHit"
            text, n = LINE[mode].subn(
                f"using {kind} = hs::Config<{shape[0]}, {shape[1]}, "
                f"{shape[2]}>;", text)
            if n != 1:
                raise RuntimeError(f"{source}: no {kind} shape line")
        with open(path, "w") as f:
            f.write(text)
    return d


def committed_shapes(csrc):
    """{source: (closest, any_hit)} as the sources in csrc/ set them."""
    out = {}
    for source in SOURCES:
        with open(os.path.join(csrc, source)) as f:
            text = f.read()
        out[source] = tuple(
            tuple(int(x) for x in re.findall(r"\d+",
                                             LINE[mode].search(text)[0]))
            for mode in ("closest", "any_hit"))
    return out


def record_calls(cs, mt, flags):
    """The recorded (kernel, what, args) calls, in the order timed."""
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
        with cs.RosRecorder(keep=(4, 5), name="trace_rol") as rec:
            r.render_single(1)
        for args in rec.calls.values():
            calls.append(("trace_rol", f"megastep bounce 2, "
                          f"any_hit={bool(args[-1])}", args))
    finally:
        flags.FORCE_MK, flags.SORT_RAYS = saved
    r.init_wavefront(1 << 20)
    for seg in range(1, 25):
        with cs.LastCalls(mt, "trace_rol") as last:
            r.render_wavefront(1)
        if seg in (4, 24):
            for args in last.calls:
                calls.append(("trace_rol", f"segment {seg}, "
                              f"any_hit={bool(args[-1])}", args))
    del r
    r = cs.make_renderer(1920, 1080, "cuda", cs.LARGE)
    r.init_wavefront(1 << 20)
    for seg in range(1, 13):
        with cs.LastCalls(mt, "trace_rol_sc") as last:
            r.render_wavefront(1)
        if seg in (4, 12):
            for args in last.calls:
                calls.append(("trace_rol_sc", f"segment {seg}, "
                              f"any_hit={bool(args[-1])}", args))
    return calls


def k7_call(cs):
    """K7's arguments in segment 2 of a 16-spp exact render (luxball,
    1920x1080, 1M paths)."""
    r = cs.make_renderer(1920, 1080, "cuda")
    r.reset()
    with cs.ExactRecorder() as rec:
        r.render_single(cs.EXACT_SPP)
    local, data, film, g, rem = rec.early[1]
    return local, data, film, g, rem


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another csrc/ directory to build "
                    "and time beside the committed one")
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
        csrc = kb.CSRC
        base = committed_shapes(csrc)
        sets = [(n, {**base, **s}) for n, s in SHAPE_SETS]
        dirs = {n: shaped_copy(csrc, cs.TMP_ROOT, n, s) for n, s in sets}
        builds = {n: SOURCES for n in dirs}
        builds["committed"] = tuple(sorted(
            f for f in os.listdir(csrc) if f.endswith(".cu")))
        if baseline:
            dirs["baseline"] = shutil.copytree(
                baseline, os.path.join(cs.TMP_ROOT, "baseline"))
            builds["baseline"] = SOURCES + ("block_splat_capped.cu",)
        jobs = []
        for n, d in dirs.items():               # one nvcc per copy, at once
            kb.CSRC = d
            jobs += [kb._start_build(source) for source in builds[n]]
        for job in jobs:
            kb._finish_build(*job)

        def use(name):
            kb.CSRC = dirs[name]
            for k in (mt.K2, mt.K5, mt.K9, bs.K7):
                k._fn = None

        use("committed")
        calls = record_calls(cs, mt, flags)
        torch.cuda.empty_cache()
        wrappers = {"trace_ros": lambda a: mt.trace_ros(*a),
                    "trace_rol": lambda a: mt.trace_rol(*a),
                    "trace_rol_sc": lambda a: mt.trace_rol_sc(*a)}
        refs = [wrappers[k](a) for k, _, a in calls]
        table = {}
        runs = sets + ([("baseline", None)] if baseline else [])
        for name, shapes in runs:
            use(name)
            for (kernel, what, args), ref in zip(calls, refs):
                run = wrappers[kernel]
                got = run(args)
                diff = cs.trace_diffs(got, ref)
                ms = cs.time_ms(lambda: run(args), 5)
                line = dict(set=name, kernel=kernel, call=what, ms=ms,
                            visits=int(got[2].sum()), differ=diff, card=card)
                key = name
                if shapes is not None:
                    shape = shapes[KERNEL_OF[kernel]][bool(args[-1])]
                    line["shape"] = dict(rays_per_thread=shape[0],
                                         groups_per_cta=shape[1],
                                         ctas_per_tile=shape[2])
                    key = str(shape)
                print(json.dumps(line), flush=True)
                if any(diff.values()):
                    raise AssertionError(f"{name} differs from the committed "
                                         f"build: {line}")
                table.setdefault(f"{kernel}: {what}", {})[key] = ms
        if baseline:
            args = k7_call(cs)
            for name in ("baseline", "committed", "committed", "baseline"):
                use(name)
                out = bs.splat(*args[:4], remaining=args[4])
                differ = int((out.view(torch.int32) != bs.splat_capped_plain(
                    *args).view(torch.int32)).sum())
                ms = cs.time_ms(lambda: bs.splat(*args[:4],
                                                 remaining=args[4]))
                line = dict(set=name, kernel="block_splat_capped",
                            call="exact segment 2", ms=ms, differ=differ,
                            card=card)
                print(json.dumps(line), flush=True)
                if differ:
                    raise AssertionError(f"K7 of {name} differs from its "
                                         f"plain version")
                table.setdefault("block_splat_capped: exact segment 2",
                                 {}).setdefault(name, []).append(ms)
        use("committed")
        fastest = {k: min(v, key=lambda n: min(v[n]) if isinstance(
            v[n], list) else v[n]) for k, v in table.items()}
        print(json.dumps({"fastest": fastest, "ms": table}), flush=True)
        return 0
    finally:
        kb.CSRC = os.path.join(here, "fluctus_tpu_torch", "csrc")
        shutil.rmtree(cs.TMP_ROOT, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
