#!/usr/bin/env python3
"""Time K5 (trace_rol_sc) and K9 (trace_ros) under other sweep shapes on
one GPU.

Each kernel picks its shape per mode in its source, as
``Config<rays per thread, ray groups per CTA, CTAs per tile>``
(fluctus_tpu_torch/csrc/trace_rol_sc.cu, trace_ros.cu; the sweep is
csrc/sweep_hopper.cuh). This script copies csrc/ once per shape set,
rewrites those two lines in the copy, builds every copy with nvcc (in
parallel), and times each on the same recorded inputs:

- K9: the closest-hit and the any-hit call of bounce 2 of the megastep
  with SORT_RAYS off (luxball, 1920x1080, rays in lane order);
- K5: the closest-hit and any-hit calls of segments 4 and 12 of the
  wavefront on the 8x8 luxball grid (1920x1080, 1M paths).

Every copy's t (as bits), columns and visit counts must equal those of the
committed build; times are device times (CUDA events, median of 5, a spin
kernel hiding the launch, as chip_smoke.py times kernels). Prints the
card line, one JSON line per shape set and call, and a summary line.

Run from the repository root with no arguments: ``python3 sweep_shapes.py``.
"""

import json
import os
import re
import shutil
import sys
import tempfile

# (K5 closest, K5 any-hit, K9 closest, K9 any-hit); the first is the
# committed set, each later one changes the shapes to compare
SHAPE_SETS = [
    ("committed", None),
    ("a", ((2, 4, 1), (1, 2, 2), (2, 2, 1), (1, 2, 1))),
    ("b", ((2, 2, 2), (1, 1, 4), (1, 2, 1), (2, 1, 1))),
    ("c", ((2, 1, 4), (2, 4, 2), (4, 2, 1), (2, 2, 1))),
    ("d", ((2, 1, 8), (2, 2, 2), (2, 4, 1), (1, 1, 1))),
    ("e", ((4, 4, 2), (1, 1, 2), (2, 1, 1), (1, 1, 1))),
]
LINE = {"closest": re.compile(r"using Closest = hs::Config<[^>]*>;"),
        "any_hit": re.compile(r"using AnyHit = hs::Config<[^>]*>;")}


def shaped_copy(csrc, root, name, shapes):
    """A copy of csrc/ with the Config lines of K5 and K9 set to shapes."""
    d = os.path.join(root, name)
    shutil.copytree(csrc, d)
    k5c, k5a, k9c, k9a = shapes
    for source, (closest, any_hit) in (("trace_rol_sc.cu", (k5c, k5a)),
                                       ("trace_ros.cu", (k9c, k9a))):
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
    out = []
    for source in ("trace_rol_sc.cu", "trace_ros.cu"):
        with open(os.path.join(csrc, source)) as f:
            text = f.read()
        for mode in ("closest", "any_hit"):
            m = LINE[mode].search(text)
            out.append(tuple(int(x) for x in re.findall(r"\d+", m.group(0))))
    return tuple(out)


def main():
    import torch
    if not torch.cuda.is_available():
        print("sweep_shapes: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    import chip_smoke as cs
    from fluctus_tpu_torch import flags
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.accel import mxu_trace as mt
    cs.TMP_ROOT = tempfile.mkdtemp(prefix="sweep_shapes_")
    try:
        card = cs.card_line()
        print(card, flush=True)
        csrc = kb.CSRC
        sets = [(n, s or committed_shapes(csrc)) for n, s in SHAPE_SETS]
        dirs = {n: shaped_copy(csrc, cs.TMP_ROOT, n, s) for n, s in sets}
        jobs = []
        for n, d in dirs.items():               # one nvcc per copy, at once
            kb.CSRC = d
            for source in ("trace_rol_sc.cu", "trace_ros.cu"):
                jobs.append(kb._start_build(source))
        for job in jobs:
            kb._finish_build(*job)

        def use(name):
            kb.CSRC = dirs[name]
            mt.K5._fn = mt.K9._fn = None

        calls = []                              # (kernel, what, args)
        use("committed")
        r = cs.make_renderer(1920, 1080, "cuda")
        saved = flags.FORCE_MK, flags.SORT_RAYS
        flags.FORCE_MK, flags.SORT_RAYS = True, False
        try:
            r.reset()
            with cs.RosRecorder(keep=(4, 5)) as rec:
                r.render_single(1)
        finally:
            flags.FORCE_MK, flags.SORT_RAYS = saved
        for idx, args in sorted(rec.calls.items()):
            calls.append(("trace_ros", f"bounce 2, any_hit={bool(args[-1])}",
                          args))
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
        del r
        torch.cuda.empty_cache()

        wrappers = {"trace_ros": lambda a: mt.trace_ros(*a),
                    "trace_rol_sc": lambda a: mt.trace_rol_sc(*a)}
        refs = [wrappers[k](a) for k, _, a in calls]
        table = {}
        for name, shapes in sets:
            use(name)
            for (kernel, what, args), ref in zip(calls, refs):
                run = wrappers[kernel]
                got = run(args)
                diff = cs.trace_diffs(got, ref)
                any_hit = bool(args[-1])
                shape = shapes[(0 if kernel == "trace_rol_sc" else 2)
                               + any_hit]
                ms = cs.time_ms(lambda: run(args), 5)
                line = dict(set=name, kernel=kernel, call=what,
                            shape=dict(rays_per_thread=shape[0],
                                       groups_per_cta=shape[1],
                                       ctas_per_tile=shape[2]),
                            ms=ms, visits=int(got[2].sum()), differ=diff,
                            card=card)
                print(json.dumps(line), flush=True)
                if any(diff.values()):
                    raise AssertionError(f"shape set {name} differs from the "
                                         f"committed build: {line}")
                table.setdefault(f"{kernel}: {what}", {})[str(shape)] = ms
        use("committed")
        print(json.dumps({"fastest": {k: min(v, key=v.get)
                                      for k, v in table.items()},
                          "ms": table}), flush=True)
        return 0
    finally:
        kb.CSRC = os.path.join(here, "fluctus_tpu_torch", "csrc")
        shutil.rmtree(cs.TMP_ROOT, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
