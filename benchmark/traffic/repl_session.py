"""An interactive session in a closed loop: one user who waits for each
frame (``interactive.run_interactive`` on a command stream). Set-up sends
``preview 1`` and ``speed``, then ``warm_commands`` camera moves. The
window then sends moves until ``seconds`` have passed. The moves come
in blocks of eight drawn from the seed: ``w``/``s``, ``a``/``d``,
``r``/``f`` and a ``look dx dy`` with its inverse, the four in a seeded
order and then their inverses in another, so that every seed sends the
same work and the view stays on the scene. Each move restarts the
accumulation, renders the preview (2 segments and the in-flight paths'
film) and writes the 1080p PNG under the run's temporary directory.
A refresh's latency runs from handing the command to the session to
the session asking for the next one; a refresh that writes no frame
failed and counts as missing in the 90th percentile."""

from __future__ import annotations

import math
import os
import random
import time

PAIRS = (("w", "s"), ("a", "d"), ("r", "f"))


def command_blocks(seed: int, look_deg):
    """An endless stream of (command, move) pairs; ``move`` is what the
    command does to the camera, for the reference to replay."""
    rng = random.Random(seed)
    lo, hi = look_deg
    axis = {"w": ("fwd", 1), "s": ("fwd", -1), "d": ("right", 1),
            "a": ("right", -1), "r": ("up", 1), "f": ("up", -1)}
    while True:
        dx = rng.uniform(lo, hi) * rng.choice((-1, 1))
        dy = rng.uniform(lo, hi) * rng.choice((-1, 1))
        fwd = [(c, b) for c, b in PAIRS]
        order = rng.sample(range(4), 4)
        back = rng.sample(range(4), 4)
        for half, idx in ((0, order), (1, back)):
            for k in idx:
                if k == 3:
                    sx, sy = (dx, dy) if half == 0 else (-dx, -dy)
                    sx, sy = float(f"{sx:.4f}"), float(f"{sy:.4f}")
                    yield f"look {sx:.4f} {sy:.4f}", ("look", sx, sy)
                else:
                    c = fwd[k][half]
                    yield c, ("move", *axis[c])


def p90(values):
    """Nearest-rank 90th percentile (a failed refresh is inf)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)] if v else None


def run(s):
    from fluctus_tpu_torch.interactive import run_interactive
    r, p = s.r, s.params
    r.init_wavefront()
    s.frame_path = os.path.join(s.tmp_dir, "bm_frame.png")
    s.moves = [("speed", p["speed"])]
    stream = command_blocks(s.seed, p["look_deg"])
    probe = s.probe

    def feed():
        yield "preview 1"
        yield f"speed {p['speed']}"
        for _ in range(p["warm_commands"]):
            c, m = next(stream)
            s.moves.append(m)
            yield c
        s.setup_done()
        lat, failed = [], 0
        t0 = time.perf_counter()
        frame_s0, frames0 = probe.frame_s, probe.frames
        while time.perf_counter() - t0 < s.seconds:
            c, m = next(stream)
            s.moves.append(m)
            before = probe.frames
            t = time.perf_counter()
            yield c
            dt = time.perf_counter() - t
            ok = probe.frames > before
            failed += not ok
            lat.append(dt if ok else math.inf)
        srt = sorted(lat)
        s.window = dict(seconds=time.perf_counter() - t0,
                        refreshes=len(lat),
                        refresh_ms_quartiles=[
                            round(srt[len(srt) * q // 4] * 1e3, 3)
                            for q in (0, 1, 2, 3)] + [round(srt[-1] * 1e3,
                                                            3)],
                        frame_ms=((probe.frame_s - frame_s0) * 1e3
                                  / max(probe.frames - frames0, 1)))
        if lat:
            s.e2e["refresh_p90_ms"] = p90(lat) * 1e3
        s.attempted, s.failed = len(lat), failed
        if s.trace:
            s.trace_begin()
            for _ in range(p["trace_commands"]):
                c, m = next(stream)
                s.moves.append(m)
                yield c
            s.trace_end()
        yield "q"

    run_interactive(r, out_path=s.frame_path, input_stream=feed(),
                    echo=False)


def numbers(s, ref, control=None):
    import torch

    from benchmark.bm.capture import Segment
    from benchmark.reference import checks
    out = s.segment_numbers(Segment(s.probe.last, ref.params(s.moves)),
                            ref, control)
    f = s.r.film
    lv = lambda dt: checks.frame_levels(
        f.color, f.weight, s.r.width, s.r.height, s.cfg.get("exposure", 1.0),
        s.cfg["tonemap"], dt)
    ref_levels = lv(torch.float64)
    if control is None:
        out["frame_bad"] = checks.frame_bad(checks.read_png(s.frame_path),
                                            ref_levels)
    else:
        out["frame_bad"] = checks.frame_bad(lv(control), ref_levels)
    return out
