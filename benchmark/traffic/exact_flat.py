"""Final frames on the flat pixel ring, one after another: the exact-spp
job of fluctus's ``.bm.json`` run with ``maxSpp`` (the wavefront under
the CHECK_SPP cap until every pixel has its samples, then
``<out>.png``; tracer.cpp:567-873) on fluctus's own single pixel ring
(wf_raygen.cl:25), which the port runs when ``Settings.wf_block_ring``
is off (the configuration's ``wfBlockRing: false``) or when its groups do
not divide the pool. Each job is what a user's script does: ``reset()``,
``render_single(spp)`` and ``save_image`` of the film's 8-bit PNG under
the run's temporary directory; no denoiser.

Parameters: ``spp`` a job; ``warm_jobs`` run in set-up; ``trace_spp``,
the spp of the one job that ``--trace 1`` profiles after the window.

The window runs jobs back to back until ``seconds`` have passed, and
ends when the job in flight ends. ``msamples_s`` is the finished jobs'
film weight (their pixels' samples, read from the film after each job)
over the window's wall seconds. ``attempted`` counts jobs. The capped
ring's counters (``Renderer.capped_stats``, where the program has them)
are summed over the window's jobs: the lanes held idle, and, where the
program counts them, the paths admitted and refused.

The check (``numbers``) holds the last job to the reference: its kept
segment (``bm/job_probe.py``: the second of its last round of 16) is
followed by ``reference.flat_exact`` (the trace, the hit records, the
lane logic under the cap, the film's admission and scatter, the count
table and the raygen), every pixel's weight against the job's target
(``spp_gap``, exact), the film's values (``film_bad``) and the PNG's
8-bit values against the reference's tonemap of the program's own film
(``frame_bad``)."""

from __future__ import annotations

import os
import time


def _job(s, spp):
    r = s.r
    r.reset()
    s.probe.job.begin()
    r.render_single(spp)
    r.save_image(s.frame_path)
    s.job_spp = spp
    return float(r.film.weight.double().sum())


def run(s):
    from benchmark.bm.flat_capture import FlatJobProbe
    r, p = s.r, s.params
    if not hasattr(s.probe, "job"):
        s.probe.job = FlatJobProbe(s.probe)
        s.probe.job.install()
    s.frame_path = os.path.join(s.tmp_dir, "bm_flat.png")
    for _ in range(p["warm_jobs"]):
        _job(s, p["spp"])
    s.setup_done()
    capped = getattr(r, "capped_stats", None)
    seg0 = s.probe.segments
    samples, jobs, held, lane_segments = 0.0, [], 0, 0
    admitted, refused = 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < s.seconds:
        t = time.perf_counter()
        samples += _job(s, p["spp"])
        jobs.append(time.perf_counter() - t)
        if capped is not None:
            c = capped()
            held += c.held
            lane_segments += c.segments * c.lanes
            admitted += c.admitted
            got = getattr(c, "refused", None)
            if got is not None:
                refused = (refused or 0) + got
    elapsed = time.perf_counter() - t0
    srt = sorted(jobs)
    s.window = dict(seconds=elapsed, jobs=len(jobs), samples=samples,
                    segments=s.probe.segments - seg0,
                    job_s_quartiles=[round(srt[len(srt) * q // 4], 5)
                                     for q in (0, 1, 2, 3)]
                    + [round(srt[-1], 5)])
    if capped is not None:
        s.window.update(held_lanes=held, lane_segments=lane_segments)
    if refused is not None:
        s.window.update(admitted_paths=admitted, refused_paths=refused)
    s.e2e["msamples_s"] = samples / elapsed / 1e6
    s.attempted, s.failed = len(jobs), 0
    if s.trace:
        s.trace_begin()
        _job(s, p["trace_spp"])
        s.trace_end()


def numbers(s, ref, control=None):
    import torch

    from benchmark.bm import harness
    from benchmark.bm.flat_capture import FlatSegment
    from benchmark.reference import checks, exact, flat_exact

    cap = s.probe.job.kept
    if cap is None:
        raise KeyError("no segment of the job was kept")
    seg = FlatSegment(cap, ref.params())
    c, r = s.cfg, s.r
    cfg = harness.load_module("traffic", "exact_job").logic_config(c, r)
    target = s.job_spp
    out = flat_exact.flat_segment_numbers(seg, ref, cfg,
                                          s.cell["check"]["lanes"], s.seed,
                                          target, control=control)
    f = r.film
    lv = lambda dt: checks.frame_levels(f.color, f.weight, r.width,
                                        r.height, c.get("exposure", 1.0),
                                        c["tonemap"], dt)
    ref_levels = lv(torch.float64)
    if control is None:
        out["film_bad"] = checks.film_bad(torch.stack([*f.color, f.weight]))
        out["spp_gap"] = exact.spp_gap(f.weight, target)
        out["frame_bad"] = checks.frame_bad(checks.read_png(s.frame_path),
                                            ref_levels)
    else:
        out["frame_bad"] = checks.frame_bad(lv(control), ref_levels)
    return out

