"""Final frames, one after another: the exact-spp job of fluctus's
``-s`` (``Tracer::renderSingle`` with the denoiser). Each job is what a
user's script does: ``reset()``, ``render_single(spp)`` (the wavefront
under the spp cap until every pixel has ``spp`` samples) and
``save_denoised`` of an 8-bit PNG under the run's temporary directory
(the a-trous denoise of the film, guided by the first-hit albedo and
normal, tonemapped).

Parameters: ``spp`` a job; ``warm_jobs`` run in set-up, after the
denoiser is turned on (``settings.use_denoiser``, ``rebuild_config``);
``trace_spp``, the spp of the one job that ``--trace 1`` profiles after
the window; ``denoise``, the filter's ``iterations``, ``sigma_color``,
``sigma_albedo``, ``sigma_normal`` and ``blend`` (the blend is handed to
``save_denoised``; the rest are what the reference holds the program's
filter to).

The window runs jobs back to back until ``seconds`` have passed, and
ends when the job in flight ends. ``msamples_s`` is the finished jobs'
film weight (their true pixels' samples, read from the film after each
job) over the window's wall seconds. ``attempted`` counts jobs. The
capped ring's counters (``Renderer.capped_stats``, where the program has
them) are summed over the window's jobs.

The check (``numbers``) holds the last job to the reference: one of its
segments as the free-running cells' last is held (``reference.exact``,
under the cap, with the guide features; ``bm/job_probe.py`` keeps the
second segment of the job's last round of 16, the last one sure to hold
live paths beside idle ones), every true pixel's weight against
the job's target (``spp_gap``, exact), the film's values
(``film_bad``), the denoised image against the reference's filter of the
program's own film and features (``denoise_err``, ``reference.denoise``)
and the PNG's pixels against the reference's tonemap of that image
(``frame_bad``: pixels more than one 8-bit step off)."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace


def _job(s, spp):
    r = s.r
    r.reset()
    s.probe.job.begin()
    r.render_single(spp)
    r.save_denoised(s.frame_path, blend=s.params["denoise"]["blend"])
    s.job_spp = spp
    return float(r.film.weight.double().sum())


def run(s):
    from benchmark.bm.job_probe import JobProbe
    r, p = s.r, s.params
    if not hasattr(s.probe, "job"):
        s.probe.job = JobProbe(s.probe)
        s.probe.job.install()
    s.frame_path = os.path.join(s.tmp_dir, "bm_job.png")
    r.settings.use_denoiser = True
    r.rebuild_config()
    for _ in range(p["warm_jobs"]):
        _job(s, p["spp"])
    s.setup_done()
    capped = getattr(r, "capped_stats", None)
    seg0 = s.probe.segments
    samples, jobs, held, lane_segments = 0.0, [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < s.seconds:
        t = time.perf_counter()
        samples += _job(s, p["spp"])
        jobs.append(time.perf_counter() - t)
        if capped is not None:
            c = capped()
            held += c.held
            lane_segments += c.segments * c.lanes
    elapsed = time.perf_counter() - t0
    srt = sorted(jobs)
    s.window = dict(seconds=elapsed, jobs=len(jobs), samples=samples,
                    segments=s.probe.segments - seg0,
                    job_s_quartiles=[round(srt[len(srt) * q // 4], 5)
                                     for q in (0, 1, 2, 3)]
                    + [round(srt[-1], 5)])
    if capped is not None:
        s.window.update(held_lanes=held, lane_segments=lane_segments)
    s.e2e["msamples_s"] = samples / elapsed / 1e6
    s.attempted, s.failed = len(jobs), 0
    if s.trace:
        s.trace_begin()
        _job(s, p["trace_spp"])
        s.trace_end()


def job_segment(cap, ref):
    """The kept capture as the reference reads it: a ``capture.Segment``
    with ``spp0``, the pixel counts before the segment, and ``features``,
    the feature films before and after with the segment's records."""
    import torch

    from benchmark.bm.capture import Segment
    if cap is None or "features" not in cap:
        raise KeyError("no segment with its guide-feature splat was kept")
    seg = Segment(cap, ref.params())
    st0, st1 = cap["state_in"], cap["state_out"]
    stack = lambda f: torch.stack([*f.albedo, f.albedo_w, *f.normal,
                                   f.normal_w])
    seg.spp0 = st0.spp
    seg.features = dict(film0=stack(st0.features), film1=stack(st1.features),
                        **cap["features"])
    return seg


def logic_config(cfg, r):
    """What the reference's logic reads of a configuration."""
    return SimpleNamespace(width=r.width, height=r.height,
                           max_bounces=cfg["maxPathDepth"],
                           sample_impl=cfg["sampleImplicit"],
                           sample_expl=cfg["sampleExplicit"])


def numbers(s, ref, control=None):
    import torch

    from benchmark.reference import checks, denoise, exact

    seg = job_segment(s.probe.job.kept, ref)
    c = s.cfg
    cfg = logic_config(c, s.r)
    target = s.job_spp
    out = exact.exact_segment_numbers(seg, ref, cfg,
                                      s.cell["check"]["lanes"], s.seed,
                                      target, control=control)
    r, p = s.r, s.params["denoise"]
    exposure, tm = c.get("exposure", 1.0), c["tonemap"]
    den = lambda dt: denoise.denoised(r.film, r.features, r.height, r.width,
                                      p, dt)
    ref_img = den(torch.float64)
    ref_levels = denoise.levels(ref_img, exposure, tm)
    if control is None:
        f = r.film
        out["film_bad"] = checks.film_bad(torch.stack([*f.color, f.weight]))
        out["spp_gap"] = exact.spp_gap(f.weight, target)
        img = s.probe.job.denoised
        out["denoise_err"] = denoise.denoise_error(img, ref_img)
        out["frame_bad"] = denoise.frame_off(
            checks.read_png(s.frame_path), ref_levels)
    else:
        img = den(control)
        out["denoise_err"] = denoise.denoise_error(img, ref_img)
        out["frame_bad"] = denoise.frame_off(
            denoise.levels(img, exposure, tm), ref_levels)
    return out
