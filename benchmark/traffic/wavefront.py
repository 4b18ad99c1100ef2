"""Free-running wavefront: a progressive render that refines until it is
stopped (``Renderer.render_wavefront``). Set-up warms the pool for
``warm_segments`` segments; the window then runs chunks of
``chunk_segments`` (each ending in a device sync) until ``seconds`` have
passed. ``msamples_s`` is the film's total weight at the window's end,
less its total at the start, over the window's wall seconds."""

from __future__ import annotations

import time


def film_weight(r) -> float:
    """The samples the film holds (its weights' sum), after a sync."""
    return float(r.wavefront_film().weight.double().sum())


def run(s):
    r, p = s.r, s.params
    r.init_wavefront()
    r.render_wavefront(p["warm_segments"])
    s.setup_done()
    w0 = film_weight(r)
    st0 = r.wavefront_stats()
    seg0 = s.probe.segments
    s.sync()
    t0 = time.perf_counter()
    chunks = []
    while time.perf_counter() - t0 < s.seconds:
        t = time.perf_counter()
        r.render_wavefront(p["chunk_segments"])
        chunks.append(time.perf_counter() - t)
    elapsed = time.perf_counter() - t0
    w1 = film_weight(r)
    st1 = r.wavefront_stats()
    segments = s.probe.segments - seg0
    rays = sum(getattr(st1, k) - getattr(st0, k)
               for k in ("primary_rays", "extension_rays", "shadow_rays"))
    chunks.sort()
    s.window = dict(seconds=elapsed, segments=segments, rays=rays,
                    samples=w1 - w0, lanes=s.cfg["wfBufferSize"],
                    chunk_s_quartiles=[round(chunks[len(chunks) * q // 4], 5)
                                       for q in (0, 1, 2, 3)]
                    + [round(chunks[-1], 5)])
    s.e2e["msamples_s"] = (w1 - w0) / elapsed / 1e6
    s.attempted, s.failed = segments, 0
    if s.trace:
        s.trace_begin()
        r.render_wavefront(p["trace_segments"])
        s.trace_end()


def numbers(s, ref, control=None):
    from benchmark.bm.capture import Segment
    from benchmark.reference import checks
    out = s.segment_numbers(Segment(s.probe.last, ref.params()), ref,
                            control)
    if control is None:
        f = s.r.wavefront_film()
        film = checks_film(f)
        out["film_bad"] = checks.film_bad(film)
    return out


def checks_film(f):
    import torch
    return torch.stack([f.color[0], f.color[1], f.color[2], f.weight])
