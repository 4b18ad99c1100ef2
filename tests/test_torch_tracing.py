"""The port's spans (``profiling.span``) and the wavefront's running
counters, on the CPU at tiny sizes:

  span off            no profiler: the one shared no-op, and a render and a
                      frame write never enter ``record_function``
  segment spans       under ``torch.profiler``, ``render_wavefront(2)``
                      records two ``flt::segment``, each holding one trace
                      (sort, closest, any-hit, unsort) and one shade
                      (resolve, logic with its sections in order; features
                      only with the denoiser), nested by time in the
                      exported Chrome trace
  refresh spans       one interactive move: ``flt::refresh`` holding
                      restart, render, preview and ``flt::frame`` with its
                      tonemap, copy, host and encode parts
  profiler neutral    films and counters bit-equal with and without it
  counters            the running total after N segments is the sum of the
                      N segments' counters, free-running and exact-spp"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch import profiling
from fluctus_tpu_torch import renderer as R
from fluctus_tpu_torch.interactive import run_interactive
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUXBALL = os.path.join(ROOT, "data", "luxball", "luxball.obj")
LOGIC = ("terminate", "env", "light", "nee", "splat", "surface",
         "material", "features", "raygen")


def make_renderer(tmp_path, denoiser=False):
    s = Settings()
    s.wf_buffer_size = 1024
    s.use_denoiser = denoiser
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path / "data"),
                 device="cpu")
    r.load_scene(LUXBALL)
    return r


def recorded_spans(prof, tmp_path):
    """[(name, start us, end us)] of the flt:: spans in the exported
    Chrome trace, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith("flt::")]
    return sorted(out, key=lambda s: s[1])


def inside(spans, outer, name):
    return [s for s in spans if s[0] == name and outer[1] <= s[1]
            and s[2] <= outer[2]]


def one(spans, outer, name):
    got = inside(spans, outer, name)
    assert len(got) == 1, (name, len(got))
    return got[0]


def test_span_off_is_the_shared_no_op(tmp_path, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(profiling, "record_function", entered)
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("flt::a")
    assert off is profiling.span("flt::b")
    with off:
        pass
    r = make_renderer(tmp_path)
    r.init_wavefront()
    r.render_wavefront(2)
    r.save_image(str(tmp_path / "frame.png"))
    assert (tmp_path / "frame.png").stat().st_size > 0


@pytest.mark.parametrize("denoiser", [False, True])
def test_segment_spans_nest(tmp_path, denoiser):
    r = make_renderer(tmp_path, denoiser)
    r.init_wavefront()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_wavefront(2)
    spans = recorded_spans(prof, tmp_path)
    segments = [s for s in spans if s[0] == "flt::segment"]
    assert len(segments) == 2
    for seg in segments:
        trace = one(spans, seg, "flt::trace")
        for part in ("sort", "closest", "anyhit", "unsort"):
            one(spans, trace, f"flt::trace.{part}")
        shade = one(spans, seg, "flt::shade")
        assert trace[2] <= shade[1]
        one(spans, shade, "flt::shade.resolve")
        logic = one(spans, shade, "flt::shade.logic")
        starts = []
        for part in LOGIC:
            got = inside(spans, logic, f"flt::shade.logic.{part}")
            if part == "features" and not denoiser:
                assert got == []
                continue
            assert len(got) == 1, part
            starts.append(got[0][1])
        assert starts == sorted(starts)
    # every span of the render lies inside a segment
    assert all(any(g[1] <= s[1] and s[2] <= g[2] for g in segments)
               for s in spans)


@pytest.mark.parametrize("preview", [1, 0])
def test_refresh_spans(tmp_path, preview):
    r = make_renderer(tmp_path)
    r.init_wavefront()
    out = str(tmp_path / "frame.png")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_interactive(r, out_path=out, echo=False, input_stream=iter(
            [f"preview {preview}", "spp 2", "w", "q"]))
    assert os.path.getsize(out) > 0
    spans = recorded_spans(prof, tmp_path)
    refreshes = [s for s in spans if s[0] == "flt::refresh"]
    assert len(refreshes) == 1
    ref = refreshes[0]
    for part in ("restart", "render", "preview"):
        one(spans, ref, f"flt::refresh.{part}")
    frame = one(spans, ref, "flt::frame")
    parts = [one(spans, frame, f"flt::frame.{p}")
             for p in ("tonemap", "copy", "host", "encode")]
    assert [p[1] for p in parts] == sorted(p[1] for p in parts)
    assert len(inside(spans, ref, "flt::segment")) == 2


def test_profiler_leaves_films_and_counters_alone(tmp_path):
    r = make_renderer(tmp_path)
    runs = []
    for traced in (False, True):
        r.init_wavefront()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                r.render_wavefront(3)
        else:
            r.render_wavefront(3)
        f = r.wavefront_film()
        runs.append((f.weight, *f.color, r._wf_state.pool.seed,
                     r.wavefront_stats()))
    (*plain, st0), (*traced, st1) = runs
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert st0 == st1 and st0.samples > 0


@pytest.mark.parametrize("route", ["free", "exact"])
def test_counter_total_is_the_sum_of_segments(tmp_path, monkeypatch,
                                              route):
    r = make_renderer(tmp_path)
    seen = []

    def recording(name):
        f = getattr(R, name)

        def wrapped(*a, **k):
            state, c = f(*a, **k)
            seen.append([int(x) for x in c])
            return state, c
        monkeypatch.setattr(R, name, wrapped)

    if route == "free":
        recording("wf_shade_phase")
        r.init_wavefront()
        r.render_wavefront(2)
        r.render_wavefront(3)
        assert r._wf_segments == len(seen) == 5
    else:
        recording("wf_segment")
        r.render_single(1)
        assert r._wf_segments == len(seen) and len(seen) % 16 == 0
    total = [sum(col) for col in zip(*seen)]
    assert list(r.wavefront_stats()) == total
    assert r._wf_total.dtype == torch.int64 and r._wf_total.shape == (4,)
