"""``bm/spans.py``'s arithmetic on a hand-built Chrome trace, and its
metrics on the program's CPU path.

The hand-built trace (times in us; window [0, 1000]):

  flt::segment  [100, 500]                     [600, 900]
    flt::trace    [110, 250]                     [610, 700]
    flt::shade    [260, 490]                     [710, 890]
      flt::shade.logic [300, 480]
  flt::frame                                              [910, 940]
    flt::frame.copy [912, 925], flt::frame.encode [930, 938]

  runtime calls: launch 120 (kernel 130-200), launch 310 (kernel 315-400),
  copy 320 (memcpy 400-410), stream sync 330, fill 620 (memset 630-640),
  launch 720 (kernel 725-800), event record 730, launch 950 (kernel
  955-1010, clipped to 1000), device sync 960

  idle gaps: 0-130 (no span), 200-315 (trace), 410-630 (logic, so shade
  and segment too), 640-725 (trace), 800-955 (shade)"""

from types import SimpleNamespace

import pytest
import torch

from benchmark.bm import harness, spans

import tiny

torch.set_num_threads(1)


def X(cat, name, ts, dur, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=1)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def annotations():
    ua = "user_annotation"
    return [X(ua, "bm::window", 0, 1000),
            X(ua, "flt::segment", 100, 400), X(ua, "flt::segment", 600, 300),
            X(ua, "flt::trace", 110, 140), X(ua, "flt::trace", 610, 90),
            X(ua, "flt::shade", 260, 230), X(ua, "flt::shade", 710, 180),
            X(ua, "flt::shade.logic", 300, 180),
            X(ua, "flt::frame", 910, 30), X(ua, "flt::frame.copy", 912, 13),
            X(ua, "flt::frame.encode", 930, 8),
            # the device side's copy of a span is not the host's
            X("gpu_user_annotation", "flt::segment", 130, 700)]


def device_events():
    rt = "cuda_runtime"
    return [X(rt, "cudaLaunchKernel", 120, 3, 1),
            X(rt, "cudaLaunchKernel", 310, 3, 2),
            X(rt, "cudaMemcpyAsync", 320, 3, 3),
            X(rt, "cudaStreamSynchronize", 330, 80),
            X(rt, "cudaMemsetAsync", 620, 3, 4),
            X(rt, "cudaLaunchKernel", 720, 3, 5),
            X(rt, "cudaEventRecord", 730, 1),
            X(rt, "cudaLaunchKernel", 950, 3, 6),
            X(rt, "cudaDeviceSynchronize", 960, 45),
            X("kernel", "k1", 130, 70, 1), X("kernel", "k2", 315, 85, 2),
            X("gpu_memcpy", "Memcpy DtoH", 400, 10, 3),
            X("gpu_memset", "Memset", 630, 10, 4),
            X("kernel", "k5", 725, 75, 5), X("kernel", "k6", 955, 55, 6)]


def session(events):
    return SimpleNamespace(summary=object(),
                           flt_spans=spans.SpanSummary(events))


def test_sums_by_span():
    t = spans.SpanSummary(annotations() + device_events())
    assert t.cuda
    want = {  # count, host, launches, syncs, device, idle
        "flt::segment": (2, 700, 5, 1, 250, 575),
        "flt::trace": (2, 230, 2, 0, 80, 200),
        "flt::shade": (2, 410, 3, 1, 170, 375),
        "flt::shade.logic": (1, 180, 2, 1, 95, 220),
        "flt::frame": (1, 30, 0, 0, 0, 0),
        "flt::frame.copy": (1, 13, 0, 0, 0, 0),
    }
    for name, w in want.items():
        s = t.get(name)
        got = (s.count, s.host_us, s.launches, s.syncs, s.device_us,
               s.idle_us)
        assert got == pytest.approx(w), name
    assert t.get("flt::refresh") is None


METRICS = {"launches.wf": 5 / 2, "syncs.wf": 1 / 2, "dispatch_ms.wf": 0.35,
           "shade_idle_ms.wf": 0.1875, "trace_idle_ms.wf": 0.1,
           "frame_copy_ms.ui": 0.013, "frame_encode_ms.ui": 0.008}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_reads_its_span(name):
    s = session(annotations() + device_events())
    v = harness.load_module("metrics", name).read(s)
    assert v == pytest.approx(METRICS[name])


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_without_the_program_spans_reads_nothing(name):
    events = [e for e in annotations() + device_events()
              if not e["name"].startswith("flt::")]
    assert harness.load_module("metrics", name).read(session(events)) \
        is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_off_the_card(name):
    """A CPU trace has no runtime calls or device operations: counts of
    launches, syncs and idle time read nothing there, never 0; host
    times read."""
    s = session(annotations())
    v = harness.load_module("metrics", name).read(s)
    if name in ("dispatch_ms.wf", "frame_copy_ms.ui", "frame_encode_ms.ui"):
        assert v == pytest.approx(METRICS[name])
    else:
        assert v is None


def test_no_traced_run_reads_nothing():
    assert spans.read(SimpleNamespace(summary=None)) is None


@pytest.mark.parametrize("name,want", [
    ("luxball_prod.wavefront", ["dispatch_ms.wf"]),
    ("luxball_prod.preview", ["frame_copy_ms.ui", "frame_encode_ms.ui"])])
def test_traced_cpu_run_reports_the_program_spans(name, want, tmp_path):
    b = harness.BENCH
    res, lines, _, _ = harness.run_cell(
        name, 3000000011, tiny.SECONDS[name], True, device="cpu",
        scale=tiny.SCALE, params=tiny.PARAMS, cell=tiny.cell(b, name),
        cfg=tiny.config(b, str(tmp_path / "scene")))
    assert res["correct"], lines
    got = res["metrics"]
    for m in want:
        assert got[m]["value"] > 0, m
    for m in ("launches.wf", "syncs.wf", "shade_idle_ms.wf",
              "trace_idle_ms.wf"):
        assert m not in got
