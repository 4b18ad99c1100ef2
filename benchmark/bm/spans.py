"""The program's own spans in the traced run's Chrome trace: every
``flt::<layer>[.<part>]`` span that ``fluctus_tpu_torch.profiling.span``
records while the profiler runs (a segment, its trace and shade phases and
their parts, an interactive refresh and its frame write). For each span
name, summed over its instances:

- ``count`` and ``host_us`` (the instances' lengths);
- ``launches``: CUDA runtime and driver calls that put work on a stream
  (launches, copies, fills) begun inside an instance;
- ``syncs``: blocking calls begun inside (a stream, device or event
  synchronise, or a synchronous ``cudaMemcpy``);
- ``device_us``: the device time of the operations launched inside,
  matched to their launch call by correlation id and clipped to the
  ``bm::window`` span, as ``profile.py`` does;
- ``idle_us``: the device's idle gaps inside the window (between the
  union of its operations' intervals) whose start lies inside an
  instance, each gap whole.

A call or gap inside a nested span counts for every enclosing span too.
Spans of one name do not nest in the program, so each counts once.

The trace file is the one ``profile.stop_and_read`` wrote; it is read once
a session (``read``), and only after a traced run. A program without these
spans yields an empty summary: its metrics read nothing."""

from __future__ import annotations

import bisect
import json
import os
from types import SimpleNamespace

from . import harness
from .profile import DEVICE_CATS, LAUNCH_CATS

PREFIX = "flt::"
ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
           "cuMemset")
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy",
                      "cuStreamSynchronize", "cuCtxSynchronize",
                      "cuEventSynchronize"})


class _Marks:
    """Sorted times with a weight each: the count and the weight's sum of
    those in [t0, t1]."""

    def __init__(self, pairs):
        pairs = sorted(pairs)
        self.t = [t for t, _ in pairs]
        self.cum = [0.0]
        for _, w in pairs:
            self.cum.append(self.cum[-1] + w)

    def within(self, t0, t1):
        lo = bisect.bisect_left(self.t, t0)
        hi = bisect.bisect_right(self.t, t1)
        return hi - lo, self.cum[hi] - self.cum[lo]


class SpanSummary:
    def __init__(self, events, window_name="bm::window"):
        runtime = [e for e in events if e.get("cat") in LAUNCH_CATS
                   and e.get("ph") == "X"]
        # CUDA runtime events exist only on a CUDA device
        self.cuda = bool(runtime)
        launch_ts = {e["args"]["correlation"]: float(e["ts"])
                     for e in runtime if "correlation" in e.get("args", {})}
        win = [e for e in events if e.get("name") == window_name
               and e.get("cat") == "user_annotation"]
        w0 = float(win[0]["ts"]) if win else float("-inf")
        w1 = w0 + float(win[0]["dur"]) if win else float("inf")
        enqueue = _Marks((float(e["ts"]), 1.0) for e in runtime
                         if str(e.get("name", "")).startswith(ENQUEUE))
        blocking = _Marks((float(e["ts"]), 1.0) for e in runtime
                          if e.get("name") in BLOCKING)
        launched, ivals = [], []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            t0 = float(e["ts"])
            a, b = max(t0, w0), min(t0 + float(e.get("dur", 0.0)), w1)
            if b <= a:
                continue
            ivals.append((a, b))
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is not None:
                launched.append((ts, b - a))
        device = _Marks(launched)
        # the window's idle gaps, each at its start (without a window, only
        # those between device operations)
        ivals.sort()
        gaps = []
        end = w0 if win else (ivals[0][0] if ivals else 0.0)
        for a, b in ivals:
            if a > end:
                gaps.append((end, a - end))
            end = max(end, b)
        if win and w1 > end:
            gaps.append((end, w1 - end))
        idle = _Marks(gaps)
        self.stats = {}
        for e in events:
            name = str(e.get("name", ""))
            if e.get("cat") != "user_annotation" or not name.startswith(
                    PREFIX):
                continue
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            s = self.stats.setdefault(name, SimpleNamespace(
                count=0, host_us=0.0, launches=0, syncs=0, device_us=0.0,
                idle_us=0.0))
            s.count += 1
            s.host_us += t1 - t0
            s.launches += enqueue.within(t0, t1)[0]
            s.syncs += blocking.within(t0, t1)[0]
            s.device_us += device.within(t0, t1)[1]
            s.idle_us += idle.within(t0, t1)[1]

    def get(self, name):
        """The sums of span ``name``, or None where it was not recorded."""
        return self.stats.get(name)


def summary_of(path):
    with open(path) as f:
        return SpanSummary(json.load(f)["traceEvents"])


def read(s):
    """The session's span summary (read once, kept on the session), or
    None where the run made no trace or its file cannot be read."""
    if getattr(s, "summary", None) is None:
        return None
    if not hasattr(s, "flt_spans"):
        try:
            s.flt_spans = summary_of(os.path.join(harness.CACHE, "trace",
                                                  "trace.json"))
        except (OSError, ValueError, KeyError):
            s.flt_spans = None
    return s.flt_spans


def ratio(s, name, field, per="flt::segment", cuda_only=True):
    """``field`` of span ``name`` over the count of span ``per``, or None
    where either span is absent (or, with ``cuda_only``, off a CUDA
    device: a CPU run has no launches, syncs or device gaps to count)."""
    t = read(s)
    if t is None or (cuda_only and not t.cuda):
        return None
    span, base = t.get(name), t.get(per)
    if span is None or base is None:
        return None
    return getattr(span, field) / base.count
