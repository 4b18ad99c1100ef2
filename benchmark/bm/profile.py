"""The traced sub-window: a callable run under ``torch.profiler`` (CPU and
CUDA activity), its Chrome trace written to a fixed file of the cache
and read back into what the per-layer metrics need:

- ``busy_s`` / ``window_s``: the union of the device operations'
  intervals (kernels, copies, fills) inside the ``bm::window`` span, and
  that span's length;
- ``span_ms(name)``: the device time of the operations launched inside
  each ``bm::<layer>`` span (a device operation belongs to the span that
  held the host thread when its launch call ran, matched by the
  launch's correlation id), and ``span_count(name)``;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: the device's idle time inside the window by what the
  host was doing when each gap began (the innermost host operation or
  span then running), largest first.

The arithmetic is the benchmark's own: the program's ``profiling.py``
sums device time by name the same way, and a later change to it does not
move these numbers."""

from __future__ import annotations

import bisect
import heapq
import json
import os
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class TraceSummary:
    def __init__(self, events, window_name="bm::window"):
        win = [e for e in events if e.get("name") == window_name
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        launch_ts = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launch_ts[e["args"]["correlation"]] = float(e["ts"])
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("bm::")
                 and e.get("name") != window_name]
        spans.sort(key=lambda e: float(e["ts"]))
        starts = [float(e["ts"]) for e in spans]
        self._span_us = defaultdict(float)
        self._span_n = defaultdict(int)
        for e in spans:
            self._span_n[e["name"]] += 1
        ops = defaultdict(float)
        ivals = []
        for e in dev:
            t0, d = float(e["ts"]), float(e.get("dur", 0.0))
            a, b = max(t0, w0), min(t0 + d, w1)
            if b <= a:
                continue
            ivals.append((a, b))
            ops[str(e.get("name", "?"))[:160]] += (b - a) / 1e6
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is None:
                continue
            # the layer spans follow one another: the last one begun before
            # the launch holds it, unless it has ended
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and float(spans[k]["ts"]) + float(spans[k]["dur"]) >= ts:
                self._span_us[spans[k]["name"]] += b - a
        merged = []
        for a, b in sorted(ivals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e.get("ph") == "X" and e.get("name") != window_name]
        host.sort(key=lambda e: float(e["ts"]))
        by_host = defaultdict(float)
        # sweep the gaps in time order: the host events begun by a gap's
        # start wait in a heap by duration; once the ended ones are off
        # its top, the top is the innermost event running at that start
        active, k = [], 0
        for a, b in gaps:
            while k < len(host) and float(host[k]["ts"]) <= a:
                e = host[k]
                heapq.heappush(active, (float(e["dur"]),
                                        float(e["ts"]) + float(e["dur"]),
                                        k))
                k += 1
            while active and active[0][1] < a:
                heapq.heappop(active)
            best = host[active[0][2]] if active else None
            name = str(best["name"])[:160] if best else "host (no op)"
            by_host[name] += (b - a) / 1e6
        self.idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])

    def span_ms(self, name):
        return self._span_us.get(name, 0.0) / 1e3

    def span_count(self, name):
        return self._span_n.get(name, 0)

    def breakdown(self, top=10):
        return dict(device_ops=[[k, v] for k, v in self.device_ops[:top]],
                    idle_gaps=[[k, v] for k, v in self.idle_gaps[:top]])


def start(cuda: bool):
    """Start the profiler (CPU and, with ``cuda``, CUDA activity) through
    its low-level entry points, whose stop hands back the raw trace
    without building Python objects for every event, as
    ``torch.profiler``'s own stop does. A failure to start fails the
    traced run."""
    import torch
    from torch.autograd import profiler as ap
    p = ap.profile(use_device="cuda" if cuda else None, use_kineto=True)
    cfg = p.config(create_trace_id=False)
    torch.autograd._prepare_profiler(cfg, p.kineto_activities)
    torch.autograd._enable_profiler(cfg, p.kineto_activities)


def stop_and_read(trace_file):
    """Stop the profiler, write its Chrome trace to ``trace_file`` (a
    fixed file of the cache, overwritten by every traced run) and read
    it."""
    import torch
    os.makedirs(os.path.dirname(trace_file), exist_ok=True)
    t0 = time.perf_counter()
    torch.autograd._disable_profiler().save(trace_file)
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    summary = TraceSummary(events)
    summary.read_s = time.perf_counter() - t0
    return summary
