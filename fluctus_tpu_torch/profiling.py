"""Kernel-level profiling (the reference package's profiling.py; the
original renderer's CL event profiling, CLContext::checkTracingPerf,
clcontext.cpp:691-719), on torch.profiler's CUDA activity (CUPTI), and the
program's own spans.

``span(name)`` marks a layer of the program (``flt::<layer>[.<part>]``:
a segment, its trace and shade phases and their parts, an interactive
refresh and its frame write) on the profiler's clock, so a device trace
puts every launch, sync and idle gap under the span that was running. It
records only while a profiler does: the benchmark's traced window,
``print_profile``, or a caller's own ``torch.profiler``.

``profile_device_ops`` runs a callable under the profiler and reports the
device time of every device operation (kernels, copies, fills),
aggregated by name. Off a GPU, with no device events, it returns ``[]``,
as the reference does without its TPU trace. ``print_profile`` prints
that and a second table by span.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Callable, List, Tuple

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

SPAN_PREFIX = "flt::"
# CUDA runtime and driver calls that put work on a stream: launches,
# copies and fills
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                   "cuMemcpy", "cuMemset")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span ``name`` while a profiler is recording;
    otherwise one shared no-op context. Off, its cost is that one check:
    no device operation, no sync."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def _run_profiled(fn: Callable[[], None], trace_dir: str = None):
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return prof


def is_device_op(e) -> bool:
    """Whether a ``key_averages()`` row is a device operation (a kernel,
    copy or fill) with device time, and not the device-side range of an
    ``flt::`` span, which would count its operations twice."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and (getattr(e, "self_device_time_total", 0) or 0) > 0
            and not e.key.startswith(SPAN_PREFIX))


def _device_rows(prof, top: int) -> List[Tuple[str, float, int]]:
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if is_device_op(e)]
    return sorted(rows, key=lambda r: -r[1])[:top]


def _span_rows(prof) -> List[Tuple[str, int, float, float, int]]:
    """[(span name, count, host ms, device ms, launches)] of the ``flt::``
    spans in a finished ``torch.profiler.profile``, in order of first
    appearance. Device ms are those of the operations launched inside
    (nested spans' included); launches count the runtime's launch, copy
    and fill calls that began inside."""
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    launch_ts = sorted(e.time_range.start for e in events
                       if e.name.startswith(LAUNCH_PREFIXES))
    rows = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if not e.name.startswith(SPAN_PREFIX):
            continue
        r = rows.setdefault(e.name, [0, 0.0, 0.0, 0])
        t0, t1 = e.time_range.start, e.time_range.end
        r[0] += 1
        r[1] += (t1 - t0) / 1e3
        r[2] += getattr(e, "device_time_total", 0) / 1e3
        r[3] += (bisect.bisect_right(launch_ts, t1)
                 - bisect.bisect_left(launch_ts, t0))
    return [(k, *v) for k, v in rows.items()]


def profile_device_ops(fn: Callable[[], None], trace_dir: str = None,
                       top: int = 25) -> List[Tuple[str, float, int]]:
    """Run fn() under torch.profiler; return [(op_name, total_ms, count)]
    of the device operations, sorted by device time. With ``trace_dir``
    the Chrome trace is written there as well."""
    return _device_rows(_run_profiled(fn, trace_dir), top)


def print_profile(fn: Callable[[], None], top: int = 25):
    """checkTracingPerf-style console report: device time by operation,
    then by ``flt::`` span (count, host ms, device ms and launches; the
    last two ``-`` without a CUDA device). Returns the first table's
    rows."""
    prof = _run_profiled(fn)
    rows = _device_rows(prof, top)
    print(f"{'ms total':>10} {'count':>6}  op")
    for name, ms, c in rows:
        print(f"{ms:10.2f} {c:6d}  {name[:100]}")
    cuda = torch.cuda.is_available()
    print(f"{'count':>6} {'host ms':>10} {'device ms':>10} {'launches':>9}"
          f"  span")
    for name, c, host, dev, launches in _span_rows(prof):
        dev_s = f"{dev:10.2f}" if cuda else f"{'-':>10}"
        launch_s = f"{launches:9d}" if cuda else f"{'-':>9}"
        print(f"{c:6d} {host:10.2f} {dev_s} {launch_s}  {name}")
    return rows
