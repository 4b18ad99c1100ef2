"""Kernel-level profiling (the reference package's profiling.py; the
original renderer's CL event profiling, CLContext::checkTracingPerf,
clcontext.cpp:691-719), on torch.profiler's CUDA activity (CUPTI).

Runs a callable under the profiler and reports the device time of every
device operation (kernels, copies, fills), aggregated by name. Off a GPU,
with no device events, it returns ``[]``, as the reference does without
its TPU trace.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def profile_device_ops(fn: Callable[[], None], trace_dir: str = None,
                       top: int = 25) -> List[Tuple[str, float, int]]:
    """Run fn() under torch.profiler; return [(op_name, total_ms, count)]
    of the device operations, sorted by device time. With ``trace_dir``
    the Chrome trace is written there as well."""
    import os

    import torch
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

    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    return sorted(rows, key=lambda r: -r[1])[:top]


def print_profile(fn: Callable[[], None], top: int = 25):
    """checkTracingPerf-style console report."""
    rows = profile_device_ops(fn, top=top)
    print(f"{'ms total':>10} {'count':>6}  op")
    for name, ms, c in rows:
        print(f"{ms:10.2f} {c:6d}  {name[:100]}")
    return rows
