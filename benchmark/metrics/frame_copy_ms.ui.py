"""Host ms a frame write spends in its device-to-host copy (the program's
``flt::frame.copy`` span, which includes the wait for the work queued
before it), over the count of ``flt::frame`` (``bm/spans.py``), traced
run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::frame.copy", "host_us", per="flt::frame",
                     cuda_only=False)
    return None if us is None else us / 1e3
