"""Host ms a segment: the length of the program's ``flt::segment`` spans
over their count (``bm/spans.py``), traced run. The host enqueues a
segment's work in this time; where it exceeds the device's, the device
waits."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::segment", "host_us", cuda_only=False)
    return None if us is None else us / 1e3
