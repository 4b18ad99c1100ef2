"""Device idle ms a segment whose gap begins while the host is inside the
program's ``flt::trace`` spans (the sort, the two traces and the unsort),
over the count of ``flt::segment`` (``bm/spans.py``), traced run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::trace", "idle_us")
    return None if us is None else us / 1e3
