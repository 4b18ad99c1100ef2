"""Blocking calls a segment (stream, device or event synchronise, or a
synchronous copy) that the host made inside the program's
``flt::segment`` spans, over their count (``bm/spans.py``), traced run."""

from benchmark.bm import spans


def read(s):
    return spans.ratio(s, "flt::segment", "syncs")
