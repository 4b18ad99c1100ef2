"""CUDA launch, copy and fill calls a segment: those the host made inside
the program's ``flt::segment`` spans, over their count (``bm/spans.py``),
traced run."""

from benchmark.bm import spans


def read(s):
    return spans.ratio(s, "flt::segment", "launches")
