"""Host ms a frame write spends encoding its PNG (the program's
``flt::frame.encode`` span: quantisation, zlib and the file write), over
the count of ``flt::frame`` (``bm/spans.py``), traced run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::frame.encode", "host_us", per="flt::frame",
                     cuda_only=False)
    return None if us is None else us / 1e3
