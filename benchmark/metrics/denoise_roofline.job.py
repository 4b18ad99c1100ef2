"""The denoise's share of its roofline, in %: the least time the filter
could take (the larger of its least bytes over the card's memory
bandwidth and its least float32 operations over the card's peak, both
counted by ``bm/denoise_work.py`` from the frame's size and the cell's
pass count) over its device ms a denoise (as ``denoise_ms.job``: the
operations launched inside ``flt::denoise``), traced run."""

from benchmark.bm import denoise_work, roofline, spans


def read(s):
    us = spans.ratio(s, "flt::denoise", "device_us", per="flt::denoise")
    if us is None or us <= 0:
        return None
    w, h = s.cfg["width"], s.cfg["height"]
    least = roofline.least_seconds(
        denoise_work.denoise_bytes(w, h),
        denoise_work.denoise_ops(w, h, s.params["denoise"]["iterations"]))
    return 100.0 * least * 1e6 / us
