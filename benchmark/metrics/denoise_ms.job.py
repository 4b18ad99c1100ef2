"""Device ms a denoise: the device time of the operations launched inside
the program's ``flt::denoise`` spans over their count (``bm/spans.py``),
traced run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::denoise", "device_us", per="flt::denoise")
    return None if us is None or us <= 0 else us / 1e3
