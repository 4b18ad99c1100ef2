"""Device ms a segment of the pixel ring's own work: the device time of
the operations launched inside the program's ``flt::ring.*`` spans (the
cap's spp fetch, its admission, the film, spp and feature scatters, and
the raygen ranks computed outside the surface kernel) over the
``flt::segment`` spans (``bm/spans.py``), traced run. None where the
program has no ring span."""

from benchmark.bm import spans

PARTS = ("fetch", "admit", "scatter", "raygen")


def device_us(s):
    """The ring spans' device us a segment, or None."""
    got = [spans.ratio(s, f"flt::ring.{p}", "device_us") for p in PARTS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None


def read(s):
    us = device_us(s)
    return None if us is None or us <= 0 else us / 1e3
