"""Device idle ms a segment whose gap begins while the host is inside the
program's ``flt::shade`` spans (the resolve and the logic with its lobes,
textures, env lookups and splat), over the count of ``flt::segment``
(``bm/spans.py``), traced run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::shade", "idle_us")
    return None if us is None else us / 1e3
