"""The trace phase's share of its roofline, in %: the least time the
phase could take (the bytes it has to move, counted by the benchmark's
frozen ``trace_phase_bytes`` from the pool size and the scene's
triangles, over the card's memory bandwidth) over its device ms a
segment."""

from benchmark.bm import roofline


def read(s):
    t = s.summary
    n = t.span_count("bm::trace") if t else 0
    if not n or t.busy_s <= 0:
        return None
    ms = t.span_ms("bm::trace") / n
    if ms <= 0:
        return None
    nbytes = roofline.trace_phase_bytes(s.cfg["wfBufferSize"],
                                        s.cfg["triangles"])
    return 100.0 * roofline.least_seconds(nbytes) * 1e3 / ms
