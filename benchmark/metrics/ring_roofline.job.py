"""The flat pixel ring's share of its roofline, in %: the least time its
work could take (``bm/ring_work.py``'s bytes a segment over the card's
memory bandwidth) over ``ring_ms.job``'s device ms a segment, traced run.

The bytes come from the pool's lanes and the traced job's admitted
records a segment (``Renderer.capped_stats``). Its touched pixels are its
admitted records: the traced job's target is 1 spp, so the cap admits at
most one record to a pixel in the whole job. None where the job's target
is another, where the ring is the block ring (its raygen runs inside the
surface kernel, outside the ring spans, and its guide-feature scatter,
inside them, has no count of its records), or where either reading is
missing."""

from benchmark.bm import harness, ring_work, roofline


def read(s):
    us = harness.load_module("metrics", "ring_ms.job").device_us(s)
    capped = getattr(s.r, "capped_stats", None)
    if us is None or us <= 0 or capped is None \
            or getattr(s, "job_spp", None) != 1 \
            or s.cfg["wfBlockRing"]:
        return None
    c = capped()
    if not c.segments:
        return None
    admitted = c.admitted / c.segments
    least = roofline.least_seconds(
        ring_work.segment_bytes(c.lanes, admitted, admitted))
    return 100.0 * least * 1e6 / us
