"""Segments a job: the program's ``flt::segment`` spans over its
``flt::job`` spans (``bm/spans.py``), traced run. Under the spp cap a
job runs until its slowest pixel has its target, in steps of 16
segments (the least count is read every 16)."""

from benchmark.bm import spans


def read(s):
    return spans.ratio(s, "flt::segment", "count", per="flt::job",
                       cuda_only=False)
