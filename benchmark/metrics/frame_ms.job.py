"""Host ms a job spends writing its frame: the program's ``flt::frame``
spans in ``save_denoised`` (the tonemap, the copy to the host and the
PNG's encode, after the denoise) over its ``flt::job`` spans
(``bm/spans.py``), traced run."""

from benchmark.bm import spans


def read(s):
    us = spans.ratio(s, "flt::frame", "host_us", per="flt::job",
                     cuda_only=False)
    return None if us is None else us / 1e3
