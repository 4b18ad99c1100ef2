"""Device ms a segment of the NCCL kernels in rank 0's traced window
(operations whose name holds ``nccl``), over the window's segments (its
``bm::trace`` spans): the counters' ``all_reduce`` of
``wf_segment_sharded``, with its wait for the slowest rank. Read by
operation name, since the collective lies outside the program's
``flt::segment`` span. None where no such kernel ran (one card, or the
CPU's gloo)."""


def read(s):
    t = s.summary
    n = t.span_count("bm::trace") if t else 0
    if not n:
        return None
    sec = sum(v for k, v in t.device_ops if "nccl" in k.lower())
    return 1e3 * sec / n if sec > 0 else None
