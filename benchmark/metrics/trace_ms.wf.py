"""Device ms a segment of the operations launched inside the trace
phase (``bm::trace`` spans around ``wf_trace_phase``), traced run."""


def read(s):
    t = s.summary
    n = t.span_count("bm::trace") if t else 0
    ms = t.span_ms("bm::trace") / n if n else 0.0
    return ms if ms > 0 else None
