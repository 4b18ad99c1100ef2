"""Device ms a segment of the operations launched inside the shade
phase (``bm::shade`` spans around ``wf_shade_phase``: the resolve, the
logic with its lobes, textures and env lookups, and the film splat),
traced run."""


def read(s):
    t = s.summary
    n = t.span_count("bm::shade") if t else 0
    ms = t.span_ms("bm::shade") / n if n else 0.0
    return ms if ms > 0 else None
