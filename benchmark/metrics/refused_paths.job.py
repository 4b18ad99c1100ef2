"""The share, in %, of the finished paths that tried to splat under the
spp cap whose record the cap's admission refused: refused over admitted
plus refused (``Renderer.capped_stats``' ``refused`` and ``admitted``).
Over the window's jobs where the traffic summed them (``exact_flat``),
else over the run's last job (``exact_job``'s traced job). None where
the program has no such counter."""


def read(s):
    w = s.window
    if "refused_paths" in w:
        refused, admitted = w["refused_paths"], w["admitted_paths"]
    else:
        capped = getattr(s.r, "capped_stats", None)
        c = capped() if capped is not None else None
        refused = getattr(c, "refused", None)
        if refused is None:
            return None
        admitted = c.admitted
    total = refused + admitted
    return 100.0 * refused / total if total else None
