"""Mrays/s of the free-running wavefront: the renderer's ray counters
(primary, extension and shadow rays) over the window's wall seconds."""


def read(s):
    w = s.window
    if not w.get("seconds") or "rays" not in w:
        return None
    return w["rays"] / w["seconds"] / 1e6
