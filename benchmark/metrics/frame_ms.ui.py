"""Host ms a refresh spends writing its frame (``Renderer.save_image``:
the copy to the host, tonemap, quantisation and the PNG), over the
window's refreshes."""


def read(s):
    return s.window.get("frame_ms") if s.window.get("refreshes") else None
