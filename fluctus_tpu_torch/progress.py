"""Console progress view (the reference package's progress.py; the
original renderer's nanogui ProgressView, src/progressview.cpp, shown
during scene load and hierarchy builds): a rate-limited single-line
progress display with the same phase/message semantics."""

from __future__ import annotations

import sys
import time


class ProgressView:
    """Rate-limited one-line progress printer.

    >>> pv = ProgressView()
    >>> pv.show("Building BVH", 0.5)
    >>> pv.hide()
    """

    def __init__(self, enabled: bool = True, min_interval: float = 0.1,
                 stream=None):
        self.enabled = enabled
        self.min_interval = min_interval
        self.stream = stream or sys.stderr
        self._last = 0.0
        self._visible = False

    def show(self, message: str, fraction: float = -1.0):
        """Display or update the line (showMessage): ``fraction`` in [0, 1],
        or negative for a phase of unknown length."""
        if not self.enabled:
            return
        now = time.time()
        if now - self._last < self.min_interval and fraction < 1.0:
            return
        self._last = now
        if fraction >= 0.0:
            pct = min(max(fraction, 0.0), 1.0) * 100.0
            bar = "#" * int(pct / 5) + "-" * (20 - int(pct / 5))
            self.stream.write(f"\r{message}: [{bar}] {pct:5.1f}%")
        else:
            self.stream.write(f"\r{message}...")
        self.stream.flush()
        self._visible = True

    def hide(self):
        """Clear the line (hideMessage)."""
        if self._visible:
            self.stream.write("\r" + " " * 79 + "\r")
            self.stream.flush()
            self._visible = False
