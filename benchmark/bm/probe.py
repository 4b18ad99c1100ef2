"""The benchmark's hooks into the program, installed at run time around
the functions where the renderer looks them up (its module globals), so
that no file of the program changes:

- ``wf_trace_phase`` and ``wf_shade_phase`` (both in the renderer's and in
  the integrator's namespace) are wrapped in ``bm::trace`` / ``bm::shade``
  profiler spans while ``spans`` is on (the traced sub-window only);
- ``wf_shade_phase``, ``wf_resolve_phase`` and the film's block splat
  keep references to the last segment's inputs and outputs (no copy), for
  the reference to follow that segment after the window;
- ``wf_reset`` salts every new pool's per-lane seeds with the run's seed;
- the renderer's ``save_image`` is timed (the interactive frame write).

Where a later version of the program renames one of these functions the
hook is missing: its metric reads nothing and the capture stays empty, so
``correct`` comes out false until a benchmark change points it at what
took its place."""

from __future__ import annotations

import contextlib
import time

import torch

MASK32 = 0xFFFFFFFF


def salt32(seed: int) -> int:
    """A 32-bit salt from a run's seed (any whole number), never 0."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % (1 << 64)
    return ((x >> 32) ^ (x & MASK32)) or 1


def burtle(seed: torch.Tensor) -> torch.Tensor:
    """Bob Jenkins' integer hash on int64 tensors holding uint32."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    return seed ^ (seed >> 15)


class Probe:
    def __init__(self, seed: int):
        self.salt = salt32(seed)
        self.spans = False         # profiler spans on (traced sub-window)
        self.segments = 0          # segments since install
        self.last = None           # the captured segment, a dict
        self.frame_s = 0.0         # host seconds in save_image
        self.frames = 0
        self.missing = []          # hooks the program no longer offers
        self._cur = None

    def span(self, name):
        if self.spans:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # -- installation ---------------------------------------------------------
    def install(self, renderer):
        from fluctus_tpu_torch import renderer as R
        from fluctus_tpu_torch.core import block_splat as BS
        from fluctus_tpu_torch.core import integrator_wf as W

        def hook(mod, name, make):
            f = getattr(mod, name, None)
            if f is None:
                self.missing.append(f"{mod.__name__}.{name}")
                return
            setattr(mod, name, make(f))

        for mod in (W, R):
            hook(mod, "wf_trace_phase", self._trace)
            hook(mod, "wf_shade_phase", self._shade)
        hook(W, "wf_resolve_phase", self._resolve)
        hook(BS, "splat", self._splat)
        hook(R, "wf_reset", self._reset)
        f = getattr(renderer, "save_image", None)
        if f is None:
            self.missing.append("Renderer.save_image")
        else:
            renderer.save_image = self._frame(f)

    def _trace(self, f):
        def wf_trace_phase(*a, **k):
            with self.span("bm::trace"):
                return f(*a, **k)
        return wf_trace_phase

    def _shade(self, f):
        def wf_shade_phase(scene, params, state, config, raw, occluded,
                           *rest, **kw):
            cur = {}
            self._cur = cur
            try:
                with self.span("bm::shade"):
                    out = f(scene, params, state, config, raw, occluded,
                            *rest, **kw)
            finally:
                self._cur = None
            self.segments += 1
            cur.update(state_in=state, occluded=occluded, config=config,
                       params=params, state_out=out[0])
            self.last = cur
            return out
        return wf_shade_phase

    def _resolve(self, f):
        def wf_resolve_phase(*a, **k):
            out = f(*a, **k)
            if self._cur is not None and "hit" not in self._cur:
                self._cur["hit"] = out[0]
            return out
        return wf_resolve_phase

    def _splat(self, f):
        def splat(local, data, film, groups, remaining=None):
            if self._cur is not None and "splat" not in self._cur:
                self._cur["splat"] = dict(local=local, data=data,
                                          groups=groups)
            return f(local, data, film, groups=groups, remaining=remaining)
        return splat

    def _reset(self, f):
        salt = self.salt

        def wf_reset(*a, **k):
            st = f(*a, **k)
            pool = st.pool
            return st._replace(pool=pool._replace(
                seed=burtle(pool.seed ^ salt)))
        return wf_reset

    def _frame(self, f):
        def save_image(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                self.frame_s += time.perf_counter() - t0
                self.frames += 1
        return save_image
