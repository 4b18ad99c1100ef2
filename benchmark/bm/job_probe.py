"""The exact-spp job's hooks into the program, installed at run time
beside ``probe.Probe``'s, as those are (no file of the program changes):

- the film's block splat: an 8-channel call (the denoiser's guide
  features, after the film's own splat) keeps its records in the
  segment that ``Probe`` is capturing;
- the renderer's ``wf_segment``: of a job's segments (counted from
  ``begin``) the capture of the second of every round of 16 is kept, so
  that after the job ``kept`` is its last round's second segment. The
  job reads its least pixel count after every 16 segments and stops once
  every pixel has its target, so the last round begins with pixels still
  short, and its second segment is the last one sure to hold live paths
  beside idle ones; the job's very last segment may hold every lane idle;
- the renderer's ``atrous_denoise``: the last denoised image is kept (by
  reference), for the reference to hold against its own.

A hook the program no longer offers is named in ``Probe.missing``, which
makes the run not correct."""

from __future__ import annotations

ROUND = 16          # segments between the job's checks of the pixel counts


class JobProbe:
    def __init__(self, probe):
        self.probe = probe
        self.count = 0            # segments since the job began
        self.kept = None          # the kept segment's capture
        self.denoised = None      # the last denoised [H, W, 3] image

    def install(self):
        from fluctus_tpu_torch import renderer as R
        from fluctus_tpu_torch.core import block_splat as BS
        for mod, name, make in ((BS, "splat", self._splat),
                                (R, "wf_segment", self._segment),
                                (R, "atrous_denoise", self._denoise)):
            f = getattr(mod, name, None)
            if f is None:
                self.probe.missing.append(f"{mod.__name__}.{name}")
            else:
                setattr(mod, name, make(f))

    def begin(self):
        """A job begins: its segments count from 0."""
        self.count = 0

    def _splat(self, f):
        probe = self.probe

        def splat(local, data, film, groups, remaining=None):
            cur = probe._cur
            if cur is not None and data.shape[0] == 8:
                cur["features"] = dict(local=local, data=data)
            return f(local, data, film, groups=groups, remaining=remaining)
        return splat

    def _segment(self, f):
        def wf_segment(*a, **k):
            out = f(*a, **k)
            if self.count % ROUND == 1:
                self.kept = self.probe.last
            self.count += 1
            return out
        return wf_segment

    def _denoise(self, f):
        def atrous_denoise(*a, **k):
            self.denoised = f(*a, **k)
            return self.denoised
        return atrous_denoise
