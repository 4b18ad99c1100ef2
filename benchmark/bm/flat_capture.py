"""The exact-spp job's capture on the flat pixel ring, beside
``probe.Probe``'s and ``job_probe.JobProbe``'s hooks (no file of the
program changes, and neither of theirs):

- ``pixel_ring.scatter_pixels``, the flat ring's film scatter: the first
  call of a captured segment with [n, 4] records (the film's, before the
  spp scatter and any feature scatter) keeps, by reference, each lane's
  record and the index the program scattered it to (its pixel where it
  was admitted, else the overflow bucket ``num_pixels``);
- ``FlatSegment``: that capture as the reference reads it
  (``reference.flat_exact``): the pool, hit records and shadow results,
  the film, the count table and the cursor before and after, in true
  pixel order.

``JobProbe`` keeps a job's segment (the second of its last round of
16); a hook the program no longer offers is named in ``Probe.missing``,
which makes the run not correct."""

from __future__ import annotations

import torch

from .job_probe import JobProbe


class FlatJobProbe(JobProbe):
    """``JobProbe`` with the flat ring's film scatter kept too."""

    def install(self):
        super().install()
        from fluctus_tpu_torch.core import pixel_ring as PR
        f = getattr(PR, "scatter_pixels", None)
        if f is None:
            self.probe.missing.append(f"{PR.__name__}.scatter_pixels")
        else:
            PR.scatter_pixels = self._scatter(f)

    def _scatter(self, f):
        probe = self.probe

        def scatter_pixels(seg, data, num_pixels):
            cur = probe._cur
            if cur is not None and "flat_splat" not in cur \
                    and data.ndim == 2 and data.shape[1] == 4:
                cur["flat_splat"] = dict(index=seg, data=data)
            return f(seg, data, num_pixels)
        return scatter_pixels


class FlatSegment:
    def __init__(self, cap: dict, ref_params):
        st0, st1 = cap["state_in"], cap["state_out"]
        config = cap["config"]
        if config.block_ring:
            raise ValueError("the flat capture reads the flat pixel ring "
                             "only")
        if "flat_splat" not in cap:
            raise KeyError("no flat film scatter was kept")
        self.pool0, self.pool1 = st0.pool, st1.pool
        self.hit = cap["hit"]
        self.occluded = cap["occluded"]
        stack = lambda f: torch.stack([f.color[0], f.color[1], f.color[2],
                                       f.weight])
        self.film0, self.film1 = stack(st0.film), stack(st1.film)
        self.spp0, self.spp1 = st0.spp, st1.spp
        self.cursor0, self.cursor1 = st0.curr_pixel, st1.curr_pixel
        rec = cap["flat_splat"]
        self.splat_index = rec["index"]
        self.splat_data = rec["data"].T
        self.npx = config.width * config.height
        if self.film0.shape[1] != self.npx:
            raise ValueError(f"the film holds {self.film0.shape[1]} pixels, "
                             f"not {self.npx}")
        self.n = self.pool0.seed.shape[0]
        self.ref_params = ref_params

    def pixel_ok(self, idx):
        """Whether each lane's pixel after the segment is sound: unchanged
        on a path that goes on, and a true pixel on a path that ended
        (``reference.flat_exact.ring_bad`` holds it to the ring's order)."""
        q = self.pool1.pixel_index[idx].long()
        ended = self.pool1.path_len[idx] == 0
        same = q == self.pool0.pixel_index[idx].long()
        return torch.where(ended, (q >= 0) & (q < self.npx), same)
