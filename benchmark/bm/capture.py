"""The captured segment (``Probe.last``) as the reference reads it: the
pool before and after, the hit records, the shadow results, the film
before and after and the splat records, with the block ring's layout (G
groups of S lanes, each bound to a block of Pk padded film pixels of
which P are true pixels) worked out from the film size and the group
count.

A sharded segment (``parallel.mesh.wf_segment_sharded``) holds rank
``rank``'s slice of ``world``: its pool, and its film slice of G/world
whole groups, the ``rank``-th band of the whole film's ``config.groups``
(its first group is its ``pixel_base // Pk``). The band is the one the
harness knows the rank to own, never the offset the program passed: the
reference judges the program's pixels against it."""

from __future__ import annotations

import torch


class Segment:
    def __init__(self, cap: dict, ref_params, rank: int = 0,
                 world: int = 1):
        st0, st1 = cap["state_in"], cap["state_out"]
        config = cap["config"]
        if not config.block_ring:
            raise ValueError("the capture reads the block pixel ring only")
        self.pool0, self.pool1 = st0.pool, st1.pool
        self.hit = cap["hit"]
        self.occluded = cap["occluded"]
        stack = lambda f: torch.stack([f.color[0], f.color[1], f.color[2],
                                       f.weight])
        self.film0, self.film1 = stack(st0.film), stack(st1.film)
        rec = cap["splat"]
        self.splat_local, self.splat_data = rec["local"], rec["data"]
        self.npx = config.width * config.height
        self.p = -(-self.npx // config.groups)
        self.pk = -(-self.p // 128) * 128
        if config.groups % world:
            raise ValueError(f"{config.groups} groups over {world} ranks")
        self.groups = config.groups // world     # groups the slice holds
        self.g0 = rank * self.groups             # its first group
        if self.film0.shape[1] != self.groups * self.pk:
            raise ValueError(f"the film slice holds {self.film0.shape[1]} "
                             f"pixels, not {self.groups} groups of "
                             f"{self.pk}")
        self.n = self.pool0.seed.shape[0]
        self.s = self.n // self.groups
        self.ref_params = ref_params

    def true_pixel(self, q):
        """True pixel of a padded film index."""
        q = q.long()
        return ((q // self.pk) * self.p + q % self.pk).to(torch.int32)

    def pixel_ok(self, idx):
        """Whether each lane's pixel after the segment is sound: unchanged
        on a path that goes on, and in its group's ring (its block, below
        the group's true pixel count) on a path that ended."""
        q = self.pool1.pixel_index[idx].long()
        ended = self.pool1.path_len[idx] == 0
        g = self.g0 + idx.long() // self.s
        local = q - g * self.pk
        len_g = torch.clamp(self.npx - g * self.p, 1, self.p)
        in_ring = (local >= 0) & (local < len_g)
        same = q == self.pool0.pixel_index[idx].long()
        return torch.where(ended, in_ring, same)

    def true_slots(self):
        """Which slots of the film slice hold a true pixel."""
        k = torch.arange(self.film1.shape[1], device=self.film1.device)
        g = self.g0 + k // self.pk
        local = k % self.pk
        return (local < self.p) & (g * self.p + local < self.npx)
