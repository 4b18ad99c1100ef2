"""The captured segment (``Probe.last``) as the reference reads it: the
pool before and after, the hit records, the shadow results, the film
before and after and the splat records, with the block ring's layout (G
groups of S lanes, each bound to a block of Pk padded film pixels of
which P are true pixels) worked out from the film size and the group
count."""

from __future__ import annotations

import torch


class Segment:
    def __init__(self, cap: dict, ref_params):
        st0, st1 = cap["state_in"], cap["state_out"]
        config = cap["config"]
        if not config.block_ring:
            raise ValueError("the capture reads the block pixel ring only")
        if cap.get("pixel_base", 0):
            raise ValueError("the capture reads an unsharded segment only")
        self.pool0, self.pool1 = st0.pool, st1.pool
        self.hit = cap["hit"]
        self.occluded = cap["occluded"]
        stack = lambda f: torch.stack([f.color[0], f.color[1], f.color[2],
                                       f.weight])
        self.film0, self.film1 = stack(st0.film), stack(st1.film)
        rec = cap["splat"]
        self.splat_local, self.splat_data = rec["local"], rec["data"]
        self.groups = config.groups
        self.npx = config.width * config.height
        self.p = -(-self.npx // self.groups)
        self.pk = -(-self.p // 128) * 128
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
        g = idx.long() // self.s
        local = q - g * self.pk
        len_g = torch.clamp(self.npx - g * self.p, 1, self.p)
        in_ring = (local >= 0) & (local < len_g)
        same = q == self.pool0.pixel_index[idx].long()
        return torch.where(ended, in_ring, same)
