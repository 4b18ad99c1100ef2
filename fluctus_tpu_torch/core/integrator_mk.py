"""Film and render statistics types (from the reference package's
core/integrator_mk.py). The megastep (mk) integrator itself is not ported
yet; the wavefront integrator uses these types."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..vec import Vec3


class Film(NamedTuple):
    color: Vec3            # [num_pixels] accumulated radiance
    weight: torch.Tensor   # [num_pixels] sample counts

    @staticmethod
    def zeros(num_pixels: int, device) -> "Film":
        return Film(Vec3.zeros(num_pixels, device),
                    torch.zeros(num_pixels, dtype=torch.float32,
                                device=device))


class RenderStats(NamedTuple):
    """Ray and sample counters (geom.h:279-285 analogue)."""
    primary_rays: int
    extension_rays: int
    shadow_rays: int
    samples: int

    @staticmethod
    def zeros():
        return RenderStats(0, 0, 0, 0)

    def __add__(self, o):
        return RenderStats(self.primary_rays + o.primary_rays,
                           self.extension_rays + o.extension_rays,
                           self.shadow_rays + o.shadow_rays,
                           self.samples + o.samples)
