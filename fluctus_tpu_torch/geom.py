"""Core geometry / parameter types (the reference's src/geom.h structs).

``RenderConfig`` is the static, hashable part of the render parameters
(the analogue of the reference's kernel -D defines); ``RenderParams`` holds
the values (camera, light) as 0-dim float32 tensors on the render device,
so every product with them rounds in float32 as in the reference package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .vec import Vec3

MIN_PATH_LENGTH = 5   # Russian roulette starts past it (geom.h:39)


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


class Camera(NamedTuple):
    """Pinhole + thin-lens camera (geom.h:165-175)."""
    pos: Vec3
    dir: Vec3
    up: Vec3
    right: Vec3
    fov: torch.Tensor            # degrees
    fov_scale: torch.Tensor      # tan(fov/2 in rad)
    aperture_size: torch.Tensor
    focal_dist: torch.Tensor

    @staticmethod
    def make(pos, dir, up, right, fov=60.0, aperture_size=0.0,
             focal_dist=0.5, *, device):
        return Camera(
            pos=Vec3.of(*pos, device=device), dir=Vec3.of(*dir, device=device),
            up=Vec3.of(*up, device=device),
            right=Vec3.of(*right, device=device), fov=_f32(fov, device),
            fov_scale=_f32(math.tan(math.radians(0.5 * float(fov))), device),
            aperture_size=_f32(aperture_size, device),
            focal_dist=_f32(focal_dist, device))


class AreaLight(NamedTuple):
    """Rectangular area light (geom.h:120-128). size_* are half extents."""
    right: Vec3
    up: Vec3
    N: Vec3
    pos: Vec3
    E: Vec3
    size_x: torch.Tensor
    size_y: torch.Tensor

    @staticmethod
    def make(pos, N, right, up, E, size, *, device):
        v = lambda t: Vec3.of(*t, device=device)
        return AreaLight(pos=v(pos), N=v(N), right=v(right), up=v(up),
                         E=v(E), size_x=_f32(size[0], device),
                         size_y=_f32(size[1], device))


class PostProcessParams(NamedTuple):
    exposure: torch.Tensor
    tm_operator: int  # 0 linear, 1 reinhard, 2 uncharted2, 3 raw


class RenderParams(NamedTuple):
    """Dynamic render parameters (geom.h:183-203, value part)."""
    camera: Camera
    area_light: AreaLight
    world_radius: torch.Tensor
    pp: PostProcessParams
    # the spp cap's value (0-dim int32, or a plain int): the reference's
    # params.maxSpp kernel argument; RenderConfig.max_spp > 0 gates it
    max_spp: torch.Tensor = 0
    # env map radiance scale (0-dim float32, or a plain float)
    env_map_strength: torch.Tensor = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render flags plus film geometry (the reference's kernel
    defines). The port renders with the block-bound pool; ``denoiser``
    accumulates the denoiser's guide features (first-hit albedo and
    camera-space normal) beside the film.
    The env map and the area light are each on or off; with both, NEE
    picks either with probability 1/2. ``sample_impl`` (implicit light
    hits) and ``sample_expl`` (next-event estimation) are each on or off,
    with MIS between them when both are on; ``use_roulette`` ends paths
    longer than MIN_PATH_LENGTH by Russian roulette. ``fast_env`` takes
    the env map's single-read forms (on CUDA, as the reference on its
    TPU). ``max_spp > 0`` switches on the exact spp cap (CHECK_SPP): its
    value comes from ``RenderParams.max_spp`` when that is > 0."""
    width: int
    height: int
    max_bounces: int = 4
    use_env_map: bool = False
    use_area_light: bool = True
    sample_impl: bool = True        # implicit light hits (SAMPLE_IMPLICIT)
    sample_expl: bool = True        # next-event estimation (SAMPLE_EXPLICIT)
    use_roulette: bool = False
    fast_env: bool = False
    max_spp: int = 0                # 0 = unbounded (CHECK_SPP off)
    material_types: int = 0         # OR of BXDF type bits present in scene
    denoiser: bool = False          # accumulate the guide features
    # block-bound wavefront pool: `groups` groups of pool lanes, each bound
    # to one contiguous pixel block with its own raygen ring; False is the
    # flat pixel ring (the reference's default is False; the port's is
    # True, and Renderer._derive_config always sets it)
    block_ring: bool = True
    groups: int = 1024

    def block_plan(self, num_tasks: int):
        from .core.block_splat import plan
        return plan(self.num_pixels, num_tasks, self.groups)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


class Hit(NamedTuple):
    """Closest-hit record (geom.h:152-161), SoA over a ray batch."""
    P: Vec3
    N: Vec3
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    t: torch.Tensor
    i: torch.Tensor               # triangle index, -1 = miss
    area_light_hit: torch.Tensor  # int32 0/1
    mat_id: torch.Tensor


class MaterialsSoA(NamedTuple):
    """Device form of the material table (geom.h:130-143)."""
    Kd: Vec3
    Ks: Vec3
    Ke: Vec3
    Kt: Vec3
    Ns: torch.Tensor      # GGX alpha after the toRoughness remap
    Ni: torch.Tensor
    d: torch.Tensor       # dissolve
    map_Kd: torch.Tensor  # int32 texture idx, -1 = none
    map_Ks: torch.Tensor
    map_N: torch.Tensor
    type: torch.Tensor    # int32 BXDF bits
