"""Settings — the fields of the reference package's settings.py
(src/settings.cpp:17-58 defaults) that the port reads. The reference's
other switches (env map, Russian roulette, sampling toggles, denoiser,
render scale) keep their default values, which the port builds in until
it ports them."""

from __future__ import annotations

import dataclasses
from typing import Tuple

Vec = Tuple[float, float, float]


@dataclasses.dataclass
class CameraSettings:
    pos: Vec = (0.0, 1.0, 3.5)
    right: Vec = (1.0, 0.0, 0.0)
    up: Vec = (0.0, 1.0, 0.0)
    dir: Vec = (0.0, 0.0, -1.0)
    fov: float = 60.0
    aperture_size: float = 0.0
    focal_dist: float = 0.5


@dataclasses.dataclass
class AreaLightSettings:
    right: Vec = (0.0, 0.0, -1.0)
    up: Vec = (0.0, 1.0, 0.0)
    N: Vec = (-1.0, 0.0, 0.0)
    pos: Vec = (1.0, 1.0, 0.0)
    E: Vec = (100.0, 100.0, 100.0)
    size: Tuple[float, float] = (0.5, 0.5)


@dataclasses.dataclass
class Settings:
    wf_buffer_size: int = 1 << 20   # settings.cpp:26
    max_path_depth: int = 10
    max_spp: int = 0                # 0 = unbounded (CHECK_SPP off)
    tonemap: int = 2                # UC2 default (settings.cpp:39)
    # hierarchy builder: "sah" (tracer.cpp:949 default) or "sbvh" (not
    # ported: load_scene raises); part of the table cache's key
    split_mode: str = "sah"
    camera: CameraSettings = dataclasses.field(default_factory=CameraSettings)
    area_light: AreaLightSettings = dataclasses.field(
        default_factory=AreaLightSettings)
