"""Settings — the reference package's settings.py (src/settings.cpp/.hpp):
the same fields and defaults (settings.cpp:17-58), the same
``settings.json`` schema with ``release`` / ``debug`` overlay sections
(settings.cpp:61-87) and the same key set (settings.cpp:89-247).

Fields fall in two kinds:

- read by the port: ``wf_buffer_size``, ``max_path_depth``, ``max_spp``,
  ``tonemap``, ``render_scale`` (the Renderer scales its film by it),
  ``use_denoiser`` and ``denoiser_blend``, the light and sampling
  switches, ``env_map_name``, ``split_mode`` ("sbvh" raises on a
  hierarchy-cache miss: the SBVH builder is not ported), ``camera`` and
  ``area_light`` (a saved render state, ``state_io``, holds and restores
  them with ``camera_rotation`` and ``camera_speed``),
  ``wf_block_ring`` (False, or ``FLT_BLOCK_RING=0``, renders on the flat
  pixel ring); the CLI (``python -m fluctus_tpu_torch``) also reads ``shortcuts`` (the
  scene when none is given) and ``max_render_time`` (its wavefront loop's
  stop);
- accepted and ignored, as the reference ignores them for its results:
  ``platform_name`` and ``device_name`` (the Renderer's ``device``
  chooses), ``window_width`` and ``window_height`` (the Renderer is given
  its width and height), ``default_scene``, ``use_wavefront`` (the caller
  picks render_wavefront or render_single),
  ``use_bitstack``, ``use_soa`` and ``use_separate_queues`` (OpenCL kernel
  variants of the original renderer; the reference reads none of them),
  ``wf_phases`` and ``wf_fused_shade`` (how the reference cuts a segment
  into programs; every cut renders the same film), and ``wf_splat_every``
  and its ``FLT_SPLAT_EVERY`` (the reference batches the flat ring's film
  scatter over K segments; the film is the same up to float order, and
  the batch was slower on the H100 as on the TPU, so the port scatters
  every segment).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Tuple

Vec = Tuple[float, float, float]


def _norm(v):
    n = math.sqrt(sum(c * c for c in v)) or 1.0
    return tuple(c / n for c in v)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


@dataclasses.dataclass
class CameraSettings:
    pos: Vec = (0.0, 1.0, 3.5)
    right: Vec = (1.0, 0.0, 0.0)
    up: Vec = (0.0, 1.0, 0.0)
    dir: Vec = (0.0, 0.0, -1.0)
    fov: float = 60.0
    aperture_size: float = 0.0
    focal_dist: float = 0.5
    camera_rotation: Tuple[float, float] = (0.0, 0.0)
    camera_speed: float = 1.0


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
    platform_name: str = ""
    device_name: str = ""
    env_map_name: str = ""
    default_scene: int = 0
    render_scale: float = 1.0
    window_width: int = 640
    window_height: int = 480
    wf_buffer_size: int = 1 << 20   # settings.cpp:26
    use_bitstack: bool = False
    use_soa: bool = True
    use_wavefront: bool = False
    use_russian_roulette: bool = False
    use_separate_queues: bool = False
    max_path_depth: int = 10
    max_spp: int = 0                # 0 = unbounded (CHECK_SPP off)
    max_render_time: int = 0
    sample_implicit: bool = True
    sample_explicit: bool = True
    use_env_map: bool = False
    use_area_light: bool = True
    tonemap: int = 2                # UC2 default (settings.cpp:39)
    use_denoiser: bool = False
    denoiser_blend: float = 1.0     # 0 = original, 1 = fully denoised
    # hierarchy builder: "sah" (tracer.cpp:949 default) or "sbvh"; part of
    # the table cache's key
    split_mode: str = "sah"
    # the reference's wavefront dispatch: block-bound pixel pool, trace and
    # logic as separate programs, shade fused into the logic program, film
    # scatter batching
    wf_block_ring: bool = True
    wf_phases: bool = True
    wf_fused_shade: bool = True
    wf_splat_every: int = 1
    shortcuts: Dict[int, str] = dataclasses.field(default_factory=dict)
    camera: CameraSettings = dataclasses.field(default_factory=CameraSettings)
    area_light: AreaLightSettings = dataclasses.field(
        default_factory=AreaLightSettings)

    @staticmethod
    def load(path: str = "settings.json", debug: bool = False) -> "Settings":
        s = Settings()
        if not os.path.exists(path):
            return s
        try:
            with open(path) as f:
                j = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            print(f"settings load failed ({path}): {e}; using defaults")
            return s
        if "release" not in j or "debug" not in j:
            return s
        s.import_json(j["release"])
        if debug:
            s.import_json(j["debug"])
        return s

    def import_json(self, j: dict):
        """settings.cpp:89-247 key-for-key."""
        g = j.get
        self.platform_name = g("platformName", self.platform_name)
        self.device_name = g("deviceName", self.device_name)
        self.env_map_name = g("envMap", self.env_map_name)
        self.render_scale = g("renderScale", self.render_scale)
        self.window_width = g("windowWidth", self.window_width)
        self.window_height = g("windowHeight", self.window_height)
        self.split_mode = g("splitMode", self.split_mode)
        self.use_bitstack = g("clUseBitstack", self.use_bitstack)
        self.use_soa = g("clUseSoA", self.use_soa)
        self.wf_buffer_size = g("wfBufferSize", self.wf_buffer_size)
        self.use_wavefront = g("useWavefront", self.use_wavefront)
        self.wf_block_ring = g("wfBlockRing", self.wf_block_ring)
        self.wf_phases = g("wfPhases", self.wf_phases)
        self.wf_fused_shade = g("wfFusedShade", self.wf_fused_shade)
        self.wf_splat_every = g("wfSplatEvery", self.wf_splat_every)
        self.use_russian_roulette = g("useRussianRoulette",
                                      self.use_russian_roulette)
        self.use_separate_queues = g("useSeparateQueues",
                                     self.use_separate_queues)
        self.max_path_depth = g("maxPathDepth", self.max_path_depth)
        self.max_spp = g("maxSpp", self.max_spp)
        self.max_render_time = g("maxRenderTime", self.max_render_time)
        self.sample_implicit = g("sampleImplicit", self.sample_implicit)
        self.sample_explicit = g("sampleExplicit", self.sample_explicit)
        self.use_env_map = g("useEnvMap", self.use_env_map)
        self.use_area_light = g("useAreaLight", self.use_area_light)
        self.tonemap = g("tonemap", self.tonemap)

        for k, v in j.get("shortcuts", {}).items():
            try:
                self.shortcuts[int(k)] = v
            except ValueError:
                pass
        if "defaultScene" in j:
            self.default_scene = j["defaultScene"]

        cam = j.get("camera", {})
        c = self.camera
        if "pos" in cam and len(cam["pos"]) == 3:
            c.pos = tuple(cam["pos"])
        if "dir" in cam and len(cam["dir"]) == 3:
            d = tuple(cam["dir"])
            if _dot(d, d) > 1e-3:
                c.dir = d
                self._calc_camera_rotation()
        if "lookAt" in cam and len(cam["lookAt"]) == 3:
            d = tuple(t - p for t, p in zip(cam["lookAt"], c.pos))
            if _dot(d, d) > 1e-3:
                c.dir = d
                self._calc_camera_rotation()
        c.fov = cam.get("fov", c.fov)
        c.aperture_size = cam.get("apertureSize", c.aperture_size)
        c.focal_dist = cam.get("focalDist", c.focal_dist)
        if "cameraRotation" in cam and len(cam["cameraRotation"]) == 2:
            c.camera_rotation = tuple(cam["cameraRotation"])
        self._calc_camera_matrix()
        c.camera_speed = cam.get("cameraSpeed", c.camera_speed)

        al = j.get("areaLight", {})
        a = self.area_light
        if "pos" in al and len(al["pos"]) == 3:
            a.pos = tuple(al["pos"])
        if "N" in al and len(al["N"]) == 3:
            n = tuple(al["N"])
            right = _cross(n, (0.0, 1.0, 0.0))
            if _dot(right, right) < 1e-6:
                right = tuple(x * _dot(n, (0.0, 1.0, 0.0))
                              for x in (1.0, 0.0, 0.0))
            up = _cross(right, n)
            a.N, a.right, a.up = _norm(n), _norm(right), _norm(up)
        if "E" in al:
            vals = al["E"]
            if len(vals) == 1:
                a.E = (vals[0],) * 3
            elif len(vals) == 3:
                a.E = tuple(vals)
        if "size" in al:
            vals = al["size"]
            if len(vals) == 1:
                a.size = (vals[0], vals[0])
            elif len(vals) == 2:
                a.size = tuple(vals)

    def _calc_camera_rotation(self):
        """settings.cpp:249-255."""
        d = _norm(self.camera.dir)
        self.camera.dir = d
        self.camera.camera_rotation = (
            math.degrees(math.atan2(d[0], -d[2])),
            -math.degrees(math.asin(max(-1.0, min(1.0, d[1])))))

    def _calc_camera_matrix(self):
        """settings.cpp:257-264: dir/right/up from the two rotation angles."""
        rx, ry = self.camera.camera_rotation
        a = math.radians(rx)   # yaw about +Y
        b = math.radians(ry)   # pitch about +X
        ca, sa = math.cos(a), math.sin(a)
        cb, sb = math.cos(b), math.sin(b)
        # R = rotation(X, b) * rotation(Y, a); right/up = rows 0/1, dir = -row 2
        self.camera.right = (ca, 0.0, sa)
        self.camera.up = (sa * sb, cb, -ca * sb)
        self.camera.dir = (sa * cb, -sb, -ca * cb)

