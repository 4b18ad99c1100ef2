"""High-level renderer (src/tracer.cpp; the reference package's
renderer.py): scene load -> BVH -> cluster tables -> device upload, render
parameters, the free-running wavefront loop and image output.

``Renderer`` runs on ``"cuda"`` unless the caller passes ``device="cpu"``
(the CPU tests, which then run each kernel's plain PyTorch version).
Without CUDA and without ``device="cpu"`` it raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .accel import build_bvh
from .accel import mxu_trace as mt
from .native import build_bvh_native
from .bsdf import check_lobes
from .core.integrator_mk import Film, RenderStats
from .core.integrator_wf import (unpad_pixels, wf_reset, wf_shade_phase,
                                 wf_trace_phase)
from .core.tonemap import postprocess
from .core.trace import DeviceScene
from .geom import AreaLight, Camera, PostProcessParams, RenderConfig, RenderParams
from .image_io import save_png
from .scene import Scene
from .settings import Settings


def resolve_device(device=None) -> torch.device:
    """The render device: CUDA by default; CPU only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Renderer:
    def __init__(self, width: int, height: int,
                 settings: Optional[Settings] = None, device=None):
        self.device = resolve_device(device)
        self.settings = settings or Settings()
        self.width = int(width)
        self.height = int(height)
        self.scene: Optional[Scene] = None
        self.device_scene: Optional[DeviceScene] = None
        self.config: Optional[RenderConfig] = None
        self.params: Optional[RenderParams] = None
        self.exposure = 1.0
        self._wf_state = None

    # -- scene lifecycle (Tracer::init) -------------------------------------
    def load_scene(self, scene_file: str):
        """Load an OBJ or ``.sc.json`` scene, build its SAH BVH (the native
        builder past 20,000 triangles, as the reference) and cluster
        tables (slim past 65,536), and upload them. Env maps, saved render
        state and BVH/table caches are not ported yet. ``load_seconds``
        keeps the host time of each step."""
        t0 = time.perf_counter()
        scene = Scene()
        scene.load_model(scene_file)
        check_lobes(scene.material_types)
        self.scene = scene
        p, nrm, uv, mid = scene.triangle_arrays()
        t1 = time.perf_counter()
        bvh = build_bvh_native(p) if p.shape[0] > 20000 else build_bvh(p)
        t2 = time.perf_counter()
        host, statics = mt.MXUScene.build(
            p, bvh, normals=nrm, uvs=uv, mat_ids=mid,
            materials=scene.materials, slim=p.shape[0] > 65536)
        t3 = time.perf_counter()
        if p.shape[0] > 65536:
            print(f"MXU tables: {statics['n_clusters']} clusters, "
                  f"{statics['n_superclusters']} supers ({t3 - t2:.2f}s)")
        self.device_scene = DeviceScene(
            mxu=mt.tables_from_numpy(host, statics, self.device),
            material_types=scene.material_types)
        self.load_seconds = dict(load=t1 - t0, bvh=t2 - t1, tables=t3 - t2,
                                 upload=time.perf_counter() - t3)
        self.world_radius = scene.world_radius()
        self._derive_config()
        self.params = self._make_params()

    def _derive_config(self):
        """Static RenderConfig from the settings and film size. The pool
        group count: a power of two with >= 4 pixels per group dividing the
        pool, at most 1/16 of its lanes on empty tail groups (target ~512
        pixels per group)."""
        s = self.settings
        npx = self.width * self.height
        ntasks = s.wf_buffer_size

        def _lane_waste(g):
            p = -(-npx // g)
            return (g - -(-npx // p)) / g
        groups = 4096
        while groups > 1 and (npx < 4 * groups or ntasks % groups
                              or _lane_waste(groups) > 1 / 16):
            groups //= 2
        if groups <= 1:
            raise NotImplementedError(
                f"{self.width}x{self.height} with {ntasks} paths gives no "
                "block-bound pool; the flat pixel ring is not ported yet")
        self.config = RenderConfig(
            width=self.width, height=self.height,
            max_bounces=s.max_path_depth,
            material_types=self.scene.material_types, groups=groups)

    def _make_params(self) -> RenderParams:
        s = self.settings
        c = s.camera
        a = s.area_light
        dev = self.device
        cam = Camera.make(c.pos, c.dir, c.up, c.right, fov=c.fov,
                          aperture_size=c.aperture_size,
                          focal_dist=c.focal_dist, device=dev)
        light = AreaLight.make(a.pos, a.N, a.right, a.up, a.E, a.size,
                               device=dev)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return RenderParams(
            camera=cam, area_light=light,
            world_radius=f32(self.world_radius),
            pp=PostProcessParams(exposure=f32(self.exposure),
                                 tm_operator=int(s.tonemap)))

    # -- wavefront (throughput) mode ------------------------------------------
    def init_wavefront(self, num_tasks: Optional[int] = None):
        """Reset the persistent path pool (wf_reset analogue). Also picks
        up camera/light edits made to the settings since load_scene."""
        self.num_tasks = num_tasks or self.settings.wf_buffer_size
        self.params = self._make_params()
        self._wf_state = wf_reset(self.config, self.num_tasks,
                                  world_radius=self.world_radius,
                                  device=self.device)
        self._wf_counters = []

    def render_wavefront(self, segments: int, sync: bool = True):
        """Advance the wavefront `segments` steps: per segment the trace
        phase, then the shade phase (resolve fused with the logic)."""
        cfg = self.config
        for _ in range(segments):
            raw, occ = wf_trace_phase(self.device_scene, self._wf_state.pool,
                                      self.params, cfg)
            self._wf_state, cnt = wf_shade_phase(
                self.device_scene, self.params, self._wf_state, cfg, raw,
                occ)
            self._wf_counters.append(cnt)
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._wf_state

    def wavefront_stats(self) -> RenderStats:
        """Counters summed over the segments since init_wavefront, fetched
        in one transfer."""
        if not self._wf_counters:
            return RenderStats.zeros()
        mat = torch.stack([torch.stack([c.raygen.long(), c.extension.long(),
                                        c.shadow.long(), c.splatted.long()])
                           for c in self._wf_counters]).sum(dim=0).tolist()
        return RenderStats(*mat)

    def wavefront_film(self) -> Film:
        film = self._wf_state.film
        un = lambda a: unpad_pixels(a, self.config)
        return Film(color=type(film.color)(*(un(a) for a in film.color)),
                    weight=un(film.weight))

    # -- output --------------------------------------------------------------
    def ldr_image(self) -> np.ndarray:
        """Postprocessed [H, W, 3] float in [0, 1]; row 0 of the film is the
        bottom scanline, images store top-first."""
        film = self.wavefront_film()
        rgb = postprocess(film.color, film.weight, self.params.pp.exposure,
                          self.params.pp.tm_operator)
        arr = torch.stack([rgb.x, rgb.y, rgb.z], dim=-1).cpu().numpy()
        return np.clip(arr.reshape(self.height, self.width, 3)[::-1], 0.0,
                       1.0)

    def save_image(self, path: str):
        """Write the current wavefront film as an 8-bit PNG."""
        save_png(path, self.ldr_image())
