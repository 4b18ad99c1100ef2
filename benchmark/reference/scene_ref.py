"""The reference's own scene: triangles, materials, textures, the env
map, camera and light, worked out again from the scene files and the
configuration by ``scene_files``. Nothing here reads what the program
built (its BVH, cluster tables, atlas or env tables)."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from .scene_files import SceneFiles, read_hdr
from .shading import EnvMap


def _basis(yaw_deg, pitch_deg):
    """(dir, right, up) of the camera turned by ``yaw`` about +y and
    ``pitch`` about +x (settings.cpp:257-264)."""
    a, b = math.radians(yaw_deg), math.radians(pitch_deg)
    ca, sa, cb, sb = math.cos(a), math.sin(a), math.cos(b), math.sin(b)
    return ((sa * cb, -sb, -ca * cb), (ca, 0.0, sa),
            (sa * sb, cb, -ca * sb))


def camera_pose(view: dict, moves=()):
    """Position, (dir, right, up) and fov of the configuration's view
    after the interactive ``moves``: ("move", axis, sign) steps by the
    speed along dir, right or up; ("look", dx, dy) turns by degrees;
    ("speed", v) sets the step."""
    d = np.asarray(view["dir"], np.float64)
    d = d / np.linalg.norm(d)
    yaw = math.degrees(math.atan2(d[0], -d[2]))
    pitch = -math.degrees(math.asin(max(-1.0, min(1.0, d[1]))))
    pos = [float(v) for v in view["pos"]]
    speed = 1.0
    axes = _basis(yaw, pitch)
    for m in moves:
        if m[0] == "speed":
            speed = float(m[1])
        elif m[0] == "move":
            base = axes[("fwd", "right", "up").index(m[1])]
            pos = [p + b * speed * m[2] for p, b in zip(pos, base)]
        elif m[0] == "look":
            yaw, pitch = yaw + m[1], pitch + m[2]
            axes = _basis(yaw, pitch)
    return pos, axes, float(view.get("fov", 60.0))


class RefScene:
    """Everything the reference needs of one configuration's scene.
    ``fast_env``: the env map's route on the card (``shading.EnvMap``)."""

    def __init__(self, scene_file: str, env_file, view: dict, light: dict,
                 device, fast_env: bool):
        self.device = device
        sf = SceneFiles(scene_file)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        p = sf.p
        self.tris = (t(p[:, 0]), t(p[:, 1] - p[:, 0]), t(p[:, 2] - p[:, 0]))
        p64 = p.astype(np.float64)
        self.e1, self.e2 = t(p64[:, 1] - p64[:, 0]), t(p64[:, 2] - p64[:, 0])
        self.normals = t(sf.n)
        self.uv = t(sf.uv.astype(np.float64))
        self.uvs = t(sf.uv)
        self.mat_id = t(sf.mat)
        col = lambda k: t(np.array([getattr(m, k) for m in sf.mats],
                                   np.float64))
        ids = lambda k: t(np.array([m.map_ids[k] for m in sf.mats],
                                   np.int64))
        self.mats = SimpleNamespace(
            kd=col("kd"), ks=col("ks"), alpha=col("alpha"),
            ni=col("ni"), type=t(np.array([m.type for m in sf.mats],
                                          np.int64)),
            map_kd=ids("kd"), map_ks=ids("ks"), map_n=ids("n"))
        self.textures = [SimpleNamespace(rgb=t(img)) for img in sf.textures]
        self.env = (EnvMap(read_hdr(env_file), device, fast_env)
                    if env_file else None)
        flat = p.reshape(-1, 3).astype(np.float64)
        self.world_radius = float(np.linalg.norm(
            flat.max(axis=0) - flat.min(axis=0)) * 0.5)
        self.view = view
        self.light_cfg = light

    def params(self, moves=()):
        """Camera, light and the scalar render parameters, after the
        interactive ``moves``."""
        v = lambda a: torch.tensor(a, dtype=torch.float64,
                                   device=self.device)
        pos, (d, right, up), fov = camera_pose(self.view, moves)
        cam = SimpleNamespace(pos=v(pos), dir=v(d), right=v(right), up=v(up),
                              fov_scale=math.tan(math.radians(0.5 * fov)))
        lc, light = self.light_cfg, None
        if lc is not None:
            light = SimpleNamespace(pos=v(lc["pos"]), N=v(lc["N"]),
                                    right=v(lc["right"]), up=v(lc["up"]),
                                    E=v(lc["E"]), size_x=float(lc["size"][0]),
                                    size_y=float(lc["size"][1]))
        return SimpleNamespace(camera=cam, light=light,
                               world_radius=self.world_radius,
                               env_strength=1.0)
