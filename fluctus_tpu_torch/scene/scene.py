"""Scene container: triangles and materials (the port's copy of the OBJ path
of the reference package's scene/scene.py, src/scene.cpp:59-120).

Material slot 0 is the default material. The PLY, PBRT and ``.sc.json``
loaders, textures and the environment map are not ported yet and raise.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .material import HostMaterial, default_material, materials_to_soa


class Scene:
    def __init__(self):
        self.materials: List[HostMaterial] = [default_material()]
        self.material_types: int = self.materials[0].type
        self._tri_chunks = []  # (p [M,3,3], n [M,3,3], t [M,3,2], matId [M])

    # -- geometry -----------------------------------------------------------
    def append_triangles(self, p, n, t, mat_id):
        self._tri_chunks.append((np.asarray(p, np.float32),
                                 np.asarray(n, np.float32),
                                 np.asarray(t, np.float32),
                                 np.asarray(mat_id, np.int32)))

    def triangle_arrays(self):
        """Returns (positions [M,3,3], normals [M,3,3], uvs [M,3,2], matId [M])."""
        if not self._tri_chunks:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z, np.zeros((0, 3, 2), np.float32), np.zeros(0, np.int32)
        ps = np.concatenate([c[0] for c in self._tri_chunks])
        ns = np.concatenate([c[1] for c in self._tri_chunks])
        ts = np.concatenate([c[2] for c in self._tri_chunks])
        ms = np.concatenate([c[3] for c in self._tri_chunks])
        return ps, ns, ts, ms

    # -- materials / textures -----------------------------------------------
    def add_material(self, m: HostMaterial):
        self.materials.append(m)
        self.material_types |= m.type

    def try_import_texture(self, folder: str, name: str) -> int:
        """Texture import: a missing file gives -1 like the reference; an
        existing one raises, since the port has no texture atlas yet."""
        if not name:
            return -1
        name = name.replace("\\", "/")
        if os.path.exists(os.path.join(folder, name)) or os.path.exists(name):
            raise NotImplementedError(
                f"texture {name!r}: textures are not ported yet")
        return -1

    # -- loading ------------------------------------------------------------
    def load_model(self, filename: str):
        """Extension dispatch (scene.cpp:59-120); OBJ only for now."""
        if filename.endswith(".obj"):
            from .obj_loader import load_obj
            load_obj(filename, self)
        else:
            raise NotImplementedError(
                f"{filename}: only the OBJ loader is ported yet")

    # -- device upload ------------------------------------------------------
    def device_materials(self, device="cpu"):
        return materials_to_soa(self.materials, device)

    def scene_bounds(self):
        p, _, _, _ = self.triangle_arrays()
        if p.size == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        flat = p.reshape(-1, 3)
        return flat.min(axis=0), flat.max(axis=0)

    def world_radius(self) -> float:
        """Half the scene AABB diagonal (tracer.cpp:77-79)."""
        lo, hi = self.scene_bounds()
        return float(np.linalg.norm(hi - lo) * 0.5)
