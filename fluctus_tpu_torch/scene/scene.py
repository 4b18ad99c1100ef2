"""Scene container: triangles and materials (the port's copy of the
reference package's scene/scene.py: OBJ, PLY, PBRT and ``.sc.json``,
src/scene.cpp:59-120 and 864-897), and the content hash that keys the BVH
and table caches.

Material slot 0 is the default material; ``textures`` holds the scene's
textures (``HostTexture``), deduplicated by name; ``envmap`` holds its
environment map (``envmap.EnvironmentMap``) or None; ``camera_override``
the camera a PBRT file carries (``pbrt_loader.PbrtCamera``) or None.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional

import numpy as np

from .. import bxdf_types as bx
from .material import (HostMaterial, default_material, infer_type,
                       materials_to_soa, to_roughness)
from .texture import HostTexture, TextureAtlas, pack_atlas


@dataclasses.dataclass
class ModelTransform:
    """Per-model uniform scale + translation of a ``.sc.json`` entry."""
    scale: float = 1.0
    translation: tuple = (0.0, 0.0, 0.0)

    def apply(self, p: np.ndarray) -> np.ndarray:
        return p * self.scale + np.asarray(self.translation, np.float32)


class Scene:
    def __init__(self):
        self.materials: List[HostMaterial] = [default_material()]
        self.material_types: int = self.materials[0].type
        self.textures: List[HostTexture] = []
        self.hash: str = ""    # content hash keying the caches; "" = none
        self._tri_chunks = []  # (p [M,3,3], n [M,3,3], t [M,3,2], matId [M])
        self.envmap = None
        self.camera_override = None     # set by formats that carry a camera
        self.pbrt_textures = {}         # PBRT texture name -> index or -1

    # -- geometry -----------------------------------------------------------
    def append_triangles(self, p, n, t, mat_id):
        self._tri_chunks.append((np.asarray(p, np.float32),
                                 np.asarray(n, np.float32),
                                 np.asarray(t, np.float32),
                                 np.asarray(mat_id, np.int32)))

    @property
    def num_triangles(self) -> int:
        return sum(c[0].shape[0] for c in self._tri_chunks)

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
        """Texture import deduplicated by name (scene.cpp:333-349): the
        index into ``textures``, or -1 for no name, a missing file (looked
        up in ``folder``, then as given) or one that fails to load."""
        if not name:
            return -1
        name = name.replace("\\", "/")
        for i, t in enumerate(self.textures):
            if t.name == name:
                return i
        path = os.path.join(folder, name)
        if not os.path.exists(path):
            if not os.path.exists(name):
                return -1
            path = name
        try:
            tex = HostTexture(path, name)
        except (OSError, ValueError) as e:   # PIL: not a readable image
            print(f"texture load failed for {path}: {e}")
            return -1
        self.textures.append(tex)
        return len(self.textures) - 1

    # -- env map --------------------------------------------------------------
    def load_env_map(self, filename: str):
        from ..envmap import EnvironmentMap
        self.envmap = EnvironmentMap(filename)

    def set_env_map(self, envmap):
        self.envmap = envmap

    # -- loading ------------------------------------------------------------
    def load_model(self, filename: str,
                   transform: Optional[ModelTransform] = None):
        """Extension dispatch (scene.cpp:59-120): OBJ, PLY, PBRT and
        ``.sc.json``. A whole-scene load (no transform) sets ``hash``: an
        OBJ's, PLY's or PBRT's is its file hash (not the hash of the files
        a PBRT includes, as the reference); a ``.sc.json``'s chains the
        hashes of the scene file and of every file it references, so
        editing a referenced model misses the caches (the reference's
        scene.py:109-145). A PBRT parse goes behind the ``.flc.npz`` parse
        cache (``pbrt_cache``) only for a whole-scene load into a fresh
        Scene (the reference's scene.py:112-123)."""
        if filename.endswith(".obj"):
            from .obj_loader import load_obj
            load_obj(filename, self, transform)
        elif filename.endswith(".ply"):
            from .ply_loader import load_ply
            load_ply(filename, self, transform)
        elif filename.endswith(".pbrt"):
            from . import pbrt_cache
            from .pbrt_loader import load_pbrt
            fresh = (transform is None and self.num_triangles == 0
                     and len(self.materials) == 1)
            h = file_hash(filename) if fresh else ""
            if not (fresh and pbrt_cache.load_cache(filename, h, self)):
                load_pbrt(filename, self, transform)
                if fresh:
                    pbrt_cache.save_cache(filename, h, self)
        elif filename.endswith(".sc.json"):
            self.load_scene_file(filename)
            if transform is None:
                folder = os.path.dirname(filename)
                h = hashlib.blake2b(file_hash(filename).encode(),
                                    digest_size=8)
                with open(filename) as f:
                    for info in json.load(f):
                        sub = info["file"]
                        path = sub if os.path.isabs(sub) \
                            else os.path.join(folder, sub)
                        h.update(file_hash(path).encode())
                self.hash = str(int.from_bytes(h.digest(), "little"))
            return
        else:
            raise ValueError(f"unknown scene format: {filename}")
        if transform is None:
            self.hash = file_hash(filename)

    def load_scene_file(self, filename: str):
        """Multi-model scene file (scene.cpp:864-897), as the reference
        package loads it. Repeated entries of one model file are instanced:
        parsed once, then re-appended with the entry's transform (uniform
        scale + translation) and the materials shared.

        Entry keys: ``file`` (relative to the .sc.json), ``scale``,
        ``translation``, ``skipMaterials`` (material names whose triangles
        this instance drops; instancing reuse needs an identical set) and
        ``materials`` (a per-instance override block, see
        ``_override_materials``)."""
        folder = os.path.dirname(filename)
        with open(filename) as f:
            scene_list = json.load(f)
        seen = {}   # (path, skip set) -> (chunk range, first transform, ids)
        for info in scene_list:
            tr = ModelTransform()
            if "scale" in info:
                tr.scale = float(info["scale"])
            if "translation" in info and len(info["translation"]) == 3:
                tr.translation = tuple(info["translation"])
            sub = info["file"]
            path = sub if os.path.isabs(sub) else os.path.join(folder, sub)
            skip = frozenset(info.get("skipMaterials", []))
            overrides = info.get("materials") or {}
            if (path, skip) in seen:
                # the pristine (pre-override) ids key the override lookup
                (c0, c1), tr0, pristine = seen[(path, skip)]
                lut = self._override_materials(pristine, overrides, folder)
                off0 = np.asarray(tr0.translation, np.float32)
                off = np.asarray(tr.translation, np.float32)
                s = np.float32(tr.scale / tr0.scale)
                for (p0, n0, t0, _), m0 in zip(self._tri_chunks[c0:c1],
                                               pristine):
                    self.append_triangles((p0 - off0) * s + off, n0, t0,
                                          lut[m0] if lut is not None else m0)
            else:
                c0 = len(self._tri_chunks)
                self.load_model(path, tr)
                c1 = len(self._tri_chunks)
                if skip:
                    names = np.array([m.name or "" for m in self.materials])
                    for k in range(c0, c1):
                        p0, n0, t0, m0 = self._tri_chunks[k]
                        keep = ~np.isin(names[m0], list(skip))
                        self._tri_chunks[k] = (p0[keep], n0[keep],
                                               t0[keep], m0[keep])
                pristine = [c[3] for c in self._tri_chunks[c0:c1]]
                seen[(path, skip)] = ((c0, c1), tr, pristine)
                lut = self._override_materials(pristine, overrides, folder)
                if lut is not None:
                    for k, m0 in zip(range(c0, c1), pristine):
                        p0, n0, t0, _ = self._tri_chunks[k]
                        self._tri_chunks[k] = (p0, n0, t0, lut[m0])

    def _override_materials(self, pristine_ids, overrides, folder):
        """Clone and override the material rows the given chunks use, per a
        ``.sc.json`` ``materials`` block {name: {...}}. Keys mirror MTL:
        Kd/Ks/Ke/Kt (3-lists), Ns (phong exponent, remapped to GGX alpha),
        Ni, d, shader (an explicit BXDF name), map_Kd/map_Ks/map_N. Without
        a shader the type is re-inferred from the new parameters, from the
        pre-remap Ns as the MTL loader does. Returns an int32 lut (old id
        -> id to use), or None when nothing is overridden."""
        if not overrides:
            return None
        used = sorted({int(u) for m0 in pristine_ids
                       for u in np.unique(m0)})
        if not used:
            return None
        lut = np.arange(max(used) + 1, dtype=np.int32)
        hit = False
        for mid in used:
            src = self.materials[mid]
            o = overrides.get(src.name)
            if not o:
                continue
            hit = True
            m = dataclasses.replace(src)
            for k3 in ("Kd", "Ks", "Ke", "Kt"):
                if k3 in o:
                    setattr(m, k3, tuple(float(v) for v in o[k3]))
            if "Ns" in o:
                m.Ns = float(o["Ns"])      # phong exponent; remapped below
            if "Ni" in o:
                m.Ni = float(o["Ni"])
            if "d" in o:
                m.d = float(o["d"])
            for mk in ("map_Kd", "map_Ks", "map_N"):
                if mk in o:
                    setattr(m, mk, self.try_import_texture(folder, o[mk]))
            if "shader" in o:
                t, ok = bx.parse_shader_type(o["shader"])
                if not ok:
                    raise ValueError(f"unknown shader {o['shader']!r}")
                m.type = t
            else:
                m.type = bx.BXDF_DIFFUSE
                m.type = infer_type(m, False)
            if "Ns" in o:
                m.Ns = to_roughness(m.Ns)
            m.name = f"{src.name}@{len(self.materials)}"
            lut[mid] = len(self.materials)
            self.add_material(m)
        return lut if hit else None

    # -- device upload ------------------------------------------------------
    def device_materials(self, *, device):
        return materials_to_soa(self.materials, device=device)

    def device_textures(self, *, device) -> TextureAtlas:
        """The packed atlas on ``device``, with which map types the
        materials use."""
        return pack_atlas(self.textures, device=device).with_material_usage(
            self.materials)

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


def file_hash(filename: str) -> str:
    """Content hash keying the BVH and table caches: blake2b-64 of the file,
    as a decimal string (the reference package's, so both share caches)."""
    h = hashlib.blake2b(digest_size=8)
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return str(int.from_bytes(h.digest(), "little"))
