"""Wavefront OBJ + MTL loader (the port's copy of the reference package's
scene/obj_loader.py).

A from-scratch parser with the same observable behavior as the reference's
tinyobj path (src/scene.cpp:144-330): triangulated faces, per-face material
ids (offset past already-loaded materials, -1 -> default material 0), flat
normals generated when absent, and the custom ``shader`` MTL tag feeding the
BXDF heuristics. Triangle-fan triangulation matches tinyobj's default.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .. import bxdf_types as bx
from .material import HostMaterial, infer_type, to_roughness


def parse_mtl(path: str) -> List[HostMaterial]:
    """Parse a .mtl file into HostMaterials (types not yet inferred)."""
    mats: List[HostMaterial] = []
    cur: Optional[HostMaterial] = None
    cur_shader_ok = False

    def finish():
        nonlocal cur, cur_shader_ok
        if cur is not None:
            cur.type = infer_type(cur, cur_shader_ok)
            cur.Ns = to_roughness(cur.Ns)  # scene.cpp:325
            mats.append(cur)
        cur, cur_shader_ok = None, False

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                finish()
                cur = HostMaterial(name=" ".join(parts[1:]))
                # tinyobj defaults: everything 0, Ns=1, Ni=1, d=1
                cur.Ns, cur.Ni, cur.d = 1.0, 1.0, 1.0
            elif cur is None:
                continue
            elif key == "Kd":
                cur.Kd = tuple(float(v) for v in parts[1:4])
            elif key == "Ks":
                cur.Ks = tuple(float(v) for v in parts[1:4])
            elif key == "Ke":
                cur.Ke = tuple(float(v) for v in parts[1:4])
            elif key in ("Kt", "Tf"):
                cur.Kt = tuple(float(v) for v in parts[1:4])
            elif key == "Ns":
                cur.Ns = float(parts[1])
            elif key == "Ni":
                cur.Ni = float(parts[1])
            elif key == "d":
                cur.d = float(parts[1])
            elif key == "Tr":
                cur.d = 1.0 - float(parts[1])
            elif key == "map_Kd":
                cur._map_Kd_name = parts[-1]
            elif key == "map_Ks":
                cur._map_Ks_name = parts[-1]
            elif key in ("map_bump", "bump", "map_Bump", "norm"):
                cur._map_N_name = parts[-1]  # bump treated as normal map
            elif key == "shader":
                cur.type, cur_shader_ok = bx.parse_shader_type(parts[1])
    finish()
    return mats


def load_obj(path: str, scene, transform=None):
    """Load an OBJ file into the given Scene (appends triangles/materials);
    a ``ModelTransform`` moves the positions (normals stay as they are:
    the transform is a uniform scale + translation)."""
    folder = os.path.dirname(path)
    mat_offset = len(scene.materials)

    positions: List[List[float]] = []
    normals: List[List[float]] = []
    texcoords: List[List[float]] = []
    # per-triangle corner index tuples (vi, ti, ni) and material id
    face_v = []
    face_t = []
    face_n = []
    face_m = []
    cur_mat = -1
    mtl_by_name = {}
    loaded_mats: List[HostMaterial] = []

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for raw in f:
            if not raw or raw[0] in "#\n":
                continue
            parts = raw.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif key == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif key == "vt":
                texcoords.append([float(parts[1]),
                                  float(parts[2]) if len(parts) > 2 else 0.0])
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    sp = tok.split("/")
                    vi = resolve(sp[0], len(positions))
                    ti = resolve(sp[1], len(texcoords)) if len(sp) > 1 and sp[1] else -1
                    ni = resolve(sp[2], len(normals)) if len(sp) > 2 and sp[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri = (corners[0], corners[k], corners[k + 1])
                    face_v.append([c[0] for c in tri])
                    face_t.append([c[1] for c in tri])
                    face_n.append([c[2] for c in tri])
                    face_m.append(cur_mat)
            elif key == "usemtl":
                cur_mat = mtl_by_name.get(" ".join(parts[1:]), -1)
            elif key == "mtllib":
                mtl_path = os.path.join(folder, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    new = parse_mtl(mtl_path)
                    for m in new:
                        mtl_by_name[m.name] = len(loaded_mats)
                        loaded_mats.append(m)

    # Resolve textures on loaded materials
    for m in loaded_mats:
        m.map_Kd = scene.try_import_texture(folder, getattr(m, "_map_Kd_name", ""))
        m.map_Ks = scene.try_import_texture(folder, getattr(m, "_map_Ks_name", ""))
        m.map_N = scene.try_import_texture(folder, getattr(m, "_map_N_name", ""))

    P = np.asarray(positions, np.float32).reshape(-1, 3)
    N = np.asarray(normals, np.float32).reshape(-1, 3)
    T = np.asarray(texcoords, np.float32).reshape(-1, 2)
    fv = np.asarray(face_v, np.int64).reshape(-1, 3)
    ft = np.asarray(face_t, np.int64).reshape(-1, 3)
    fn = np.asarray(face_n, np.int64).reshape(-1, 3)
    fm = np.asarray(face_m, np.int64).reshape(-1)

    p = P[fv]                                   # [M,3,3]
    if transform is not None:
        p = transform.apply(p)

    n = np.zeros_like(p)
    has_n = (fn >= 0).all(axis=1) & (len(N) > 0)
    if len(N):
        n[has_n] = N[np.maximum(fn[has_n], 0)]
    # faces missing any normal get flat geometric normals (scene.cpp:242-243)
    flat = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-20)
    n[~has_n] = flat[~has_n, None, :]

    t = np.zeros((len(fv), 3, 2), np.float32)
    if len(T):
        valid_t = ft >= 0
        t[valid_t] = T[np.maximum(ft, 0)[valid_t]]

    # material id: -1 -> 0 (default), else offset past existing materials
    mat_id = np.where(fm < 0, 0, fm + mat_offset).astype(np.int32)

    scene.append_triangles(p, n, t, mat_id)
    for m in loaded_mats:
        scene.add_material(m)
