"""The parse cache of ``.pbrt`` scenes (the port's copy of the reference
package's scene/pbrt_cache.py; the role of the original renderer's .pbf,
src/scene.cpp:486-519): the parse's result, the triangle arrays, the
materials, the textures' names and paths and the camera, as one
``<file>.flc.npz`` next to the source, keyed by the source's content hash
and ``CACHE_VERSION``. The keys are the reference's, so either package
reads the file the other wrote. A second load is array I/O; the texture
images are read again from their saved paths, since they may change
without the ``.pbrt`` changing.

The file is written under a temporary name and moved into place; a folder
that cannot be written skips the cache with a printed line."""

from __future__ import annotations

import os
import zipfile

import numpy as np

from .material import HostMaterial
from .pbrt_loader import PbrtCamera
from .texture import HostTexture

CACHE_VERSION = 1
SUFFIX = ".flc.npz"


def cache_path(pbrt_path: str) -> str:
    return pbrt_path + SUFFIX


def save_cache(pbrt_path: str, source_hash: str, scene) -> None:
    """Write what ``load_pbrt`` put into a fresh Scene."""
    p, n, t, mid = scene.triangle_arrays()
    mats = scene.materials
    num = np.zeros((len(mats), 16), np.float32)
    for i, m in enumerate(mats):
        num[i, 0:3] = m.Kd
        num[i, 3:6] = m.Ks
        num[i, 6:9] = m.Ke
        num[i, 9:12] = m.Kt
        num[i, 12] = m.Ns
        num[i, 13] = m.Ni
        num[i, 14] = m.d
    maps = np.array([[m.map_Kd, m.map_Ks, m.map_N, m.type] for m in mats],
                    np.int32)
    cam = np.zeros(0, np.float32)
    c = scene.camera_override
    if c is not None:
        cam = np.asarray(list(c.pos) + list(c.dir) + list(c.up)
                         + list(c.right) + [c.fov], np.float32)
    path = cache_path(pbrt_path)
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # .npz: savez appends none
    try:
        np.savez_compressed(
            tmp, version=np.int32(CACHE_VERSION),
            source_hash=np.asarray(source_hash),
            positions=p, normals=n, uvs=t, mat_ids=mid,
            mat_num=num, mat_maps=maps,
            mat_names=np.array([m.name for m in mats]),
            tex_names=np.array([tx.name for tx in scene.textures]),
            tex_paths=np.array([tx.path for tx in scene.textures]),
            camera=cam, material_types=np.int32(scene.material_types))
        os.replace(tmp, path)
    except OSError as e:    # a read-only source folder: no cache
        print(f"pbrt cache write skipped: {e}")


def load_cache(pbrt_path: str, source_hash: str, scene) -> bool:
    """Fill a fresh Scene from the cache. False on a miss: no file, another
    hash or version, or a file or texture that cannot be read (printed)."""
    path = cache_path(pbrt_path)
    if not os.path.exists(path):
        return False
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != CACHE_VERSION or \
                    str(z["source_hash"]) != source_hash:
                return False
            num, maps, names = z["mat_num"], z["mat_maps"], z["mat_names"]
            mats = [HostMaterial(
                Kd=tuple(num[i, 0:3]), Ks=tuple(num[i, 3:6]),
                Ke=tuple(num[i, 6:9]), Kt=tuple(num[i, 9:12]),
                Ns=float(num[i, 12]), Ni=float(num[i, 13]),
                d=float(num[i, 14]),
                map_Kd=int(maps[i, 0]), map_Ks=int(maps[i, 1]),
                map_N=int(maps[i, 2]), type=int(maps[i, 3]),
                name=str(names[i])) for i in range(num.shape[0])]
            textures = [HostTexture(str(tp), str(tn))
                        for tn, tp in zip(z["tex_names"], z["tex_paths"])]
            chunk = (z["positions"], z["normals"], z["uvs"], z["mat_ids"])
            material_types = int(z["material_types"])
            cam = z["camera"]
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        print(f"pbrt cache read failed ({e}); re-parsing")
        return False
    scene.materials = mats
    scene.material_types = material_types
    scene.textures = textures
    scene._tri_chunks = [chunk]
    if cam.size == 13:
        scene.camera_override = PbrtCamera(
            pos=tuple(cam[0:3]), dir=tuple(cam[3:6]), up=tuple(cam[6:9]),
            right=tuple(cam[9:12]), fov=float(cam[12]))
    return True
