"""ASCII PLY loader, the port's copy of the reference package's
scene/ply_loader.py (src/scene.cpp:352-484): vertex x/y/z with optional
nx/ny/nz, triangle and quad faces (a quad splits into i0i1i2 / i2i3i0),
flat normals when the file has none, elements other than vertex and face
skipped line by line. Any other polygon size raises ValueError. Numpy
only."""

from __future__ import annotations

import numpy as np


def _header(f):
    """The elements the header declares, in order: (name, count, property
    names); leaves ``f`` at the first line after ``end_header``."""
    elements = []
    name, count, props = None, 0, []
    for line in f:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            if name is not None:
                elements.append((name, count, props))
            name, count, props = parts[1], int(parts[2]), []
        elif parts[0] == "property":
            props.append(parts[-1])
        elif parts[0] == "end_header":
            if name is not None:
                elements.append((name, count, props))
            break
    return elements


def load_ply(path: str, scene, transform=None):
    """Append the PLY file's triangles to ``scene`` with the default
    material (id 0) and zero uvs, positions through ``transform`` when
    given."""
    positions, normals, faces = [], [], []
    with open(path, "r", errors="replace") as f:
        for ename, ecount, eprops in _header(f):
            if ename == "vertex":
                idx = {p: i for i, p in enumerate(eprops)}
                rows = np.loadtxt(f, max_rows=ecount, dtype=np.float32,
                                  ndmin=2)
                positions = rows[:, [idx["x"], idx["y"], idx["z"]]]
                if "nx" in idx:
                    normals = rows[:, [idx["nx"], idx["ny"], idx["nz"]]]
            elif ename == "face":
                for _ in range(ecount):
                    vals = f.readline().split()
                    k = int(vals[0])
                    ids = [int(v) for v in vals[1:1 + k]]
                    if k == 3:
                        faces.append(ids)
                    elif k == 4:
                        faces.append([ids[0], ids[1], ids[2]])
                        faces.append([ids[2], ids[3], ids[0]])
                    else:
                        raise ValueError(f"unsupported polygon size {k}")
            else:
                for _ in range(ecount):
                    f.readline()

    tri = np.asarray(faces, np.int64)
    p = np.asarray(positions, np.float32)[tri]
    if transform is not None:
        p = transform.apply(p)
    if len(normals):
        n = np.asarray(normals, np.float32)[tri]
    else:
        flat = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True),
                           1e-20)
        n = np.repeat(flat[:, None, :], 3, axis=1)
    t = np.zeros((len(tri), 3, 2), np.float32)
    scene.append_triangles(p, n, t, np.zeros(len(tri), np.int32))
