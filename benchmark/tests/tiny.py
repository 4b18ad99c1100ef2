"""A tiny scene and configuration for the CPU tests: a floor (diffuse,
with albedo and normal maps), a cube (glossy, with a specular map) and a
glass cube (rough dielectric), lit by the area light and the
benchmark's env map, rendered at 16 x 8 with 256 paths, so that every
traffic kind runs end to end in seconds on the program's plain PyTorch
kernels."""

from __future__ import annotations

import json
import os

import numpy as np

MTL = """newmtl floor
shader diffuse
Kd 0.55 0.55 0.55
map_Kd albedo.png
map_bump normal.png

newmtl box
shader glossy
Kd 0.65 0.25 0.08
Ks 0.04 0.04 0.04
Ni 1.5
Ns 200
map_Ks specular.png

newmtl glass
shader rough_dielectric
Ks 1.0 1.0 1.0
Kt 0.98 0.98 0.98
Ni 1.5
Ns 500
"""

SCALE = (16, 8, 256)          # width, height, paths
SECONDS = {"luxball_prod.wavefront": 0.05, "luxball_prod.preview": 0.05}
PARAMS = dict(warm_segments=1, chunk_segments=1, trace_segments=1,
              warm_commands=1, trace_commands=1)


def _cube(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    f = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
         (3, 7, 6), (3, 6, 2), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    return v, f


def write_scene(out_dir: str) -> str:
    """The OBJ, its MTL and three 8 x 8 maps; returns the OBJ's path."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(7)
    for name in ("albedo", "normal", "specular"):
        img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        if name == "normal":
            img[..., 2] = 255
        Image.fromarray(img, "RGB").save(os.path.join(out_dir,
                                                      f"{name}.png"))
    lines = ["mtllib tiny.mtl\n"]
    verts = [(-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)]
    groups = [("floor", [(0, 2, 1), (0, 3, 2)])]
    for name, (lo, hi) in (("box", ((-1.2, 0, -0.5), (-0.2, 1, 0.5))),
                           ("glass", ((0.3, 0, -0.4), (1.1, 0.8, 0.4)))):
        v, f = _cube(lo, hi)
        base = len(verts)
        verts += v
        groups.append((name, [tuple(base + i for i in t) for t in f]))
    for x, y, z in verts:
        lines.append(f"v {x} {y} {z}\nvt {x / 2.0} {z / 2.0}\n")
    for name, faces in groups:
        lines.append(f"usemtl {name}\n")
        for t in faces:
            lines.append("f " + " ".join(f"{i + 1}/{i + 1}" for i in t)
                         + "\n")
    with open(os.path.join(out_dir, "tiny.mtl"), "w") as f:
        f.write(MTL)
    path = os.path.join(out_dir, "tiny.obj")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def config(bench_dir: str, scene_dir: str) -> dict:
    """The luxball_prod configuration with the tiny scene in its place."""
    with open(os.path.join(bench_dir, "configs", "luxball_prod.json")) as f:
        cfg = json.load(f)
    cfg["scene"] = {"kind": "file", "file": write_scene(scene_dir)}
    cfg["triangles"] = 26
    cfg["camera"] = {"pos": [0.0, 2.0, 6.0], "dir": [0.0, -0.3, -1.0],
                     "fov": 60.0}
    return cfg


def cell(bench_dir: str, name: str) -> dict:
    with open(os.path.join(bench_dir, "workloads", f"{name}.json")) as f:
        return json.load(f)
