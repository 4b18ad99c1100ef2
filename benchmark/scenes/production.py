"""The production luxball's writer: LuxBall with production materials
(albedo, normal and specular maps drawn from a seed; glossy, rough
reflection, rough and ideal dielectric lobes), as the port's chip check
writes it. A frozen copy, so that a later change of the program's
scripts does not move the benchmark's scene."""

import json
import os

PROD_MTL = """newmtl glass
shader rough_dielectric
Ks 1.0 1.0 1.0
Kt 0.98 0.98 0.98
Ni 1.5
Ns 500

newmtl core
shader glossy
Kd 0.65 0.25 0.08
Ks 0.04 0.04 0.04
Ni 1.5
Ns 200
map_Ks specular.png

newmtl ground
shader diffuse
Kd 0.55 0.55 0.55
map_Kd albedo.png
map_bump normal.png
"""

PROD_INSTANCE_B = {"translation": [2.3, 0.0, -1.2],
                   "skipMaterials": ["ground"],
                   "materials": {"core": {"shader": "rough_reflection",
                                          "Ks": [0.9, 0.8, 0.6], "Ni": 2.0,
                                          "Ns": 100},
                                 "glass": {"shader": "ideal_dielectric"}}}


def _production_maps(sizes, seed):
    """(albedo RGB, normal RGB, specular RGB) uint8 images."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s_kd, s_n, s_ks = sizes
    yy, xx = np.mgrid[0:s_kd, 0:s_kd]
    cell = max(1, s_kd // 8)
    check = ((yy // cell + xx // cell) % 2)[..., None]
    albedo = np.where(check, [0.85, 0.8, 0.7], [0.25, 0.35, 0.55])
    albedo = albedo * (0.9 + 0.1 * rng.random((s_kd, s_kd, 1)))
    yy, xx = np.mgrid[0:s_n, 0:s_n] * (2.0 * np.pi * 6.0 / s_n)
    n = np.stack([0.35 * np.sin(xx), 0.35 * np.sin(yy),
                  np.ones_like(xx)], -1)
    n += 0.05 * rng.standard_normal(n.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    spec = 0.1 + 0.8 * rng.random((s_ks, s_ks, 1)) * np.ones(3)
    u8 = lambda a: np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
    return u8(albedo), u8(n * 0.5 + 0.5), u8(spec)


def write_production_scene(out_dir: str, base_obj: str, sizes,
                           seed: int = 0) -> str:
    """The production luxball, written into ``out_dir`` from a seed:
    production.obj (``base_obj``, the luxball, with planar uvs, u = x / 2,
    v = z / 2, so the ground's maps repeat and wrap), production.mtl,
    seeded albedo, normal and specular PNGs (``sizes`` are their edge
    lengths) and production.sc.json. Instance A: the ground diffuse with
    an albedo map (map_Kd) and a normal map (map_bump), the core glossy
    with a specular map (map_Ks, Ns 200) and the glass rough dielectric
    (Ns 500). Instance B, beside it: no ground, the core overridden to
    rough reflection and the glass to ideal dielectric. So every lobe but
    emissive and every map type is in the scene. Returns the .sc.json's
    path."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    with open(base_obj) as f:
        for raw in f:
            parts = raw.split()
            if parts and parts[0] == "mtllib":
                lines.append("mtllib production.mtl\n")
            elif parts and parts[0] == "v":
                # the vertex's planar uv, so vertex i and uv i pair up
                x, z = float(parts[1]), float(parts[3])
                lines += [raw, f"vt {x / 2.0:.6f} {z / 2.0:.6f}\n"]
            elif parts and parts[0] == "f":
                lines.append("f " + " ".join(f"{i}/{i}" for i in parts[1:])
                             + "\n")
            else:
                lines.append(raw)
    with open(os.path.join(out_dir, "production.obj"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(out_dir, "production.mtl"), "w") as f:
        f.write(PROD_MTL)
    for name, img in zip(("albedo", "normal", "specular"),
                         _production_maps(sizes, seed)):
        Image.fromarray(img, "RGB").save(
            os.path.join(out_dir, f"{name}.png"), compress_level=1)
    path = os.path.join(out_dir, "production.sc.json")
    with open(path, "w") as f:
        json.dump([{"file": "production.obj"},
                   {"file": "production.obj", **PROD_INSTANCE_B}], f,
                  indent=1)
    return path
