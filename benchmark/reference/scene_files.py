"""The reference's own reading of a configuration's scene files: Wavefront
OBJ with its MTL (fluctus's scene.cpp semantics: fan triangulation, flat
normals where a face has none, the lobe from the ``shader`` tag, which
every material of the configurations has, the Phong exponent remapped to
a GGX alpha), the multi-model
``.sc.json`` (scene.cpp:864-897: per entry a uniform scale and a
translation, ``skipMaterials``, and a ``materials`` block overriding
the instance's materials), PNG textures and the Radiance ``.hdr`` env
map. Material and triangle numbering follow the loader's order, as the
renderer's hit records number them: material 0 is the default, every
model file loaded appends its MTL's materials, and an override appends
a new material."""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np

from .shading import DIFFUSE, SHADERS


@dataclasses.dataclass
class Material:
    name: str = ""
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)
    ns: float = 1.0          # the Phong exponent as read
    alpha: float = 1.0       # the GGX alpha it maps to
    ni: float = 1.0
    type: int = DIFFUSE
    maps: dict = dataclasses.field(default_factory=dict)   # kind -> name
    map_ids: dict = dataclasses.field(
        default_factory=lambda: dict(kd=-1, ks=-1, n=-1))


def roughness(ns: float) -> float:
    """Phong exponent -> GGX alpha (scene.cpp:13-16)."""
    return math.sqrt(2.0 / (2.0 + max(ns, 0.0)))


def lobe(name: str, where: str) -> int:
    if name not in SHADERS:
        raise ValueError(f"{where}: the reference has no lobe {name!r}")
    return SHADERS[name]


def read_mtl(path: str):
    mats, cur = [], None

    def done():
        if cur is not None:
            if cur.type is None:
                raise ValueError(f"{path}: {cur.name} has no shader tag")
            cur.alpha = roughness(cur.ns)
            mats.append(cur)
    with open(path, errors="replace") as f:
        for line in f:
            w = line.split()
            if not w or w[0].startswith("#"):
                continue
            k = w[0]
            if k == "newmtl":
                done()
                cur = Material(name=" ".join(w[1:]), type=None)
            elif cur is None:
                continue
            elif k in ("Kd", "Ks"):
                setattr(cur, k.lower(), tuple(float(v) for v in w[1:4]))
            elif k in ("Ns", "Ni"):
                setattr(cur, k.lower(), float(w[1]))
            elif k in ("map_Kd", "map_Ks"):
                cur.maps[k[4:].lower()] = w[-1]
            elif k in ("map_bump", "bump", "map_Bump", "norm"):
                cur.maps["n"] = w[-1]
            elif k == "shader":
                cur.type = lobe(w[1], path)
    done()
    return mats


def read_obj(path: str):
    """(positions [m, 3, 3], uvs [m, 3, 2], per-face material index into
    its MTL's list (-1: none), that list)."""
    folder = os.path.dirname(path)
    v, vt, vn = [], [], []
    tris, mats, names, cur = [], [], {}, -1
    lib = []

    def index(tok, n):
        i = int(tok)
        return i - 1 if i > 0 else n + i
    with open(path, errors="replace") as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            if w[0] == "v":
                v.append([float(x) for x in w[1:4]])
            elif w[0] == "vt":
                vt.append([float(w[1]), float(w[2]) if len(w) > 2 else 0.0])
            elif w[0] == "vn":
                vn.append([float(x) for x in w[1:4]])
            elif w[0] == "f":
                cs = []
                for tok in w[1:]:
                    p = tok.split("/")
                    cs.append((index(p[0], len(v)),
                               index(p[1], len(vt)) if len(p) > 1 and p[1]
                               else -1,
                               index(p[2], len(vn)) if len(p) > 2 and p[2]
                               else -1))
                for k in range(1, len(cs) - 1):
                    tris.append((cs[0], cs[k], cs[k + 1]))
                    mats.append(cur)
            elif w[0] == "usemtl":
                cur = names.get(" ".join(w[1:]), -1)
            elif w[0] == "mtllib":
                p = os.path.join(folder, " ".join(w[1:]))
                if os.path.exists(p):
                    for m in read_mtl(p):
                        names[m.name] = len(lib)
                        lib.append(m)
    c = np.array(tris, np.int64).reshape(-1, 3, 3)
    P = np.array(v, np.float32).reshape(-1, 3)
    T = np.array(vt, np.float32).reshape(-1, 2)
    N = np.array(vn, np.float32).reshape(-1, 3)
    p = P[c[:, :, 0]]
    uv = np.zeros(c.shape[:2] + (2,), np.float32)
    if len(T):
        has = c[:, :, 1] >= 0
        uv[has] = T[c[:, :, 1][has]]
    e = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-20)
    nrm = np.repeat(e[:, None], 3, axis=1)
    if len(N):
        has = (c[:, :, 2] >= 0).all(axis=1)
        nrm[has] = N[c[has][:, :, 2]]
    return p, uv, nrm, np.array(mats, np.int64), lib


class SceneFiles:
    """Triangles (positions, vertex uvs and normals, material ids),
    materials and textures of one scene file, ``.obj`` or ``.sc.json``."""

    def __init__(self, path: str):
        self.mats = [Material(name="<default>", kd=(0.64, 0.64, 0.64),
                              ns=700.0, alpha=700.0, ni=1.8)]
        self.textures, self._tex = [], {}
        self.parts = []
        if path.endswith(".sc.json"):
            self._scene_list(path)
        else:
            self.parts.append(self._model(path, frozenset()))
        cat = lambda k: np.concatenate([q[k] for q in self.parts])
        self.p, self.uv, self.n, self.mat = (cat(k) for k in range(4))

    def _texture(self, folder, name):
        """The index of texture ``name`` (read once per name), or -1."""
        if not name:
            return -1
        name = name.replace("\\", "/")
        if name not in self._tex:
            path = os.path.join(folder, name)
            path = path if os.path.exists(path) else name
            if not os.path.exists(path):
                return -1
            from PIL import Image
            with Image.open(path) as im:
                rgb = np.asarray(im.convert("RGB"), np.uint8)
            self._tex[name] = len(self.textures)
            self.textures.append(np.ascontiguousarray(rgb[::-1]))
        return self._tex[name]

    def _add(self, m: Material, folder) -> int:
        m.map_ids = {k: self._texture(folder, m.maps.get(k))
                     for k in ("kd", "ks", "n")}
        self.mats.append(m)
        return len(self.mats) - 1

    def _model(self, path, skip):
        """One model file's triangles, as the file places them, without
        the materials in ``skip``; its materials appended."""
        folder = os.path.dirname(path)
        p, uv, nrm, fm, lib = read_obj(path)
        ids = [self._add(m, folder) for m in lib]
        mat = np.array([ids[k] if k >= 0 else 0 for k in fm], np.int64)
        keep = np.array([self.mats[k].name not in skip for k in mat], bool)
        return [p[keep], uv[keep], nrm[keep], mat[keep]]

    def _scene_list(self, path):
        """Each entry's model, scaled and moved from the file's positions;
        a model file listed again with the same ``skipMaterials`` shares
        the materials of its first load."""
        folder = os.path.dirname(path)
        with open(path) as f:
            entries = json.load(f)
        seen = {}
        for e in entries:
            sub = e["file"]
            sub = sub if os.path.isabs(sub) else os.path.join(folder, sub)
            skip = frozenset(e.get("skipMaterials", []))
            if (sub, skip) not in seen:
                seen[(sub, skip)] = self._model(sub, skip)
            p, uv, nrm, mat = seen[(sub, skip)]
            shift = e.get("translation", ())
            shift = shift if len(shift) == 3 else (0.0, 0.0, 0.0)
            p = (p * np.float32(e.get("scale", 1.0))
                 + np.asarray(shift, np.float32))
            self.parts.append([p, uv, nrm, self._override(
                mat, e.get("materials") or {}, folder)])

    def _override(self, mat, block, folder):
        """New materials for the instance's overridden ones, in the order
        of their ids; the instance's triangles moved onto them."""
        if not block:
            return mat
        out = mat.copy()
        for mid in sorted(set(mat.tolist())):
            src = self.mats[mid]
            o = block.get(src.name)
            if not o:
                continue
            m = dataclasses.replace(src, maps=dict(src.maps))
            for k in ("Kd", "Ks"):
                if k in o:
                    setattr(m, k.lower(), tuple(float(x) for x in o[k]))
            for k in ("Ns", "Ni"):
                if k in o:
                    setattr(m, k.lower(), float(o[k]))
            for k, kind in (("map_Kd", "kd"), ("map_Ks", "ks"),
                            ("map_N", "n")):
                if k in o:
                    m.maps[kind] = o[k]
            if "shader" not in o:
                raise ValueError(f"{src.name}: an override without a shader")
            m.type = lobe(o["shader"], src.name)
            if "Ns" in o:
                m.alpha = roughness(m.ns)
            m.name = f"{src.name}@{len(self.mats)}"
            out[mat == mid] = self._add(m, folder)
        return out


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file (flat or run-length scanlines, -Y h +X w) as
    float32 [h, w, 3], the first scanline first: each texel's mantissas
    times 2^(exponent - 136)."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    pos = 0
    while True:
        end = raw.index(b"\n", pos)
        line, pos = raw[pos:end].split(), end + 1
        if line and line[0] in (b"-Y", b"+Y"):
            if line[0] != b"-Y" or line[2] != b"+X":
                raise ValueError(f"{path}: scanline order {line}")
            h, w = int(line[1]), int(line[3])
            break
    buf = np.frombuffer(raw, np.uint8, offset=pos)
    img = np.zeros((h, w, 4), np.uint8)
    at = 0
    for y in range(h):
        rle = (8 <= w <= 0x7FFF and buf[at] == 2 and buf[at + 1] == 2
               and (int(buf[at + 2]) << 8 | int(buf[at + 3])) == w)
        if not rle:
            img[y:] = buf[at:at + (h - y) * w * 4].reshape(h - y, w, 4)
            break
        at += 4
        for c in range(4):
            x = 0
            while x < w:
                k = int(buf[at])
                if k > 128:
                    img[y, x:x + k - 128, c] = buf[at + 1]
                    at, x = at + 2, x + k - 128
                else:
                    img[y, x:x + k, c] = buf[at + 1:at + 1 + k]
                    at, x = at + 1 + k, x + k
    e = img[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (img[..., :3] * scale[..., None]).astype(np.float32)
