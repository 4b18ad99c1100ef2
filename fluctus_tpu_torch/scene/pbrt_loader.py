"""PBRT v3 scene loader (the text format): the port's copy of the reference
package's scene/pbrt_loader.py, after what the original renderer takes
through ext/pbrt-parser (Scene::loadPBFModel, scene.cpp:505-813).

It reads triangle meshes (``Shape "trianglemesh"``, and ``"plymesh"``
through ``ply_loader``), the transforms (``Translate``, ``Scale``,
``Rotate``, ``LookAt``, ``Transform``, ``ConcatTransform``, ``Identity``,
in float64, normals through the inverse transpose), the attribute stack,
the camera (``LookAt`` + ``Camera``'s fov, left in
``scene.camera_override``), ``Texture "imagemap"`` and the materials,
mapped as the original renderer maps them (scene.cpp:727-812): matte ->
diffuse; plastic, substrate and uber -> glossy; glass -> ideal dielectric;
mirror -> ideal reflection; metal -> GGX rough reflection, with its
roughness conversion (convertRoughness, scene.cpp:719-724) and the
phong -> GGX remap. Binary ``.pbf`` files are not read.

Both packages must load a file to the same bits, so the reference's
quirks are kept, not fixed: ``ObjectInstance`` is skipped and an
``ObjectBegin`` body is emitted where it is defined; ``Include`` parses
its file with a fresh transform and material (and without the caller's
model transform); spheres, disks and curves are skipped, as the original
renderer skips them; a missing ``Include`` or ``plymesh`` file is skipped
without a word; a ``plymesh`` ignores the model transform. A malformed
number raises.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, NamedTuple

import numpy as np

from .. import bxdf_types as bx
from .material import HostMaterial, to_roughness


class PbrtCamera(NamedTuple):
    """The camera a ``.pbrt`` file carries: position, the view frame's
    direction, up and right axes, and the vertical fov in degrees."""
    pos: tuple
    dir: tuple
    up: tuple
    right: tuple
    fov: float


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


def _tokenize(path: str):
    with open(path, "r", errors="replace") as f:
        for line in f:
            h = line.find("#")
            if h >= 0:
                line = line[:h]
            for tok in _TOKEN_RE.findall(line):
                yield tok


class _Tokens:
    def __init__(self, gen):
        self._gen = gen
        self._peeked = None

    def peek(self):
        if self._peeked is None:
            self._peeked = next(self._gen, None)
        return self._peeked

    def next(self):
        t = self.peek()
        self._peeked = None
        return t


def _parse_params(toks: _Tokens) -> Dict[str, list]:
    """Parse '"type name" value-or-[values]' pairs until a non-quoted token."""
    params = {}
    while True:
        t = toks.peek()
        if t is None or not t.startswith('"'):
            return params
        decl = toks.next().strip('"')
        parts = decl.split()
        name = parts[-1]
        ptype = parts[0] if len(parts) > 1 else ""
        vals = []
        if toks.peek() == "[":
            toks.next()
            while toks.peek() not in ("]", None):
                vals.append(toks.next())
            toks.next()
        else:
            vals.append(toks.next())
        params[name] = (ptype, [v.strip('"') for v in vals])


def _floats(p, name, default=None):
    if name not in p:
        return default
    return [float(v) for v in p[name][1]]


def _ints(p, name, default=None):
    if name not in p:
        return default
    return [int(v) for v in p[name][1]]


def _str(p, name, default=None):
    if name not in p:
        return default
    return p[name][1][0]


# ---------------------------------------------------------------------------
# Transform stack
# ---------------------------------------------------------------------------

def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def _rotate(angle, x, y, z):
    a = math.radians(angle)
    v = np.array([x, y, z], float)
    v /= np.linalg.norm(v) or 1.0
    c, s = math.cos(a), math.sin(a)
    x, y, z = v
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4)
    m[:3, :3] = r
    return m


def _look_at(ex, ey, ez, lx, ly, lz, ux, uy, uz):
    eye = np.array([ex, ey, ez])
    look = np.array([lx, ly, lz])
    up = np.array([ux, uy, uz])
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    if np.linalg.norm(right) < 1e-9:
        right = np.array([1.0, 0, 0])
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


# ---------------------------------------------------------------------------
# Material mapping (scene.cpp:727-812)
# ---------------------------------------------------------------------------

def _convert_roughness(r, remap=True, ru=0.0, rv=0.0):
    res = r if r > 0.0 else 0.5 * (ru + rv)
    return (1.0 - res) * (5000.0 if remap else 1.0)


def _map_material(mtype: str, p: Dict, scene) -> HostMaterial:
    m = HostMaterial(Kd=(0.64, 0.64, 0.64), Ni=1.8, Ns=700.0,
                     type=bx.BXDF_DIFFUSE)

    def tex_or_color(name, default):
        v = p.get(name)
        if v is None:
            return default, -1
        ptype, vals = v
        if ptype == "texture":
            ti = scene.pbrt_textures.get(vals[0], -1)
            return default, ti
        vals = [float(x) for x in vals]
        if len(vals) == 1:
            vals = vals * 3
        return tuple(vals[:3]), -1

    remap = _str(p, "remaproughness", "true") != "false"
    rough = _floats(p, "roughness", [0.0])[0]
    ur = _floats(p, "uroughness", [0.0])[0]
    vr = _floats(p, "vroughness", [0.0])[0]

    if mtype == "matte":
        m.type = bx.BXDF_DIFFUSE
        m.Kd, m.map_Kd = tex_or_color("Kd", (0.5, 0.5, 0.5))
    elif mtype in ("plastic", "substrate", "uber"):
        m.type = bx.BXDF_GLOSSY
        m.Kd, m.map_Kd = tex_or_color("Kd", (0.25, 0.25, 0.25))
        m.Ks, m.map_Ks = tex_or_color("Ks", (0.25, 0.25, 0.25))
        m.Ns = _convert_roughness(rough, remap, ur, vr)
        m.Ni = _floats(p, "index", [1.5])[0] if mtype == "uber" else 1.5
    elif mtype == "glass":
        m.type = bx.BXDF_IDEAL_DIELECTRIC
        kt, _ = tex_or_color("Kt", (1.0, 1.0, 1.0))
        m.Ks = kt  # Ks treated as transmissivity (scene.cpp:779)
        idx = _floats(p, "index", [1.5])[0]
        m.Ni = idx if idx > 0.0 else 1.5
    elif mtype == "mirror":
        m.type = bx.BXDF_IDEAL_REFLECTION
        m.Ks, _ = tex_or_color("Kr", (0.9, 0.9, 0.9))
    elif mtype == "metal":
        m.type = bx.BXDF_GGX_ROUGH_REFLECTION
        eta = _floats(p, "eta", [0.2, 0.9, 1.4])
        m.Ni = sum(eta[:3]) / 3.0
        m.Ks, m.map_Ks = tex_or_color("k", (3.9, 2.4, 2.1))
        m.Ns = _convert_roughness(rough, remap, ur, vr)
    # else: keep defaults (unhandled material types)

    m.Ns = to_roughness(m.Ns)  # scene.cpp:808
    m.name = mtype
    return m


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

# statements skipped with their parameter lists: after one name token, and
# without one
_SKIP_NAMED = ("AreaLightSource", "LightSource", "MakeNamedMedium")
_SKIP_PARAMS = ("Film", "Sampler", "Integrator", "PixelFilter",
                "Accelerator")


def load_pbrt(path: str, scene, transform=None):
    """Append the file's meshes and materials to ``scene``; positions go
    through ``transform`` (a ``ModelTransform``) after the file's own.
    Texture names resolve through ``scene.pbrt_textures``, shared by every
    file loaded into the scene (as the reference's). Sets
    ``scene.camera_override`` when the file has a ``LookAt``."""
    folder = os.path.dirname(path)
    toks = _Tokens(_tokenize(path))

    ctm = np.eye(4)
    stack = []
    cur_mat = 0  # default material
    named_materials: Dict[str, int] = {}
    cam_params = None
    cam_to_world = None

    def mat_index(hm: HostMaterial) -> int:
        scene.add_material(hm)
        return len(scene.materials) - 1

    while True:
        t = toks.next()
        if t is None:
            break
        if t == "Include":
            sub = os.path.join(folder, toks.next().strip('"'))
            if os.path.exists(sub):
                # a fresh transform and material (the reference's
                # _load_into passes its arguments on to no one)
                load_pbrt(sub, scene)
            continue
        if t == "Translate":
            ctm = ctm @ _translate(*[float(toks.next()) for _ in range(3)])
        elif t == "Scale":
            ctm = ctm @ _scale(*[float(toks.next()) for _ in range(3)])
        elif t == "Rotate":
            ctm = ctm @ _rotate(*[float(toks.next()) for _ in range(4)])
        elif t == "LookAt":
            vals = [float(toks.next()) for _ in range(9)]
            cam_to_world = _look_at(*vals)      # world-to-cam inverse below
            ctm = ctm @ np.linalg.inv(cam_to_world)
        elif t in ("Transform", "ConcatTransform"):
            if toks.peek() == "[":
                toks.next()
            vals = []
            while toks.peek() not in ("]", None) and len(vals) < 16:
                vals.append(float(toks.next()))
            if toks.peek() == "]":
                toks.next()
            m = np.array(vals, float).reshape(4, 4).T  # column-major input
            ctm = m if t == "Transform" else ctm @ m
        elif t == "Identity":
            ctm = np.eye(4)
        elif t in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
            stack.append((ctm.copy(), cur_mat))
            if t == "ObjectBegin":
                toks.next()  # name
        elif t in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if stack:
                ctm, cur_mat = stack.pop()
        elif t == "Camera":
            ctype = toks.next().strip('"')
            cam_params = _parse_params(toks)
            cam_params["_type"] = ("", [ctype])
        elif t == "Texture":
            name = toks.next().strip('"')
            toks.next()  # value type
            tclass = toks.next().strip('"')
            p = _parse_params(toks)
            if tclass == "imagemap":
                fn = _str(p, "filename", "")
                idx = scene.try_import_texture(folder, fn)
                scene.pbrt_textures[name] = idx
            else:
                scene.pbrt_textures[name] = -1
        elif t == "Material":
            mtype = toks.next().strip('"')
            p = _parse_params(toks)
            cur_mat = mat_index(_map_material(mtype, p, scene))
        elif t == "MakeNamedMaterial":
            name = toks.next().strip('"')
            p = _parse_params(toks)
            mtype = _str(p, "type", "matte")
            named_materials[name] = mat_index(
                _map_material(mtype, p, scene))
        elif t == "NamedMaterial":
            name = toks.next().strip('"')
            cur_mat = named_materials.get(name, 0)
        elif t == "Shape":
            stype = toks.next().strip('"')
            p = _parse_params(toks)
            if stype == "trianglemesh":
                _emit_mesh(scene, p, ctm, cur_mat, transform)
            elif stype == "plymesh":
                fn = _str(p, "filename", "")
                sub = os.path.join(folder, fn)
                if os.path.exists(sub):
                    from .ply_loader import load_ply
                    before = scene.num_triangles
                    load_ply(sub, scene, None)
                    # retrofit transform + material on the appended chunk
                    chunk = scene._tri_chunks[-1]
                    pverts = _apply_ctm(chunk[0], ctm)
                    nverts = _apply_ctm_normal(chunk[1], ctm)
                    scene._tri_chunks[-1] = (
                        pverts, nverts, chunk[2],
                        np.full(len(chunk[3]), cur_mat, np.int32))
            # spheres/disks/curves unsupported (reference skips them too,
            # scene.cpp:614-627)
        elif t == "WorldBegin":
            ctm = np.eye(4)   # WorldBegin resets the CTM (pbrt semantics)
            stack.clear()
        elif t == "ObjectInstance":
            toks.next()     # the name; instances are not emitted
        elif t in _SKIP_NAMED:
            toks.next()     # the light class or the medium name
            _parse_params(toks)
        elif t in _SKIP_PARAMS:
            _parse_params(toks)
        # anything else (WorldEnd, ReverseOrientation, MediumInterface,
        # unknown tokens) is skipped one token at a time

    # camera import (scene.cpp:690-705)
    if cam_to_world is not None:
        scene.camera_override = PbrtCamera(
            pos=tuple(cam_to_world[:3, 3]), dir=tuple(cam_to_world[:3, 2]),
            up=tuple(cam_to_world[:3, 1]), right=tuple(cam_to_world[:3, 0]),
            fov=(_floats(cam_params, "fov", [60.0])[0] if cam_params
                 else 60.0))


def _apply_ctm(pts, ctm):
    """pts [M,3,3] -> transformed."""
    flat = pts.reshape(-1, 3)
    out = flat @ ctm[:3, :3].T + ctm[:3, 3]
    return out.reshape(pts.shape).astype(np.float32)


def _apply_ctm_normal(nrm, ctm):
    it = np.linalg.inv(ctm[:3, :3]).T
    flat = nrm.reshape(-1, 3) @ it.T
    norm = np.linalg.norm(flat, axis=1, keepdims=True)
    flat = flat / np.maximum(norm, 1e-20)
    return flat.reshape(nrm.shape).astype(np.float32)


def _emit_mesh(scene, p, ctm, cur_mat, transform):
    P = _floats(p, "P")
    I = _ints(p, "indices")
    if P is None or I is None:
        return
    P = np.array(P, np.float32).reshape(-1, 3)
    I = np.array(I, np.int64).reshape(-1, 3)
    N = _floats(p, "N")
    N = np.array(N, np.float32).reshape(-1, 3) if N else None
    UV = _floats(p, "uv") or _floats(p, "st")
    UV = np.array(UV, np.float32).reshape(-1, 2) if UV else None

    pts = P[I]                                 # [M,3,3]
    pts = _apply_ctm(pts, ctm)
    if transform is not None:
        pts = transform.apply(pts)
    if N is not None:
        nrm = _apply_ctm_normal(N[I], ctm)
    else:
        flat = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
        flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-20)
        nrm = np.repeat(flat[:, None, :], 3, axis=1)
    uv = UV[I] if UV is not None else np.zeros((len(I), 3, 2), np.float32)
    scene.append_triangles(pts, nrm, uv,
                           np.full(len(I), cur_mat, np.int32))
