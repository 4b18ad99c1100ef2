"""Host-side material representation and BXDF-type inference (the port's
numpy copy of the reference package's scene/material.py).

Ports the reference's material model (src/geom.h:130-143) and, critically,
its MTL heuristics (src/scene.cpp:254-329): when no explicit ``shader`` tag is
present, the BXDF type is inferred from which of Kd/Ks/Kt/Ke are non-zero and
from Ni/Ns. The phong-exponent -> GGX-alpha remap (scene.cpp:13-16) is applied
to every loaded material.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from .. import bxdf_types as bx


def to_roughness(shininess: float) -> float:
    """Phong exponent -> Beckmann/GGX alpha (scene.cpp:13-16)."""
    return math.sqrt(2.0 / (2.0 + max(shininess, 0.0)))


@dataclasses.dataclass
class HostMaterial:
    Kd: tuple = (0.0, 0.0, 0.0)
    Ks: tuple = (0.0, 0.0, 0.0)
    Ke: tuple = (0.0, 0.0, 0.0)
    Kt: tuple = (0.0, 0.0, 0.0)
    Ns: float = 1.0          # phong exponent pre-remap; GGX alpha post-remap
    Ni: float = 1.0
    d: float = 1.0           # dissolve
    map_Kd: int = -1
    map_Ks: int = -1
    map_N: int = -1
    type: int = bx.BXDF_DIFFUSE
    name: str = ""


def default_material() -> HostMaterial:
    """Default material 0 (scene.cpp:18-30). Ns left un-remapped like the
    reference (it is never used: the type is diffuse)."""
    return HostMaterial(Kd=(0.64, 0.64, 0.64), Ni=1.8, Ns=700.0,
                        type=bx.BXDF_DIFFUSE, name="<default>")


def infer_type(m: HostMaterial, shader_set_ok: bool) -> int:
    """BXDF inference heuristics, bit-for-bit with scene.cpp:271-323."""
    t = m.type
    sum_kd = m.Kd[0] + m.Kd[1] + m.Kd[2]
    sum_ks = m.Ks[0] + m.Ks[1] + m.Ks[2]
    sum_kt = m.Kt[0] + m.Kt[1] + m.Kt[2]
    components = int(sum_kd > 0.0) + int(sum_ks > 0.0) + int(sum_kt > 0.0)

    if shader_set_ok:
        return t

    if (t == bx.BXDF_DIFFUSE and sum_kt > 0.0 and sum_kd < 1e-8 and
            (sum_ks < 1e-8 or (abs(sum_ks - sum_kt) < 0.01 and
                               abs(m.Kt[0] - m.Ks[0]) < 0.01 and
                               abs(m.Kt[1] - m.Ks[1]) < 0.01 and
                               abs(m.Kt[2] - m.Ks[2]) < 0.01))):
        t = bx.BXDF_IDEAL_DIELECTRIC
        m.Ks = tuple(m.Kt)

    if t == bx.BXDF_DIFFUSE and sum_ks > 0.0 and sum_kd < 1e-8 and sum_kt < 1e-8:
        t = bx.BXDF_GLOSSY

    if (t == bx.BXDF_DIFFUSE and sum_ks > 0.0 and sum_kd > 0.0 and
            m.Ni > 1.0 and m.Ns > 1.0 and sum_kt < 1e-8):
        t = bx.BXDF_GGX_ROUGH_REFLECTION

    if (t == bx.BXDF_DIFFUSE and sum_ks > 0.0 and sum_kt > 0.0 and
            m.Ni > 1.0 and m.Ns > 1.0 and sum_kd < 1e-8):
        t = bx.BXDF_GGX_ROUGH_DIELECTRIC

    if m.Ke[0] > 0.0 or m.Ke[1] > 0.0 or m.Ke[2] > 0.0:
        t = bx.BXDF_EMISSIVE

    if components > 1 and t == bx.BXDF_DIFFUSE:
        t = bx.BXDF_MIXED

    return t


def materials_to_soa(materials: List[HostMaterial], *, device):
    """Host material list -> device MaterialsSoA of tensors."""
    import torch
    from ..geom import MaterialsSoA
    from ..vec import Vec3

    def vcol(attr):
        a = torch.tensor(np.array([getattr(m, attr) for m in materials],
                                  np.float32), device=device)
        return Vec3(a[:, 0], a[:, 1], a[:, 2])

    def scol(attr, dtype=np.float32):
        return torch.tensor(np.array([getattr(m, attr) for m in materials],
                                     dtype), device=device)

    return MaterialsSoA(
        Kd=vcol("Kd"), Ks=vcol("Ks"), Ke=vcol("Ke"), Kt=vcol("Kt"),
        Ns=scol("Ns"), Ni=scol("Ni"), d=scol("d"),
        map_Kd=scol("map_Kd", np.int32), map_Ks=scol("map_Ks", np.int32),
        map_N=scol("map_N", np.int32), type=scol("type", np.int32))
