"""Structure-of-arrays 3-vector math on torch tensors.

``Vec3`` keeps each component as its own tensor (the reference's SoA
layout), so every operation is one elementwise pass over the batch.
Semantics mirror the reference's vector helpers (src/utils.cl).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @staticmethod
    def full(shape, value, device) -> "Vec3":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        a = torch.full(shape, value, dtype=torch.float32, device=device)
        return Vec3(a, a, a)

    @staticmethod
    def zeros(shape, device) -> "Vec3":
        return Vec3.full(shape, 0.0, device)

    @staticmethod
    def ones(shape, device) -> "Vec3":
        return Vec3.full(shape, 1.0, device)

    @staticmethod
    def of(x, y, z, device) -> "Vec3":
        """Three 0-dim float32 tensors (a broadcastable constant)."""
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Vec3(f(x), f(y), f(z))


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length(a: Vec3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3) -> Vec3:
    """Scale by rsqrt(|a|^2), as the reference (vec.py:111-118)."""
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), 1e-30))
    return a * inv


def where(cond, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
                torch.where(cond, a.z, b.z))


def reflect0(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection of incoming dir d about n (src/utils.cl:30-33)."""
    return d - n * (2.0 * dot(d, n))


def refract1(wi: Vec3, n: Vec3, eta, i_dot_n, cos_theta_t) -> Vec3:
    """Refraction given precomputed cosThetaT (src/utils.cl:61-64)."""
    return wi * eta + n * (eta * i_dot_n - cos_theta_t)


def is_zero(a: Vec3) -> torch.Tensor:
    return (a.x == 0.0) & (a.y == 0.0) & (a.z == 0.0)


def luminance(a: Vec3) -> torch.Tensor:
    """sRGB luminance (src/utils.cl:262-265)."""
    return 0.212671 * a.x + 0.715160 * a.y + 0.072169 * a.z
