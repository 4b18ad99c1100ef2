"""Sampling primitives shared by the BSDFs and the camera (src/utils.cl:
ortho basis 72-80, disk 96-108, cosine hemisphere 111-137, area to solid
angle 222-225, area-light point 251-259). SoA batches, explicit seeds."""

from __future__ import annotations

import torch

from .rng import rand
from .vec import Vec3, dot

PI = 3.14159265358979323846
INV_PI = 0.3183098861837907
TWO_PI = 6.2831853071795864


def make_ortho_basis(n: Vec3):
    """Branchless orthonormal basis (Duff et al., src/utils.cl:72-80)."""
    sign = torch.where(n.z > 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def uniform_sample_disk(seed):
    """Uniform disk point (src/utils.cl:96-108)."""
    u1, seed = rand(seed)
    u2, seed = rand(seed)
    sqrt_r = torch.sqrt(u1)
    th = TWO_PI * u2
    return sqrt_r * torch.cos(th), sqrt_r * torch.sin(th), seed


def cos_sample_hemisphere_uv(n: Vec3, u1, u2):
    """Cosine-weighted hemisphere sample around n from explicit uniforms.
    Returns (dir, pdf) with pdf = cos(theta)/pi."""
    r1 = TWO_PI * u1
    r2s = torch.sqrt(u2)
    u, v = make_ortho_basis(n)
    d = (u * (torch.cos(r1) * r2s)
         + v * (torch.sin(r1) * r2s)
         + n * torch.sqrt(torch.clamp_min(1.0 - u2, 0.0)))
    pdf = dot(n, d) * INV_PI
    return d, pdf


def pdf_area_to_solid_angle(pdf, dist, cosine):
    """Area measure -> solid angle measure (src/utils.cl:222-225)."""
    return pdf * (dist * dist) / torch.abs(cosine)


def sample_area_light(light, seed):
    """Uniform point on the rectangular area light (src/utils.cl:251-259).
    Returns (pdf_area, point, seed)."""
    pdf = 1.0 / (4.0 * light.size_x * light.size_y)
    r1, seed = rand(seed)
    r2, seed = rand(seed)
    p = (light.pos
         + light.right * ((r1 + r1 - 1.0) * light.size_x)
         + light.up * ((r2 + r2 - 1.0) * light.size_y))
    return pdf, p, seed
