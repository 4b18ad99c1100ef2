"""Postprocess: exposure, tonemapping, gamma (src/mk_postprocess.cl and
src/tonemap.cl). Operators: 0 = Linear, 1 = Reinhard, 2 = Uncharted 2
filmic, 3 = Raw (no gamma)."""

from __future__ import annotations

import torch

from ..vec import Vec3

GAMMA = 0.454545454545454545  # 1/2.2 (geom.h:12), applied in float32


def reinhard(c: Vec3) -> Vec3:
    return Vec3(c.x / (1.0 + c.x), c.y / (1.0 + c.y), c.z / (1.0 + c.z))


def _uc2_func(x):
    # tonemap.cl:8-19 with its baked constants
    A, B, CB, DE, DF, ExF = 0.22, 0.30, 0.03, 0.002, 0.06, 1.0 / 30.0
    return ((x * (A * x + CB) + DE) / (x * (A * x + B) + DF)) - ExF


def uncharted2(c: Vec3) -> Vec3:
    w = _uc2_func(torch.tensor(11.2, dtype=torch.float32,
                               device=c.x.device))
    f = lambda x: _uc2_func(2.0 * x) / w
    return Vec3(f(c.x), f(c.y), f(c.z))


def postprocess(color: Vec3, weight, exposure, tm_operator: int) -> Vec3:
    """mk_postprocess.cl:25-47: divide by sample count, exposure, tonemap,
    gamma (skipped for Raw)."""
    inv_w = torch.where(weight > 0.0, 1.0 / torch.clamp_min(weight, 1e-30),
                        1.0)
    c = color * inv_w * exposure
    if tm_operator == 1:
        c = reinhard(c)
    elif tm_operator == 2:
        c = uncharted2(c)
    if tm_operator == 3:
        return c
    gamma = torch.tensor(GAMMA, dtype=torch.float32, device=c.x.device)
    g = lambda x: torch.pow(torch.clamp_min(x, 0.0), gamma)
    return Vec3(g(c.x), g(c.y), g(c.z))
