"""Brute-force ray-triangle intersection: every ray against every
triangle, by the Moller-Trumbore test of the renderer's convention
(|det| >= 1e-12, u in [0, 1], v >= 0, u + v <= 1, t > 0), in blocks of
rays so that a block's [rays, triangles] temporaries stay small.

This is the reference's trace: it reads the triangles that the
benchmark's own loader made from the scene files, and no acceleration
structure at all, so it shares nothing with the program's tables or
kernels."""

from __future__ import annotations

import torch

EPSILON = 1e-12
INF = float("inf")


def _block_rows(n_tris: int, budget: int = 1 << 24) -> int:
    """Rays per block so that one [rays, triangles] temporary holds about
    ``budget`` elements."""
    return max(1, min(4096, budget // max(n_tris, 1)))


def _mt(o, d, tris, t_max):
    """One block: o, d [r, 3]; tris = (v0, e1, e2) each [m, 3]; t_max [r].
    Returns (t [r] with inf for a miss, tri [r] int64 with -1, u, v, any)
    where ``any`` is whether some triangle lies in (0, t_max)."""
    v0, e1, e2 = tris
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= EPSILON
    idet = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tx = o[:, 0:1] - v0[None, :, 0]
    ty = o[:, 1:2] - v0[None, :, 1]
    tz = o[:, 2:3] - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * idet
    del px, py, pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    del tx, ty, tz
    v = (dx * qx + dy * qy + dz * qz) * idet
    t = (e2x * qx + e2y * qy + e2z * qz) * idet
    del qx, qy, qz
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    ok &= t < t_max[:, None]
    t = torch.where(ok, t, torch.full_like(t, INF))
    tb, ib = t.min(dim=1)
    hit = torch.isfinite(tb)
    rows = torch.arange(t.shape[0], device=t.device)
    ub, vb = u[rows, ib], v[rows, ib]
    return tb, torch.where(hit, ib, -1), ub, vb, hit


def trace(o, d, tris, t_max=None, dtype=torch.float32):
    """Closest hit of each ray ``o, d`` [n, 3] below ``t_max`` [n]
    (default: unbounded) against ``tris`` = (v0, e1, e2) [m, 3]: returns
    (t, tri, u, v, hit), computed in ``dtype``."""
    n = o.shape[0]
    dev = o.device
    o, d = o.to(dtype), d.to(dtype)
    tris = tuple(a.to(dtype) for a in tris)
    if t_max is None:
        t_max = torch.full((n,), INF, dtype=dtype, device=dev)
    t_max = t_max.to(dtype)
    rows = _block_rows(tris[0].shape[0])
    out = [[], [], [], [], []]
    for s in range(0, n, rows):
        e = min(n, s + rows)
        for acc, x in zip(out, _mt(o[s:e], d[s:e], tris, t_max[s:e])):
            acc.append(x)
    return tuple(torch.cat(a) if a else torch.empty(0, device=dev)
                 for a in out)


def barycentrics(o, d, tris, tri, dtype=torch.float64):
    """The (u, v, t) of each ray ``o, d`` [n, 3] on its own triangle
    ``tri`` [n] (the Moller-Trumbore quantities, without the inside test),
    in ``dtype``."""
    v0, e1, e2 = (a[tri.clamp_min(0)].to(dtype) for a in tris)
    o, d = o.to(dtype), d.to(dtype)
    p = torch.cross(d, e2, dim=1)
    det = (e1 * p).sum(1)
    idet = 1.0 / torch.where(det.abs() >= EPSILON, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * p).sum(1) * idet
    q = torch.cross(tv, e1, dim=1)
    v = (d * q).sum(1) * idet
    t = (e2 * q).sum(1) * idet
    return u, v, t
