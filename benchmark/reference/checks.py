"""The numbers that decide ``correct``: the program's last captured
segment (and a frame) against the reference.

The reference follows the program one segment at a time, from the
program's own pool at the start of that segment, on a sample of lanes
drawn from the seed:

- ``trace_bad``: the share of sampled rays whose outcome differs from
  the brute-force trace of the reference's own triangles: the extension
  ray's kind (miss, area light, triangle) and distance, and the pending
  shadow ray's occlusion.
- ``resolve_bad``: the share of sampled triangle hits whose hit record
  (distance, normal, uv, material) differs from the reference's, worked
  out on the hit triangle from the scene files.
- ``shade_bad``: the share of sampled lanes whose outcome of the
  segment's logic (splat record, new path state, next-event ray, the
  material's sample, the camera ray of a new path) differs from the
  reference's (``lanes``, in float64), on the program's hit record and
  the reference's materials, textures and env map.
- ``splat_err``: the largest relative gap, over every pixel, between the
  film after the segment and the film before it plus the reference's
  scatter of the segment's splat records.
- ``film_bad``: pixels with a film value that is not finite, or a
  weight that is negative or not whole.
- ``frame_bad``: the share of a frame file's 8-bit values that differ
  from the reference's tonemap (in float64) of the film it shows.

The control: ``segment_numbers(..., control=torch.bfloat16)`` (and each
traffic kind's ``numbers``) puts the reference, computed in that lower
precision, in the program's place at every stage."""

from __future__ import annotations

import struct
import zlib
from types import SimpleNamespace

import numpy as np
import torch

from . import intersect
from .lanes import intersect_area_light, segment_lanes
from .shading import tonemap

T_RTOL, T_ATOL = 1e-4, 1e-6       # hit distance
N_ATOL = 1e-3                     # hit normal, per component
UV_RTOL = 1e-4                    # hit uv, relative to 1 + |uv|
S_RTOL, S_ATOL = 1e-3, 1e-5       # the logic's float outputs
F_FLOOR = 1e-3                    # film values: relative gap's floor

POOL_VECS = ("orig", "dir", "shadow_orig", "shadow_dir", "T", "Ei",
             "last_bsdf", "last_emission", "last_T")
POOL_SCALARS = ("last_pdf_w", "path_len", "seed", "last_specular",
                "shadow_pending", "pixel_index", "last_pdf_direct",
                "last_pdf_implicit", "last_cos_th", "last_light_pick",
                "shadow_len")
EXACT = ("path_len", "seed", "last_specular", "shadow_pending")


def sample_lanes(n: int, k: int, seed: int, device):
    """``k`` distinct lanes of ``n``, drawn from ``seed``, in lane order."""
    g = torch.Generator().manual_seed(seed & ((1 << 63) - 1))
    idx = torch.randperm(n, generator=g)[:min(k, n)]
    return torch.sort(idx).values.to(device)


def vec(v, idx):
    """The lanes ``idx`` of a vector field (three tensors) as [k, 3]."""
    return torch.stack([a[idx] for a in v], 1)


def gather_pool(pool, idx):
    """The lanes ``idx`` of the program's pool: vectors [k, 3]."""
    ns = SimpleNamespace()
    for f in POOL_VECS:
        setattr(ns, f, vec(getattr(pool, f), idx))
    for f in POOL_SCALARS:
        setattr(ns, f, getattr(pool, f)[idx])
    return ns


def _close(a, b, rtol, atol):
    a, b = a.double(), b.double()
    return (a - b).abs() <= rtol * b.abs() + atol


# -- the trace ---------------------------------------------------------------

def _light(light, dtype):
    return SimpleNamespace(**{k: (v.to(dtype) if torch.is_tensor(v) else v)
                              for k, v in vars(light).items()})


def trace_outcome(ref, o, d, light, check_light, dtype):
    """(kind, t) of each extension ray: 0 miss, 1 area light, 2 triangle;
    and the triangle index."""
    t, tri, _, _, hit = intersect.trace(o, d, ref.tris, dtype=dtype)
    kind = torch.where(hit, 2, 0)
    if light is not None and check_light:
        lt_prev = torch.where(hit, t, float("inf"))
        lh, lt = intersect_area_light(o.to(dtype), d.to(dtype),
                                      _light(light, dtype), lt_prev)
        kind = torch.where(lh, 1, kind)
        t = torch.where(lh, lt.to(t.dtype), t)
    return kind, t.double(), tri


def shadow_outcome(ref, o, d, t_max, light, dtype):
    """Whether each shadow ray meets a triangle, or the light's body,
    before ``t_max``."""
    _, _, _, _, occ = intersect.trace(o, d, ref.tris, t_max=t_max,
                                      dtype=dtype)
    if light is not None:
        lh, _ = intersect_area_light(o.to(dtype), d.to(dtype),
                                     _light(light, dtype), t_max.to(dtype))
        occ = occ | lh
    return occ


def program_kind(hit):
    return torch.where(hit.area_light_hit > 0, 1,
                       torch.where(hit.i >= 0, 2, 0))


def trace_compare(kind_p, t_p, occ_p, kind_r, t_r, occ_r, pending):
    """Per-lane agreement of the extension ray, and of the pending shadow
    rays; returns (bad rays, rays compared, extension agreement)."""
    same_t = _close(t_p, t_r, T_RTOL, T_ATOL) | (kind_r == 0)
    ext_ok = (kind_p == kind_r) & same_t
    sh_ok = (occ_p == occ_r) | ~pending
    bad = int((~ext_ok).sum()) + int((~sh_ok).sum())
    return bad, int(ext_ok.numel() + pending.sum()), ext_ok


# -- the hit record ---------------------------------------------------------

def hit_record(ref, o, d, tri, dtype):
    """Normal, uv and material of each ray's hit on triangle ``tri``,
    from the reference's triangles (barycentrics in ``dtype``)."""
    u, v, t = intersect.barycentrics(o, d, ref.tris, tri, dtype=dtype)
    w = 1.0 - u - v
    safe = tri.clamp_min(0).long()
    nv = ref.normals[safe].to(dtype)
    tv = ref.uvs[safe].to(dtype)
    bary = lambda a: a[:, 0] * w[:, None] + a[:, 1] * u[:, None] \
        + a[:, 2] * v[:, None]
    n = bary(nv)
    n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-30)
    uv = bary(tv)
    return n, uv, ref.mat_id[safe], t


def resolve_compare(n_p, uv_p, mat_p, t_p, n_r, uv_r, mat_r, t_r):
    ok = (n_p.double() - n_r.double()).abs().max(dim=1).values <= N_ATOL
    ok &= _close(t_p, t_r, T_RTOL, T_ATOL)
    ok &= ((uv_p.double() - uv_r.double()).abs()
           <= UV_RTOL * (1.0 + uv_r.double().abs())).all(dim=1)
    ok &= mat_p == mat_r
    return ok


# -- the logic ---------------------------------------------------------------

def shade_compare(out, pool1, data, pixel_ok):
    """Per-lane agreement of the reference's segment outcome ``out`` with
    the program's new pool ``pool1`` (gathered lanes), its splat record
    ``data`` [4, k] and whether each ended lane's new pixel lies in its
    group's ring (``pixel_ok``)."""
    ok = pixel_ok.clone()
    ok &= (data[3] > 0.5) == out.splat
    ok &= _close(data[:3].T, out.splat_rgb, S_RTOL, S_ATOL).all(-1)
    for f in POOL_VECS:
        ok &= _close(getattr(pool1, f), getattr(out, f), S_RTOL,
                     S_ATOL).all(-1)
    for f in POOL_SCALARS:
        if f == "pixel_index":
            continue
        a, b = getattr(pool1, f), getattr(out, f)
        if f in EXACT:
            ok &= a.to(torch.int64) == b.to(torch.int64)
        else:
            ok &= _close(a, b, S_RTOL, S_ATOL)
    return ok


# -- the film ---------------------------------------------------------------

def ring_pixels(local_col, groups: int, pk: int):
    """Film index of each lane's splat record: its group's block of the
    padded film, at the record's local column (-1: no splat)."""
    n = local_col.shape[0]
    g = torch.arange(n, device=local_col.device) // (n // groups)
    return torch.where(local_col >= 0, g * pk + local_col.long(), -1)


def splat_reference(film0, local_col, data, groups, pk, dtype):
    """The film after one segment's splat: ``film0`` [4, P] plus each
    record of ``data`` [4, n] at its pixel, summed in ``dtype``."""
    pix = ring_pixels(local_col, groups, pk)
    take = pix >= 0
    acc = film0.to(dtype).clone()
    acc.index_add_(1, pix[take], data[:, take].to(dtype))
    return acc


def splat_error(film1, ref):
    a, b = film1.double(), ref.double()
    return float(((a - b).abs() / (b.abs() + F_FLOOR)).max()) \
        if a.numel() else 0.0


def film_bad(film):
    """Pixels with a non-finite value or a negative or fractional
    weight."""
    w = film[3]
    bad = ~torch.isfinite(film).all(dim=0) | (w < 0) | (w != torch.round(w))
    return int(bad.sum())


# -- the frame ----------------------------------------------------------------

def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG without interlace, filter type 0 on every row (as
    the renderer writes it), as [H, W, 3] uint8."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, b""
    w = h = 0
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError(f"{path}: not 8-bit RGB")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def frame_levels(color, weight, width, height, exposure, tm_operator,
                 dtype):
    """The 8-bit frame of a film (bottom scanline first), by the
    reference's tonemap and gamma, quantised to the nearest level,
    computed in ``dtype``."""
    c = torch.stack([a.to(dtype) for a in color], 1)
    rgb = tonemap(c, weight.to(dtype), exposure, tm_operator)
    arr = rgb.float().cpu().numpy()
    arr = np.clip(arr.reshape(height, width, 3)[::-1], 0.0, 1.0)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def frame_bad(levels_p: np.ndarray, levels_r: np.ndarray) -> float:
    if levels_p.shape != levels_r.shape:
        return 1.0
    return float((levels_p != levels_r).mean())


# -- one segment, all numbers ---------------------------------------------------

def segment_numbers(seg, ref, cfg, k, seed, dtype=torch.float32,
                    control=None):
    """``trace_bad``, ``resolve_bad``, ``shade_bad`` and ``splat_err`` of
    the captured segment ``seg`` (see ``capture.Segment``) on ``k`` lanes
    drawn from ``seed``: the trace in ``dtype``, the hit record, the
    logic and the splat in float64. With ``control`` (a lower dtype) the
    reference computed in it takes the program's place at every
    stage."""
    dev = ref.device
    pool0, pool1 = seg.pool0, seg.pool1
    n = pool0.seed.shape[0]
    idx = sample_lanes(n, k, seed, dev)
    p0 = gather_pool(pool0, idx)
    params = seg.ref_params
    light = params.light
    # the trace
    kind_r, t_r, _ = trace_outcome(ref, p0.orig, p0.dir, light,
                                   cfg.sample_impl, dtype)
    pending = p0.shadow_pending
    tmax = torch.where(pending, p0.shadow_len, 0.0)
    occ_r = shadow_outcome(ref, p0.shadow_orig, p0.shadow_dir, tmax, light,
                           dtype)
    if control is None:
        hit = seg.hit
        kind_p = program_kind(hit)[idx]
        t_p = hit.t[idx].double()
        occ_p = seg.occluded[idx]
        tri_p = hit.i[idx]
    else:
        kind_p, t_p, tri_p = trace_outcome(ref, p0.orig, p0.dir, light,
                                           cfg.sample_impl, control)
        occ_p = shadow_outcome(ref, p0.shadow_orig, p0.shadow_dir, tmax,
                               light, control)
    bad, rays, ext_ok = trace_compare(kind_p, t_p, occ_p, kind_r, t_r,
                                      occ_r, pending)
    out = dict(trace_bad=bad / max(rays, 1))
    sh_ok = (occ_p == occ_r) | ~pending

    # the hit record, on the program's own triangle, wherever both sides
    # report a triangle (a lane whose distance differs still has a record)
    tri_lanes = (kind_p == 2) & (kind_r == 2)
    n_r, uv_r, mat_r, t_own = hit_record(ref, p0.orig, p0.dir, tri_p,
                                         torch.float64)
    if control is None:
        hit = seg.hit
        n_p = vec(hit.N, idx)
        uv_p = torch.stack([hit.uv_u[idx], hit.uv_v[idx]], 1)
        mat_p = hit.mat_id[idx]
        P_p = vec(hit.P, idx)
    else:
        n_p, uv_p, mat_p, _ = hit_record(ref, p0.orig, p0.dir, tri_p,
                                         control)
        P_p = p0.orig + p0.dir * t_p.to(p0.dir.dtype)[:, None]
    rec_ok = resolve_compare(n_p, uv_p, mat_p, t_p, n_r, uv_r, mat_r, t_own)
    out["resolve_bad"] = float((~rec_ok[tri_lanes]).float().mean()) \
        if tri_lanes.any() else 0.0

    # the logic, on the program's hit record and the reference's scene
    keep = ext_ok & sh_ok & (rec_ok | (kind_r != 2))
    light_hit = kind_p == 1
    hit_l = SimpleNamespace(
        P=P_p, N=n_p, u=uv_p[:, 0], v=uv_p[:, 1],
        i=torch.where(light_hit, 0, tri_p.long()), light=light_hit,
        mat_id=torch.where(kind_p == 2, mat_r.long(),
                           torch.where(light_hit, 0, -1)))
    true_pix = seg.true_pixel(pool1.pixel_index[idx])
    r_out = segment_lanes(p0, hit_l, occ_p, true_pix, ref, params, cfg,
                          torch.float64)
    if control is None:
        p1 = gather_pool(pool1, idx)
        data = seg.splat_data[:, idx]
    else:
        p1 = segment_lanes(p0, hit_l, occ_p, true_pix, ref, params, cfg,
                           control)
        data = torch.cat([p1.splat_rgb.T, p1.splat[None].to(control)])
    lane_ok = shade_compare(r_out, p1, data, seg.pixel_ok(idx))
    out["shade_bad"] = float((~lane_ok[keep]).float().mean()) \
        if keep.any() else 1.0

    # the film splat, over every pixel
    splat = lambda dt: splat_reference(seg.film0, seg.splat_local,
                                       seg.splat_data, seg.groups, seg.pk,
                                       dt)
    ref_film = splat(torch.float64)
    out["splat_err"] = splat_error(seg.film1 if control is None
                                   else splat(control), ref_film)
    return out
