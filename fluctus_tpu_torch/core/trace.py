"""Extension and shadow tracing with the cluster tables, the winner
resolve, the implicit area-light intersection, and the conversion of the
resolve matrix into hit records and shading parameters (the reference
package's core/trace.py, MXU raw-hit path, wf_extrays.cl:16-35 and
wf_shadowrays.cl:27-33): the wavefront's shared-order pair trace
(``trace_pair``) and the single-set entry points (``trace_extension_raw``,
``trace_extension``, ``trace_shadow``) of the microkernel integrator, the
pick and the wavefront with ``flags.SORT_RAYS`` off; and the normal
mapping of the hits (``tangent_space_normal``, trace.py:237-270)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel import mxu_trace as mt
from ..bsdf import ShadingParams
from ..envmap import EnvMapTables
from ..geom import AreaLight, Hit
from ..scene.texture import TextureAtlas
from ..texture_fetch import mat_get_float3
from ..vec import Vec3, dot, normalize, where as vwhere

F32_MAX = 3.4028235e38


class DeviceScene(NamedTuple):
    """Device-resident scene data: the cluster tables, the static OR of
    the BXDF type bits present, the env map's tables (None without one),
    the texture atlas (None or count 0 without textures) and, when a
    material has a normal map, ``tri_frames`` (``make_tri_frames``): the
    part of the reference's TrianglesDevice that normal mapping reads."""
    mxu: mt.MXUSceneT
    material_types: int
    env: Optional[EnvMapTables] = None
    atlas: Optional[TextureAtlas] = None
    tri_frames: Optional[torch.Tensor] = None


def make_tri_frames(p, uv, *, device) -> torch.Tensor:
    """[12, M] float32 rows from the triangle arrays p [M, 3, 3] and uv
    [M, 3, 2], column i for original triangle i: e1 = p1 - p0 and
    e2 = p2 - p0 (x, y, z each, in float32 as the reference's
    TrianglesDevice.from_arrays), then t0u, t0v, t1u, t1v, t2u, t2v."""
    p = np.asarray(p, np.float32)
    uv = np.asarray(uv, np.float32)
    rows = np.concatenate([(p[:, 1] - p[:, 0]).T, (p[:, 2] - p[:, 0]).T,
                           uv.reshape(-1, 6).T], axis=0)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def intersect_area_light(orig: Vec3, d: Vec3, light: AreaLight, t_prev):
    """Quad light intersection for implicit hits (intersect.cl:124-155).
    Returns (hit_mask, t). Backside hits rejected."""
    denom = dot(d, light.N)
    facing = denom < 0.0
    t = dot(light.pos - orig, light.N) / torch.where(denom == 0.0, 1.0,
                                                     denom)
    p = orig + d * t
    rel = p - light.pos
    lx = dot(rel, light.right)
    ly = dot(rel, light.up)
    inside = (torch.abs(lx) <= light.size_x) & (torch.abs(ly) <= light.size_y)
    hit = facing & (denom != 0.0) & inside & (t > 0.0) & (t < t_prev)
    return hit, t


def shading_from_attrs(row, col, tex_meta: bool = False) -> ShadingParams:
    """ShadingParams from the winner-resolve SoA matrix [ATTR_COLS, n].
    With ``tex_meta`` (tables that bake the atlas descriptors) each map's
    (off, w, h) comes from its rows: w = floor(wh / 4096), h the rest."""
    g = lambda c: row[c]
    v3 = lambda c: Vec3(row[c], row[c + 1], row[c + 2])
    valid = col >= 0
    i32 = torch.int32
    rint = lambda c: torch.where(valid, torch.round(g(c)).to(i32), -1)

    def meta(wh_col, off_col):
        if not tex_meta:
            return None
        wh = g(wh_col)
        w = torch.floor(wh * (1.0 / 4096.0))
        h = wh - w * 4096.0
        return ((g(off_col) + 0.5).to(i32), (w + 0.5).to(i32),
                (h + 0.5).to(i32))

    return ShadingParams(
        Kd=v3(mt.ATTR_KD), Ks=v3(mt.ATTR_KS), Ke=v3(mt.ATTR_KE),
        Kt=v3(mt.ATTR_KT), alpha=g(mt.ATTR_NS), Ni=g(mt.ATTR_NI),
        d=g(mt.ATTR_D),
        type=torch.where(valid, (g(mt.ATTR_TYPE) + 0.5).to(i32), 0),
        map_N=rint(mt.ATTR_MAP_N), map_Kd=rint(mt.ATTR_MAP_KD),
        map_Ks=rint(mt.ATTR_MAP_KS),
        kd_meta=meta(mt.ATTR_TKD_WH, mt.ATTR_TKD_OFF),
        ks_meta=meta(mt.ATTR_TKS_WH, mt.ATTR_TKS_OFF),
        n_meta=meta(mt.ATTR_TN_WH, mt.ATTR_TN_OFF))


def trace_extension_raw(orig: Vec3, d: Vec3, scene: DeviceScene):
    """Closest hit without the resolve: (t, winner col) of one ray set
    (trace.py:118-140) — sorted when ``flags.SORT_RAYS``, else the
    rays-on-sublanes trace (K9) in lane order, which slim tables refuse."""
    n = orig.x.shape[0]
    rt = mt.RAY_TILE
    o4, d4, tmax_col = mt._ray_inputs(orig, d, scene.mxu, None, rt)
    t2, col2 = mt._single_trace(o4, d4, tmax_col, scene.mxu, False, rt,
                                const_tmax=True)
    return t2[:n, 0], col2[:n, 0]


def has_resolve_tables(scene: DeviceScene) -> bool:
    """Whether the tables can resolve a winner column (the f32 ``attrs`` or
    the B16 table), the reference's test before its raw-hit path
    (trace.py:155-156, integrator_wf.py:294-296)."""
    return scene.mxu.attrs is not None or scene.mxu.b16r is not None


def trace_extension(orig: Vec3, d: Vec3, scene: DeviceScene,
                    area_light: Optional[AreaLight], check_area_light,
                    want_shading: bool = False, raw=None):
    """Closest hit + optional implicit area-light quad (wf_extrays.cl:
    26-29): the winner resolve of ``raw`` = (t, col) from an earlier trace,
    or of ``trace_extension_raw`` when raw is None. check_area_light: bool
    (or bool tensor) gating the light (sampleImpl && useAreaLight).
    Returns Hit, or (Hit, ShadingParams) when want_shading. Tables that
    can resolve nothing take the reference's third branch
    (``closest_hit_mxu_full`` + ``reconstruct_hit`` over the triangle
    arrays, trace.py:178-181), which is not ported, and raise."""
    if not has_resolve_tables(scene):
        raise NotImplementedError(
            "trace_extension without attrs or B16 tables: "
            "closest_hit_mxu_full + reconstruct_hit over TrianglesDevice "
            "is not ported")
    t, col = raw if raw is not None else trace_extension_raw(orig, d, scene)
    row = mt.resolve_hits_mxu(orig, d, t, col, scene.mxu)
    t = torch.where(col >= 0, row[mt.ATTR_HITT], t)
    nrm = Vec3(row[mt.ATTR_N], row[mt.ATTR_N + 1], row[mt.ATTR_N + 2])
    mat_id = torch.where(col >= 0,
                         (row[mt.ATTR_MAT] + 0.5).to(torch.int32), -1)
    tri = torch.where(col >= 0, (row[mt.ATTR_TRI] + 0.5).to(torch.int32), -1)
    hit = Hit(P=orig + d * t, N=normalize(nrm),
              uv_u=row[mt.ATTR_UV], uv_v=row[mt.ATTR_UV + 1],
              t=t, i=tri, area_light_hit=torch.zeros_like(tri),
              mat_id=mat_id)
    sp = (shading_from_attrs(row, col, scene.mxu.has_tex_meta)
          if want_shading else None)
    if area_light is None:
        return (hit, sp) if want_shading else hit
    l_hit, l_t = intersect_area_light(orig, d, area_light, hit.t)
    l_hit = l_hit & check_area_light
    shp = t.shape
    hit = Hit(
        P=vwhere(l_hit, orig + d * l_t, hit.P),
        N=vwhere(l_hit, Vec3(area_light.N.x.expand(shp),
                             area_light.N.y.expand(shp),
                             area_light.N.z.expand(shp)), hit.N),
        uv_u=hit.uv_u, uv_v=hit.uv_v,
        t=torch.where(l_hit, l_t, hit.t),
        i=torch.where(l_hit, 0, hit.i),            # intersect.cl:152
        area_light_hit=torch.where(l_hit, 1, hit.area_light_hit),
        mat_id=torch.where(l_hit, 0, hit.mat_id))  # intersect.cl:153
    return (hit, sp) if want_shading else hit


def trace_pair(orig: Vec3, d: Vec3, sorig: Vec3, sdir: Vec3, max_len,
               scene: DeviceScene, area_light: Optional[AreaLight]):
    """Extension closest-hit + shadow occlusion under one shared coherence
    sort (mxu_trace.trace_pair_mxu). Returns (raw=(t, col), occluded),
    including the area-light body occlusion when a light is given
    (wf_shadowrays.cl:27-33)."""
    t, col, occ = mt.trace_pair_mxu(orig, d, sorig, sdir, max_len, scene.mxu)
    if area_light is not None:
        l_hit, _ = intersect_area_light(sorig, sdir, area_light, max_len)
        occ = occ | l_hit
    return (t, col), occ


def trace_shadow(orig: Vec3, d: Vec3, max_len, scene: DeviceScene,
                 area_light: Optional[AreaLight], check_area_light):
    """Occlusion query (any_hit_mxu), including the area-light body when a
    light is given (wf_shadowrays.cl:27-33)."""
    occ = mt.any_hit_mxu(orig, d, max_len, scene.mxu)
    if area_light is not None:
        l_hit, _ = intersect_area_light(orig, d, area_light, max_len)
        occ = occ | (l_hit & check_area_light)
    return occ


def tangent_space_normal(hit: Hit, frames, map_n, atlas,
                         meta=None) -> Vec3:
    """Normal mapping (utils.cl:174-207; the reference's trace.py:237-270):
    on lanes whose material has a normal map, the map's texel (2c - 1) in
    the triangle's tangent frame, the frame built from its edges e1, e2
    and uv edges (``frames``: DeviceScene.tri_frames, by the original
    triangle index ``hit.i``); elsewhere, and where the uv frame is
    degenerate, the interpolated normal. The interpolated normal without
    a normal map in the scene. ``meta`` = per-lane (off, w, h) of the
    map from the resolve."""
    if atlas is None or atlas.count == 0 or not atlas.has_n:
        return hit.N
    u = hit.uv_u
    texn = mat_get_float3(
        Vec3(torch.full_like(u, 0.5), torch.full_like(u, 0.5),
             torch.ones_like(u)), u, hit.uv_v, map_n, atlas, meta=meta)
    texn = texn + texn - 1.0

    f = frames[:, torch.clamp_min(hit.i, 0).long()]
    e1, e2 = Vec3(f[0], f[1], f[2]), Vec3(f[3], f[4], f[5])
    t1u, t1v = f[8] - f[6], f[9] - f[7]
    t2u, t2v = f[10] - f[6], f[11] - f[7]
    det = t1u * t2v - t1v * t2u
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tang = normalize((e1 * t2v - e2 * t1v) * inv_det)
    bitang = normalize((e2 * t1u - e1 * t2u) * inv_det)
    n = normalize(Vec3(
        tang.x * texn.x + bitang.x * texn.y + hit.N.x * texn.z,
        tang.y * texn.x + bitang.y * texn.y + hit.N.y * texn.z,
        tang.z * texn.x + bitang.z * texn.y + hit.N.z * texn.z))
    valid = (map_n >= 0) & (hit.i >= 0) & (det != 0.0)
    return vwhere(valid, n, hit.N)
