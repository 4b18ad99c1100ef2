"""Cluster-table ray tracing: the port of the reference package's
accel/mxu_trace.py (the rays-on-lanes trace tiers and the B16 resolve).

Triangles are cut into clusters of ``cluster_size`` (the subtrees of the
BVH, SAH or SBVH, cut at that many refs). Each triangle carries the affine
map that takes world points to its unit right triangle: for a ray (o, d),
t = -o'_w / d'_w, u = o'_u + t d'_u, v = o'_v + t d'_v, hit iff t > 0,
u, v >= 0, u + v <= 1. Rays are sorted by a coherence key and cut into
tiles; each tile gets a private front-to-back candidate list (K1, the
stable sort fused in), walked by the trace kernel with per-ray t_best
pruning and a tile-level early-out. Up to SC_THRESHOLD clusters the list
holds clusters (K2); past it, superclusters of up to SC_CLUSTERS
clusters, each of whose members is culled on its own (K5). With
``flags.ROL`` off the trace falls back to the rays-on-sublanes kernel
(K9), which single-set traces also take unsorted when ``flags.SORT_RAYS``
is off. A resolve kernel turns the
winner column into exact t/u/v, interpolated vertex attributes and the
baked material parameters, chosen by what the tables hold, as the
reference does: from the B16 table K3, or K6 once the tables pass the
reference's 48 MiB resident budget; from the f32 ``attrs`` table when they
carry no B16 table (a table cache that stores it absent), K10.

Kernels (each launched on CUDA tensors; its plain PyTorch twin runs on CPU
tensors):
  K1 ``tile_order``    csrc/tile_order.cu    (ref _tile_order_kernel + sort)
  K2 ``trace_rol``     csrc/trace_rol.cu     (ref _trace_kernel_rol)
  K3 ``resolve_v5``    csrc/resolve_v5.cu    (ref _resolve_kernel_v5)
  K5 ``trace_rol_sc``  csrc/trace_rol_sc.cu  (ref _trace_kernel_rol_sc)
  K6 ``resolve_v5s``   csrc/resolve_v5s.cu   (ref _resolve_kernel_v5s)
  K9 ``trace_ros``     csrc/trace_ros.cu     (ref _trace_kernel)
  K10 ``resolve_v1``   csrc/resolve_v1.cu    (ref _resolve_kernel)

The host table build (``MXUScene.build``) reproduces the reference's
tables bit for bit, with bf16 rounding done by torch (round to nearest
even, as ml_dtypes); bf16 arrays travel as uint16 bit patterns in numpy.
``MXUScene.build_cached`` keeps the host tables in the reference's npz
table cache, which both packages read and write.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import flags
from .. import kernel_build as kb
from ..profiling import span
from ..vec import Vec3
from .bvh import BVHArrays

F32_MAX = np.float32(3.4028235e38)
_CULL_INF = np.float32(1e30)

# supercluster granularity (member clusters per super) and the cluster
# count above which the trace switches to the two-level kernel (K5)
SC_CLUSTERS = 64
SC_THRESHOLD = 96
RAY_TILE = 512
ROL_TILE = 512
# layout version of the table cache (the reference's TABLE_VERSION; part of
# the cache file name)
TABLE_VERSION = 4

# attrs column layout (rows of the SoA resolve output)
ATTR_N = 0        # nx, ny, nz
ATTR_UV = 3       # tu, tv
ATTR_MAT = 5      # material id
ATTR_KD = 6       # Kd gamma-linearized (matGetAlbedo semantics), 3
ATTR_KS = 9       # Ks, 3
ATTR_KE = 12      # Ke, 3
ATTR_KT = 15      # Kt, 3
ATTR_NS = 18      # GGX alpha
ATTR_NI = 19
ATTR_D = 20       # dissolve
ATTR_TYPE = 21    # bxdf bits
ATTR_MAP_KD = 22
ATTR_MAP_KS = 23
ATTR_MAP_N = 24
ATTR_TRI = 25     # original triangle index (float-exact below 2^24)
ATTR_HITU = 26    # barycentric u of the hit (written by the resolve kernel)
ATTR_HITV = 27
ATTR_HITT = 28    # exact hit t (recomputed from the winner transform)
ATTR_TKD_WH = 29
ATTR_TKD_OFF = 30
ATTR_TKS_WH = 31
ATTR_TKS_OFF = 32
ATTR_TN_WH = 33
ATTR_TN_OFF = 34
ATTR_COLS = 40    # padded


class B16:
    """Column offsets of the bf16 resolve table (one row per triangle,
    128 columns). Every entry is exact in bf16 by construction: floats are
    split hi/lo (hi = bf16(x), lo = bf16(x - hi)), integers into 8-bit
    chunks. Map indices are stored +1."""
    TXY_HI = 0       # 12: affine transform rows (x0..3, y0..3, z0..3)
    TXY_LO = 12      # 12
    CF_HI = 24       # 15 const floats: KD3 KS3 KE3 KT3 NS NI D
    CF_LO = 39       # 15
    V0_HI = 54       # 5 per-vertex floats of v0: N3, UV2
    V0_LO = 59
    V1_HI = 64
    V1_LO = 69
    V2_HI = 74
    V2_LO = 79
    MAT = 84         # 2 chunks
    TYPE = 86        # 2
    MAP_KD = 88      # 2 (stored +1)
    MAP_KS = 90      # 2 (stored +1)
    MAP_N = 92       # 2 (stored +1)
    TRI = 94         # 3
    TKD_W = 97       # 2
    TKD_H = 99       # 2
    TKD_OFF = 101    # 3
    TKS_W = 104
    TKS_H = 106
    TKS_OFF = 108
    TN_W = 111
    TN_H = 113
    TN_OFF = 115
    COLS = 128


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

def _bf16_bits(x) -> np.ndarray:
    """f32 array -> uint16 bf16 bit patterns, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_round(x) -> np.ndarray:
    """f32 array -> f32 values rounded to bf16 (nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _b16_split(x):
    """f32 -> (hi, lo) with hi + lo == x to ~2^-16 relative; both bf16-
    representable."""
    x = np.asarray(x, np.float32)
    hi = _bf16_round(x)
    lo = _bf16_round(x - hi)
    return hi, lo


def _b16_chunks(v, n):
    """non-negative int array -> n 8-bit chunk columns (little-endian)."""
    v = np.asarray(v, np.int64)
    if not ((v >= 0).all() and (v < (1 << (8 * n))).all()):
        raise ValueError(f"value out of range for {n} 8-bit chunks")
    return [((v >> (8 * k)) & 0xFF).astype(np.float32) for k in range(n)]


def _build_attr_b16(a, txy_t):
    """Pack the bf16 resolve table (see B16) from the per-triangle
    attribute array a [Mpad, 3, ATTR_COLS] and transforms txy_t [Mpad, 12].
    Returned as uint16 bf16 bit patterns [Mpad, 128]."""
    m_pad = a.shape[0]
    tb = np.zeros((m_pad, B16.COLS), np.float32)

    def put_f(col_hi, col_lo, x):
        hi, lo = _b16_split(x)
        w = x.shape[1]
        tb[:, col_hi:col_hi + w] = hi
        tb[:, col_lo:col_lo + w] = lo

    def put_i(col, n, v):
        for k, c in enumerate(_b16_chunks(np.rint(v), n)):
            tb[:, col + k] = c

    put_f(B16.TXY_HI, B16.TXY_LO, txy_t)
    cf = np.concatenate(
        [a[:, 0, ATTR_KD:ATTR_KD + 3], a[:, 0, ATTR_KS:ATTR_KS + 3],
         a[:, 0, ATTR_KE:ATTR_KE + 3], a[:, 0, ATTR_KT:ATTR_KT + 3],
         a[:, 0, ATTR_NS:ATTR_NS + 1], a[:, 0, ATTR_NI:ATTR_NI + 1],
         a[:, 0, ATTR_D:ATTR_D + 1]], axis=1)
    put_f(B16.CF_HI, B16.CF_LO, cf)
    for k, (ch, cl) in enumerate(((B16.V0_HI, B16.V0_LO),
                                  (B16.V1_HI, B16.V1_LO),
                                  (B16.V2_HI, B16.V2_LO))):
        vf = np.concatenate([a[:, k, ATTR_N:ATTR_N + 3],
                             a[:, k, ATTR_UV:ATTR_UV + 2]], axis=1)
        put_f(ch, cl, vf)

    put_i(B16.MAT, 2, a[:, 0, ATTR_MAT])
    put_i(B16.TYPE, 2, a[:, 0, ATTR_TYPE])
    put_i(B16.MAP_KD, 2, a[:, 0, ATTR_MAP_KD] + 1.0)
    put_i(B16.MAP_KS, 2, a[:, 0, ATTR_MAP_KS] + 1.0)
    put_i(B16.MAP_N, 2, a[:, 0, ATTR_MAP_N] + 1.0)
    put_i(B16.TRI, 3, a[:, 0, ATTR_TRI])
    for wh_col, off_col, (cw, chh, co) in (
            (ATTR_TKD_WH, ATTR_TKD_OFF, (B16.TKD_W, B16.TKD_H, B16.TKD_OFF)),
            (ATTR_TKS_WH, ATTR_TKS_OFF, (B16.TKS_W, B16.TKS_H, B16.TKS_OFF)),
            (ATTR_TN_WH, ATTR_TN_OFF, (B16.TN_W, B16.TN_H, B16.TN_OFF))):
        wh = np.rint(a[:, 0, wh_col]).astype(np.int64)
        put_i(cw, 2, wh // 4096)
        put_i(chh, 2, wh % 4096)
        put_i(co, 3, a[:, 0, off_col])
    return _bf16_bits(tb)


def _cut_supers(bvh: BVHArrays, counts, cluster_lo, super_size: int):
    """Cut the BVH at ``super_size`` refs into superclusters; each one's
    member clusters form one contiguous range of cluster ids. Returns
    (cut nodes, first member, end member)."""
    n_prims = bvh.n_prims.astype(np.int64)
    leaf = n_prims > 0
    parent = bvh.parent.astype(np.int64)
    cut_ok = counts <= super_size
    pbig = np.where(parent >= 0, ~cut_ok[np.maximum(parent, 0)], True)
    cut = np.nonzero(cut_ok & pbig)[0]

    right = bvh.right_or_start.astype(np.int64)
    leaf_start = np.where(leaf, right, np.iinfo(np.int64).max)
    lo_all = np.minimum.accumulate(leaf_start[::-1])[::-1]
    lo = lo_all[cut]
    c0 = np.searchsorted(cluster_lo, lo, side="left")
    c1 = np.append(c0[1:], len(cluster_lo))
    return cut, c0, c1


def _cut_clusters(bvh: BVHArrays, cluster_size: int):
    """Cut the BVH into subtrees holding <= cluster_size triangle refs
    (duplicated SBVH references count once each). Returns (list of
    (index slice, bmin, bmax), subtree counts, slice starts). The builders
    append leaves in DFS order, so each cut subtree's leaf refs are one
    contiguous slice of ``indices``; a tree whose slices are not (a
    foreign hierarchy cache) takes the explicit walk and returns
    (clusters, None, None), as the reference's mxu_trace.py:274-277."""
    n_prims = bvh.n_prims.astype(np.int64)
    right = bvh.right_or_start.astype(np.int64)
    leaf = n_prims > 0
    inner = ~leaf

    counts = np.where(leaf, n_prims, 0)
    li = np.nonzero(inner)[0]
    lchild = li + 1
    rchild = right[li]
    for _ in range(80):
        new = counts[lchild] + counts[rchild]
        if (counts[li] == new).all():
            break
        counts[li] = new

    cut_ok = counts <= cluster_size
    parent = bvh.parent.astype(np.int64)
    pbig = np.where(parent >= 0, ~cut_ok[np.maximum(parent, 0)], True)
    cut = np.nonzero(cut_ok & pbig)[0]

    leaf_start = np.where(leaf, right, np.iinfo(np.int64).max)
    lo_all = np.minimum.accumulate(leaf_start[::-1])[::-1]
    lo = lo_all[cut]
    hi = np.append(lo[1:], len(bvh.indices))

    good = (lo[0] == 0 and (hi >= lo).all()
            and (hi - lo == counts[cut]).all())
    if not good:
        return _cut_clusters_walk(bvh, cluster_size, counts), None, None
    return ([(bvh.indices[lo[j]:hi[j]], bvh.box_min[i], bvh.box_max[i])
             for j, i in enumerate(cut)], counts, lo)


def _cut_clusters_walk(bvh: BVHArrays, cluster_size: int, counts):
    """The cut by an explicit stack, for trees whose leaf slices are not
    DFS-contiguous (the reference's mxu_trace.py:282-307): a node is cut
    when its subtree holds <= cluster_size refs or it is a leaf; its index
    list gathers its leaves' slices. The clusters come out in the stack's
    order (right subtree first), as the reference's."""
    n_prims = bvh.n_prims
    right = bvh.right_or_start

    def leaves_of(i):
        out = []
        stack = [i]
        while stack:
            k = stack.pop()
            if n_prims[k] > 0:
                out.append((int(right[k]), int(n_prims[k])))
            else:
                stack.append(k + 1)
                stack.append(int(right[k]))
        return out

    clusters = []
    stack = [0]
    while stack:
        i = stack.pop()
        if counts[i] <= cluster_size or n_prims[i] > 0:
            idx = np.concatenate([bvh.indices[s:s + c]
                                  for s, c in leaves_of(i)])
            clusters.append((idx, bvh.box_min[i], bvh.box_max[i]))
        else:
            stack.append(i + 1)
            stack.append(int(right[i]))
    return clusters


def _bake_tex_meta(a, atlas, materials, mid):
    """Write the atlas descriptors of each triangle's Kd, Ks and normal
    maps into the attribute rows ``a`` [Mpad, 3, ATTR_COLS] (the
    reference's mxu_trace.py:462-490): w * 4096 + h and the offset, 0 and
    0 where the material has no such map."""
    tw = np.array(atlas.width_t, np.int32)
    th = np.array(atlas.height_t, np.int32)
    toff = np.array(atlas.offset_t, np.int32)
    if tw.max() >= 4096 or th.max() >= 4096:
        raise ValueError("texture sizes must fit the wh-pack (w, h < 4096)")
    if toff.max() >= (1 << 24):
        raise ValueError("atlas offsets must be exact in float32 (< 2^24)")
    for get, wh_col, off_col in ((lambda m: m.map_Kd, ATTR_TKD_WH,
                                  ATTR_TKD_OFF),
                                 (lambda m: m.map_Ks, ATTR_TKS_WH,
                                  ATTR_TKS_OFF),
                                 (lambda m: m.map_N, ATTR_TN_WH,
                                  ATTR_TN_OFF)):
        ti = np.array([get(m) for m in materials], np.int32)[mid]
        ok = ti >= 0
        ts = np.maximum(ti, 0)
        a[:, :, wh_col] = np.where(ok, tw[ts] * 4096 + th[ts], 0).astype(
            np.float32)[:, None]
        a[:, :, off_col] = np.where(ok, toff[ts], 0).astype(
            np.float32)[:, None]


class MXUScene:
    """Host build of the cluster tables (the reference's
    ``MXUScene.build(..., return_host=True)``); ``tables_from_numpy``
    uploads the result."""

    @staticmethod
    def build(positions: np.ndarray, bvh: BVHArrays,
              cluster_size: int = 256, normals: Optional[np.ndarray] = None,
              uvs: Optional[np.ndarray] = None,
              mat_ids: Optional[np.ndarray] = None,
              materials=None, atlas=None, slim: bool = False):
        """positions: [M,3,3] world-space triangle vertices; materials: an
        optional HostMaterial list, baked per triangle; atlas: an optional
        TextureAtlas whose descriptors (its host tuples ``offset_t``,
        ``width_t``, ``height_t``) are baked per triangle and map type, as
        w * 4096 + h and the offset (both exact in float32: w, h < 4096
        and offsets < 2^24, else ValueError). ``slim`` (the
        renderer sets it past 65,536 triangles) leaves out the tables no
        path of the port reads at that scale, as the reference does:
        ``attrs``, ``attr_b16`` and ``tx/ty/tz``, and ``txy_t`` past
        12 MiB. Returns (host dict of numpy arrays, statics dict)."""
        tex_meta = (atlas is not None and materials is not None
                    and atlas.count > 0)
        p = np.asarray(positions, np.float64)
        lo = p.reshape(-1, 3).min(0)
        hi = p.reshape(-1, 3).max(0)
        center = (lo + hi) * 0.5
        p = p - center  # center for f32 precision in the affine transform

        clusters, counts, cluster_lo = _cut_clusters(bvh, cluster_size)
        n_clusters = len(clusters)
        m_pad = n_clusters * cluster_size

        sc_box = None
        n_sc = 0
        if counts is not None and n_clusters > 1:
            sc_size = SC_CLUSTERS * cluster_size
            sc_nodes, sc_c0, sc_c1 = _cut_supers(bvh, counts, cluster_lo,
                                                 sc_size)
            n_sc = len(sc_nodes)
            sb = np.zeros((n_sc, 8), np.float32)
            sb[:, 0:3] = bvh.box_min[sc_nodes] - center
            sb[:, 3:6] = bvh.box_max[sc_nodes] - center
            sb[:, 6] = sc_c0.astype(np.float32)
            sb[:, 7] = (sc_c1 - sc_c0).astype(np.float32)
            if not (sc_c0[0] == 0 and (sc_c1[-1:] == n_clusters).all()
                    and (sc_c1 - sc_c0 >= 1).all()):
                raise ValueError("super/cluster cut mismatch")
            sc_box = sb

        tri_map = np.full(m_pad, -1, np.int32)
        boxes = np.zeros((n_clusters, 8), np.float32)
        order = np.zeros(m_pad, np.int64)
        used = np.zeros(m_pad, bool)
        for ci, (idx, bmin, bmax) in enumerate(clusters):
            base = ci * cluster_size
            idx = np.unique(idx)
            k = len(idx)
            order[base:base + k] = idx
            used[base:base + k] = True
            tri_map[base:base + k] = idx
            boxes[ci, 0:3] = bmin - center
            boxes[ci, 3:6] = bmax - center

        tris = p[order]
        v0 = tris[:, 0]
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        nrm = np.cross(e1, e2)
        mats = np.stack([e1, e2, nrm], axis=-1)       # [Mpad,3,3]
        det = np.linalg.det(mats)
        ok = used & (np.abs(det) > 1e-30)
        minv = np.zeros((m_pad, 3, 3))
        minv[ok] = np.linalg.inv(mats[ok])
        trans = -np.einsum("mij,mj->mi", minv, v0)
        t4 = np.concatenate([minv.transpose(0, 2, 1), trans[:, None, :]],
                            axis=1)                    # [Mpad,4,3]
        t4[~ok] = 0.0  # forces d'_w == 0 -> never hits

        attrs = None
        a_tri = None
        if normals is not None:
            a = np.zeros((m_pad, 3, ATTR_COLS), np.float32)
            a[:, :, ATTR_N:ATTR_N + 3] = normals[order]
            if uvs is not None:
                a[:, :, ATTR_UV:ATTR_UV + 2] = uvs[order]
            if mat_ids is not None:
                mid = mat_ids[order]
                a[:, :, ATTR_MAT] = mid[:, None]
                if materials is not None:
                    def col(get):
                        return np.array([get(materials[i]) for i in
                                         range(len(materials))],
                                        np.float32)[mid]
                    kd = col(lambda m: m.Kd) ** 2.2   # matGetAlbedo gamma
                    a[:, :, ATTR_KD:ATTR_KD + 3] = kd[:, None, :]
                    a[:, :, ATTR_KS:ATTR_KS + 3] = col(lambda m: m.Ks)[:, None, :]
                    a[:, :, ATTR_KE:ATTR_KE + 3] = col(lambda m: m.Ke)[:, None, :]
                    a[:, :, ATTR_KT:ATTR_KT + 3] = col(lambda m: m.Kt)[:, None, :]
                    a[:, :, ATTR_NS] = col(lambda m: m.Ns)[:, None]
                    a[:, :, ATTR_NI] = col(lambda m: m.Ni)[:, None]
                    a[:, :, ATTR_D] = col(lambda m: m.d)[:, None]
                    a[:, :, ATTR_TYPE] = col(lambda m: m.type)[:, None]
                    a[:, :, ATTR_MAP_KD] = col(lambda m: m.map_Kd)[:, None]
                    a[:, :, ATTR_MAP_KS] = col(lambda m: m.map_Ks)[:, None]
                    a[:, :, ATTR_MAP_N] = col(lambda m: m.map_N)[:, None]
                    if tex_meta:
                        _bake_tex_meta(a, atlas, materials, mid)
            a[:, :, ATTR_TRI] = order[:, None].astype(np.float32)
            a[~used] = 0.0
            a_tri = a
            if not slim:
                attrs = a.reshape(n_clusters, cluster_size, 3, ATTR_COLS) \
                    .transpose(0, 2, 1, 3).reshape(
                        n_clusters * 3 * cluster_size, ATTR_COLS)

        txy_t = np.concatenate([t4[:, :, 0], t4[:, :, 1], t4[:, :, 2]],
                               axis=1).astype(np.float32)  # [Mpad, 12]

        attr_b16 = None
        if a_tri is not None:
            attr_b16 = _build_attr_b16(a_tri, txy_t)

        # cluster c's 12 transform rows at rows [c*16, c*16+12)
        t12 = np.ascontiguousarray(txy_t.T)
        t12b = np.zeros((n_clusters * 16, cluster_size), np.float32)
        t12b.reshape(n_clusters, 16, cluster_size)[:, :12] = \
            t12.reshape(12, n_clusters, cluster_size).transpose(1, 0, 2)

        # cluster-blocked transpose of the B16 table (cluster c's
        # [128, tc] block at rows c*128..)
        b16t = None
        if attr_b16 is not None:
            b16t = np.ascontiguousarray(
                attr_b16.reshape(n_clusters, cluster_size, B16.COLS)
                .transpose(0, 2, 1)
                .reshape(n_clusters * B16.COLS, cluster_size))

        tx = ty = tz = None
        if slim:
            attr_b16 = None
            if txy_t.size * 4 > (12 << 20):
                txy_t = None
        else:
            tx = np.ascontiguousarray(t4[:, :, 0].T, np.float32)
            ty = np.ascontiguousarray(t4[:, :, 1].T, np.float32)
            tz = np.ascontiguousarray(t4[:, :, 2].T, np.float32)

        host = dict(
            sc_box=sc_box, sub_box=None, fine_box=None,
            attr_b16=attr_b16, attrs=attrs,
            b16t=b16t, txy_t=txy_t, t12=t12, t12b=t12b,
            tx=tx, ty=ty, tz=tz,
            cluster_box=boxes, tri_map=tri_map,
            center=center.astype(np.float32))
        statics = dict(n_clusters=n_clusters, cluster_size=cluster_size,
                       n_superclusters=n_sc, has_tex_meta=tex_meta)
        return host, statics

    @staticmethod
    def build_cached(cache_path: Optional[str], positions, bvh, **kw):
        """``build`` behind the reference's content-keyed table cache
        (mxu_trace.py:587-623): a hit loads the npz at ``cache_path`` and
        builds nothing; a miss builds and writes it. The caller keys the
        path by scene hash, materials, split mode, cluster size and
        TABLE_VERSION; the texture sizes are not in that key, so the file
        also records the atlas descriptors it baked (``tex_desc``), and
        one baked with other descriptors than ``kw["atlas"]``'s counts as
        a miss (see ``table_cache_fresh``). Returns (host dict, statics),
        as ``build``."""
        atlas = kw.get("atlas")
        if table_cache_fresh(cache_path, atlas):
            return load_table_cache(cache_path)
        host, statics = MXUScene.build(positions, bvh, **kw)
        if cache_path:
            write_table_cache(cache_path, host, statics, tex_desc(atlas))
        return host, statics


_HOST_KEYS = ("sc_box", "sub_box", "fine_box", "attr_b16", "attrs", "b16t",
              "txy_t", "t12", "t12b", "tx", "ty", "tz", "cluster_box",
              "tri_map", "center")
_STATIC_KEYS = ("n_clusters", "cluster_size", "n_superclusters",
                "has_tex_meta")


def tex_desc(atlas) -> np.ndarray:
    """[3, count] int64: each texture's offset in the atlas, width and
    height, the descriptors ``build`` bakes into the tables ([3, 0]
    without textures)."""
    n = 0 if atlas is None else atlas.count
    if not n:
        return np.zeros((3, 0), np.int64)
    return np.array([atlas.offset_t[:n], atlas.width_t[:n],
                     atlas.height_t[:n]], np.int64)


def table_cache_fresh(path: Optional[str], atlas) -> bool:
    """Whether the table cache at ``path`` exists and baked the same atlas
    descriptors as ``atlas`` gives: a map replaced by one of another size
    under the same name moves them. A file without ``tex_desc`` (the
    reference writes none) baked none."""
    if not (path and os.path.exists(path)):
        return False
    with np.load(path, allow_pickle=False) as z:
        stored = (z["tex_desc"] if "tex_desc" in z.files
                  else np.zeros((3, 0), np.int64))
    return np.array_equal(stored, tex_desc(atlas))


def write_table_cache(path: str, host: dict, statics: dict,
                      desc: Optional[np.ndarray] = None):
    """Write host tables in the reference's npz layout: one array per host
    key, ``np.zeros(())`` for an absent table, the bf16 tables as uint16
    bit patterns, and the four statics; ``desc`` (``tex_desc``), where
    given, as one more entry, which the reference does not read. Written
    under a temporary name and moved into place, so a concurrent reader
    never sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = {k: (np.zeros(()) if host.get(k) is None else
               (np.asarray(host[k]).view(np.uint16)
                if k in ("attr_b16", "b16t") else host[k]))
           for k in _HOST_KEYS}
    out.update({k: statics[k] for k in _STATIC_KEYS})
    if desc is not None:
        out["tex_desc"] = desc
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # .npz: savez appends none
    np.savez(tmp, **out)
    os.replace(tmp, path)


def load_table_cache(path: str):
    """Read a table cache (either package's): every 0-d entry is an absent
    table. Returns (host dict, statics); bf16 tables stay uint16 bits."""
    with np.load(path, allow_pickle=False) as z:
        host = {k: z[k] for k in _HOST_KEYS}     # each entry read once
        host = {k: (None if a.ndim == 0 else a) for k, a in host.items()}
        statics = dict(n_clusters=int(z["n_clusters"]),
                       cluster_size=int(z["cluster_size"]),
                       n_superclusters=int(z["n_superclusters"]),
                       has_tex_meta=bool(z["has_tex_meta"]))
    return host, statics


class MXUSceneT(NamedTuple):
    """Device tables of the port.

    cluster_box [ncl, 8] f32   bmin3 bmax3 pad2 (centered)
    sc_box  [n_sc, 8] f32      supercluster bmin3 bmax3, first member
                               cluster, member count (None for one cluster
                               or a cut by _cut_clusters_walk)
    t12   [12, Mpad] f32       coefficient-major transforms (K2, K5)
    b16r  [Mpad, 128] bf16     the B16 table, row-major (K3/K6 row reads);
                               None when the tables carry no B16 table
    t16r  [Mpad, 16] f32       transforms, row-major (K3/K6); None with b16r
    tri_map [Mpad] i32, center [3] f32, lo/hi [3] f32 scene bounds
    tx/ty/tz [4, Mpad] f32     the x/y/z columns of the transforms (K9);
                               None on slim tables
    txy_t [Mpad, 12] f32       transforms row-major (closest_hit_mxu_full's
                               u/v, K10); None on slim tables past 12 MiB
    attrs [3 Mpad, 40] f32     per-vertex attributes and baked materials
                               (K10): cluster c's rows [c 3tc, (c+1) 3tc)
                               hold v0 of its triangles, then v1, then v2;
                               None on slim tables
    has_tex_meta               whether the B16 and attrs rows carry the
                               atlas descriptors (ATTR_T*_WH/OFF)

    The reference's cluster-blocked ``b16t``/``t12b`` layouts are re-packed
    into ``b16r``/``t16r`` on the host and not uploaded: no kernel reads
    them.
    """
    cluster_box: torch.Tensor
    sc_box: Optional[torch.Tensor]
    t12: torch.Tensor
    b16r: Optional[torch.Tensor]
    t16r: Optional[torch.Tensor]
    tri_map: torch.Tensor
    center: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n_clusters: int
    cluster_size: int
    n_superclusters: int
    tx: Optional[torch.Tensor] = None
    ty: Optional[torch.Tensor] = None
    tz: Optional[torch.Tensor] = None
    txy_t: Optional[torch.Tensor] = None
    attrs: Optional[torch.Tensor] = None
    has_tex_meta: bool = False


def _bf16_tensor(a, device):
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint16:        # ml_dtypes.bfloat16 from the reference
        a = a.view(np.uint16)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)


def tables_from_numpy(host: dict, statics: dict, device) -> MXUSceneT:
    """Upload a host table dict — the port's own ``MXUScene.build`` result
    or the reference package's ``MXUScene.build(..., return_host=True)``
    (its bf16 arrays are read through ``.view(np.uint16)``) — as the
    port's device tables. ``b16r``/``t16r`` exist only when the host dict
    holds ``b16t``; ``attrs`` is uploaded when it holds that."""
    ncl = statics["n_clusters"]
    tc = statics["cluster_size"]
    f32 = lambda k: torch.from_numpy(
        np.ascontiguousarray(host[k], np.float32)).to(device)
    opt = lambda k: f32(k) if host.get(k) is not None else None
    b16r = t16r = None
    if host.get("b16t") is not None:
        b16t = np.asarray(host["b16t"])
        if b16t.dtype != np.uint16:
            b16t = b16t.view(np.uint16)
        b16r = _bf16_tensor(b16t.reshape(ncl, B16.COLS, tc)
                            .transpose(0, 2, 1).reshape(ncl * tc, B16.COLS),
                            device)
        t12b = np.asarray(host["t12b"], np.float32)
        t16r = torch.from_numpy(np.ascontiguousarray(
            t12b.reshape(ncl, 16, tc).transpose(0, 2, 1).reshape(
                ncl * tc, 16))).to(device)
    boxes = f32("cluster_box")
    return MXUSceneT(
        cluster_box=boxes,
        sc_box=opt("sc_box"),
        t12=f32("t12"), b16r=b16r, t16r=t16r,
        tri_map=torch.from_numpy(
            np.ascontiguousarray(host["tri_map"], np.int32)).to(device),
        center=f32("center"),
        lo=boxes[:, 0:3].amin(0), hi=boxes[:, 3:6].amax(0),
        n_clusters=ncl, cluster_size=tc,
        n_superclusters=statics["n_superclusters"],
        tx=opt("tx"), ty=opt("ty"), tz=opt("tz"), txy_t=opt("txy_t"),
        attrs=opt("attrs"), has_tex_meta=bool(statics["has_tex_meta"]))


def resolve_table_bytes(n_clusters: int, tc: int) -> int:
    """The reference's byte count of its resolve tables (``b16t`` bf16 +
    ``t12b`` f32, mxu_trace.py:2025), from the statics alone."""
    return n_clusters * B16.COLS * tc * 2 + n_clusters * 16 * tc * 4


# ---------------------------------------------------------------------------
# K1: per-tile candidate order
# ---------------------------------------------------------------------------

K1 = kb.Kernel("tile_order", "tile_order.cu", "tile_order_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4)
# boxes per tile that K1's fused sort holds in shared memory
# (csrc/tile_order.cu, MAX_BOXES)
K1_MAX_BOXES = 4096


def _slab(box, o0, o1, o2, i0, i1, i2):
    """Exact per-ray slab test terms, the kernels' operation order, with
    NaN-propagating min/max (torch.minimum/maximum)."""
    ax = (box[0] - o0) * i0
    bx = (box[3] - o0) * i0
    ay = (box[1] - o1) * i1
    by = (box[4] - o1) * i1
    az = (box[2] - o2) * i2
    bz = (box[5] - o2) * i2
    tnear = torch.maximum(torch.maximum(torch.minimum(ax, bx),
                                        torch.minimum(ay, by)),
                          torch.minimum(az, bz))
    tfar = torch.minimum(torch.minimum(torch.maximum(ax, bx),
                                       torch.maximum(ay, by)),
                         torch.maximum(az, bz))
    return tnear, tfar


def _inv_dirs(rays):
    eps = 1e-30
    return [1.0 / torch.where(rays[:, k] == 0.0, eps, rays[:, k])
            for k in (4, 5, 6)]


def tile_order_plain(rays, tm, boxes):
    """Plain PyTorch K1. rays [nt, 8, rt], tm [nt, rt], boxes [ncl, 8] ->
    cons [nt, ncl_pad]: per tile and cluster, the min over rays of
    max(tnear, +0.0) for rays entering within their tmax, else 1e30."""
    K1.plain_runs += 1
    nt, _, rt = rays.shape
    ncl = boxes.shape[0]
    ncl_pad = ncl + ((-ncl) % 8)
    o = [rays[:, k][:, None, :] for k in (0, 1, 2)]        # [nt, 1, rt]
    inv = [i[:, None, :] for i in _inv_dirs(rays)]
    box = [boxes[:, k].reshape(1, ncl, 1) for k in range(6)]
    tnear, tfar = _slab(box, *o, *inv)                      # [nt, ncl, rt]
    hit = (tfar >= 0.0) & (tnear <= tfar) & (tnear < tm[:, None, :])
    # max(tnear, 0) as +0.0 for tnear <= 0, -0.0 included: the bounds are
    # then >= +0.0 in sign and value, so their bits order as unsigned
    # integers (K1 folds them so) and the sorted keys' zeros have one sign
    entry = torch.where(hit, torch.where(tnear > 0.0, tnear, 0.0),
                        float(_CULL_INF))
    cons = torch.full((nt, ncl_pad), float(_CULL_INF), dtype=torch.float32,
                      device=rays.device)
    cons[:, :ncl] = entry.amin(dim=2)
    return cons


def tile_order(rays, tm, boxes):
    """K1: per-tile candidate lists, (order [nt, ncl_pad] i32, skey
    [nt, ncl_pad] f32): the entry bounds of ``tile_order_plain`` sorted
    front-to-back, as ``_candidate_order`` sorts them, in one launch."""
    if rays.device.type == "cpu":
        return _candidate_order(tile_order_plain(rays, tm, boxes))
    kb.check_cuda("tile_order", rays, tm, boxes,
                  dtypes=(torch.float32,) * 3)
    nt, _, rt = rays.shape
    ncl = boxes.shape[0]
    ncl_pad = ncl + ((-ncl) % 8)
    if rt % 32 or rt > 1024:
        raise ValueError(f"tile_order: ray tile {rt} must be a multiple of "
                         "32 and at most 1024")
    if boxes.shape[1] != 8 or kb.ptr(boxes) % 16:
        raise ValueError("tile_order: boxes must be [ncl, 8] rows aligned "
                         "to 16 bytes")
    if ncl > K1_MAX_BOXES:
        raise ValueError(f"tile_order: {ncl} boxes exceed the fused sort's "
                         f"limit of {K1_MAX_BOXES} per tile")
    order = torch.empty((nt, ncl_pad), dtype=torch.int32, device=rays.device)
    skey = torch.empty((nt, ncl_pad), dtype=torch.float32,
                       device=rays.device)
    K1(kb.ptr(rays), kb.ptr(tm), kb.ptr(boxes), kb.ptr(order), kb.ptr(skey),
       nt, rt, ncl, ncl_pad)
    return order, skey


def _pack_rays(o4, d4, rt):
    """[b,4] origins/directions -> [nt, 8, rt] (ox oy oz 1 dx dy dz 0 rows
    per tile)."""
    b = o4.shape[0]
    nt = b // rt
    rays = torch.cat([o4.T, d4.T], dim=0)                  # [8, b]
    return rays.view(8, nt, rt).permute(1, 0, 2).contiguous()


def _candidate_order(cons):
    """Front-to-back candidate list per tile: a stable sort of the entry
    bounds (lax.sort semantics), -1 past the culled ones."""
    skey, sidx = torch.sort(cons, dim=1, stable=True)
    order = torch.where(skey >= float(_CULL_INF), -1, sidx).to(torch.int32)
    return order.contiguous(), skey.contiguous()


def _tile_order_v2(o4, d4, tmax_col, boxes, rt):
    """Per-tile candidate lists: (order [nt, ncl_pad] i32, cons
    [nt, ncl_pad] f32), sorted front-to-back."""
    nt = o4.shape[0] // rt
    return tile_order(_pack_rays(o4, d4, rt),
                      tmax_col.reshape(nt, rt).contiguous(), boxes)


# ---------------------------------------------------------------------------
# K2: rays-on-lanes cluster trace
# ---------------------------------------------------------------------------

K2 = kb.Kernel("trace_rol", "trace_rol.cu", "trace_rol_launch",
               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
               + [ctypes.c_longlong, ctypes.c_int])


class TraceStats(NamedTuple):
    """K2's queue counters, summed on the card over its launches on a
    device: the tiles queued, and those queued out of index order (where
    the queue moved a tile)."""
    tiles: int
    out_of_order: int


# per device: K2's queue counters (int64 [2], TraceStats' fields)
_K2_STATS: dict = {}


def _device_key(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _k2_stats(device):
    key = _device_key(device)
    st = _K2_STATS.get(key)
    if st is None:
        st = _K2_STATS[key] = torch.zeros(2, dtype=torch.int64, device=key)
    return st


def trace_stats(device) -> TraceStats:
    """K2's queue counters on ``device`` since the process began (one
    transfer; zeros where K2 never ran on the card, as on the CPU)."""
    st = _K2_STATS.get(_device_key(device))
    if st is None:
        return TraceStats(0, 0)
    return TraceStats(*st.tolist())


def live_counts(order):
    """K1's live candidates of each tile: the slots of its candidate list
    before the first -1."""
    return (order >= 0).to(torch.int32).cumprod(dim=1).sum(dim=1)


def tile_queue_plain(order):
    """The order in which K2 hands its tiles to the card: heaviest first by
    ``live_counts``, ties in tile index order, tiles with no live candidate
    last (int64 [nt])."""
    return torch.argsort(live_counts(order), descending=True, stable=True)


class _TraceState:
    """The per-tile state the plain trace versions advance: rays [nt, rt]
    components, t_best / i_best [nt, rt], visits [nt]."""

    def __init__(self, rays, tm, tc):
        nt, _, rt = rays.shape
        dev = rays.device
        self.o = [rays[:, k] for k in (0, 1, 2)]
        self.d = [rays[:, k] for k in (4, 5, 6)]
        self.inv = _inv_dirs(rays)
        self.t_best = tm.clone()
        self.i_best = torch.full((nt, rt), -1, dtype=torch.int32, device=dev)
        self.visits = torch.zeros(nt, dtype=torch.int32, device=dev)
        self.tc = tc
        self.row = torch.arange(tc, dtype=torch.int32,
                                device=dev).view(1, tc, 1)

    def box_hit(self, box, any_hit):
        """Per-ray slab test of one box per tile (box [nt, >=6]) against
        the current t_best (and, any-hit, only for unblocked rays)."""
        tnear, tfar = _slab([box[:, k, None] for k in range(6)], *self.o,
                            *self.inv)
        hit = (tfar >= 0.0) & (tnear <= tfar) & (tnear < self.t_best)
        if any_hit:
            hit &= self.i_best < 0
        return hit

    def stop_at(self, order, cons, slot):
        t_worst = self.t_best.amax(dim=1)
        return ((order[:, slot] < 0) | (cons[:, slot] > t_worst)
                | (t_worst <= 0.0))

    def sweep(self, live, c, t12c, any_hit):
        """Every ray of each live tile against all tc triangles of its
        cluster c [nt] (the kernels' arithmetic, term for term)."""
        idx = live.nonzero()[:, 0]
        if not idx.numel():
            return
        tc = self.tc
        rowbits = tc - 1
        self.visits[idx] += 1
        T = t12c[:, c[idx]].permute(1, 0, 2)[..., None]      # [L,12,tc,1]
        ol = [x[idx][:, None, :] for x in self.o]             # [L, 1, rt]
        dl = [x[idx][:, None, :] for x in self.d]
        oz = ol[0] * T[:, 8] + ol[1] * T[:, 9] + ol[2] * T[:, 10] + T[:, 11]
        dz = dl[0] * T[:, 8] + dl[1] * T[:, 9] + dl[2] * T[:, 10]
        t = -oz / torch.where(dz == 0.0, 1.0, dz)
        ox = ol[0] * T[:, 0] + ol[1] * T[:, 1] + ol[2] * T[:, 2] + T[:, 3]
        dx = dl[0] * T[:, 0] + dl[1] * T[:, 1] + dl[2] * T[:, 2]
        u = ox + t * dx
        oy = ol[0] * T[:, 4] + ol[1] * T[:, 5] + ol[2] * T[:, 6] + T[:, 7]
        dy = dl[0] * T[:, 4] + dl[1] * T[:, 5] + dl[2] * T[:, 6]
        v = oy + t * dy
        valid = (dz != 0.0) & (t > 0.0) & (
            torch.minimum(torch.minimum(u, v), 1.0 - u - v) >= 0.0)
        tb = self.t_best[idx]
        ib = self.i_best[idx]
        if any_hit:
            tcand = torch.where(valid, t, float(F32_MAX))
            blocked = tcand.amin(dim=1) < tb
            self.i_best[idx] = torch.where(blocked, 1, ib)
            self.t_best[idx] = torch.where(blocked, 0.0, tb)
        else:
            key = (t.view(torch.int32) & ~rowbits) | self.row
            key = torch.where(valid, key, 0x7F800000)
            kmin = key.amin(dim=1)                            # [L, rt]
            tmin = (kmin & ~rowbits).view(torch.float32)
            better = tmin < tb
            self.t_best[idx] = torch.where(better, tmin, tb)
            self.i_best[idx] = torch.where(
                better, (kmin & rowbits) + c[idx, None].int() * tc, ib)


def _walk_plain(st: _TraceState, order, cons, t12c, boxes, n_clusters: int,
                any_hit: bool):
    """The flat trace walk (K2's and K9's contract), all tiles advanced
    slot by slot together: per slot a per-ray slab cull; a tile whose rays
    miss the box, or whose slot is the -1 sentinel, skips the sweep; the
    tile stops at the sentinel, when the next entry bound exceeds its
    largest t_best, or when that is <= 0."""
    stop = st.stop_at(order, cons, 0)
    for slot in range(n_clusters):
        run = ~stop
        if not bool(run.any()):
            break
        c = order[:, slot].long()
        hit = st.box_hit(boxes[c.clamp_min(0)], any_hit)
        st.sweep(hit.any(dim=1) & (c >= 0) & run, c, t12c, any_hit)
        stop = stop | st.stop_at(order, cons, min(slot + 1, n_clusters - 1))


def trace_rol_plain(rays, tm, order, cons, t12, boxes, n_clusters: int,
                    tc: int, any_hit: bool):
    """Plain PyTorch K2 (see ``_walk_plain``). Returns (t [nt, rt] f32,
    i [nt, rt] i32, visits [nt] i32 — the live cluster visits of each
    tile)."""
    K2.plain_runs += 1
    st = _TraceState(rays, tm, tc)
    _walk_plain(st, order, cons, t12.view(12, n_clusters, tc), boxes,
                n_clusters, any_hit)
    return st.t_best, st.i_best, st.visits


def trace_rol(rays, tm, order, cons, t12, boxes, n_clusters: int, tc: int,
              any_hit: bool):
    """K2: trace a batch of ray tiles against their candidate clusters
    (see ``trace_rol_plain``), the tiles met in ``tile_queue_plain``'s
    order, each result at its tile's own index. Returns (t, i, visits).
    On the card two launches: the queue (ordered on the card, no host
    read; it adds to ``trace_stats``), then one cluster a tile in the
    queue's order."""
    if rays.device.type == "cpu":
        q = tile_queue_plain(order)
        out = trace_rol_plain(rays[q], tm[q], order[q], cons[q], t12, boxes,
                              n_clusters, tc, any_hit)
        back = torch.argsort(q)
        return tuple(x[back] for x in out)
    kb.check_cuda("trace_rol", rays, tm, order, cons, t12, boxes,
                  dtypes=(torch.float32, torch.float32, torch.int32,
                          torch.float32, torch.float32, torch.float32))
    nt, _, rt = rays.shape
    # the launcher's limits (csrc/trace_rol.cu on sweep_hopper.cuh): tiles
    # of whole warps at up to 2 rays per thread, at most 512 rays, and
    # clusters of 256 triangles
    if rt % 64 or rt > 512 or tc != 256:
        raise ValueError(f"trace_rol: ray tile {rt} / cluster size {tc} "
                         "unsupported (tiles of 64k <= 512 rays, clusters "
                         "of 256)")
    dev = rays.device
    t = torch.empty((nt, rt), dtype=torch.float32, device=dev)
    i = torch.empty((nt, rt), dtype=torch.int32, device=dev)
    visits = torch.empty(nt, dtype=torch.int32, device=dev)
    queue = torch.empty(nt, dtype=torch.int32, device=dev)
    K2(kb.ptr(rays), kb.ptr(tm), kb.ptr(order), kb.ptr(cons), kb.ptr(t12),
       kb.ptr(boxes), kb.ptr(t), kb.ptr(i), kb.ptr(visits), kb.ptr(queue),
       kb.ptr(_k2_stats(dev)), nt, rt, order.shape[1], n_clusters, tc,
       t12.shape[1], int(any_hit))
    return t, i, visits


def _trace_rol(o4, d4, tmax_col, t12, boxes, scene_static, any_hit,
               ray_tile):
    """Rays-on-lanes trace of [b,4] rays: candidate lists (K1),
    then K2. Returns (t [b,1], i [b,1])."""
    n_clusters, tc = scene_static
    rt = ray_tile
    b = o4.shape[0]
    nt = b // rt
    rays = _pack_rays(o4, d4, rt)
    tm = tmax_col.reshape(nt, rt).contiguous()
    order, cons = tile_order(rays, tm, boxes)
    t, i, _ = trace_rol(rays, tm, order, cons, t12, boxes, n_clusters, tc,
                        any_hit)
    return t.reshape(b, 1), i.reshape(b, 1)


# ---------------------------------------------------------------------------
# K5: two-level (supercluster) rays-on-lanes trace
# ---------------------------------------------------------------------------

K5 = kb.Kernel("trace_rol_sc", "trace_rol_sc.cu", "trace_rol_sc_launch",
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
               + [ctypes.c_longlong, ctypes.c_int])


def trace_rol_sc_plain(rays, tm, order, cons, t12, boxes, sc_box, tc: int,
                       any_hit: bool):
    """Plain PyTorch K5. The candidate lists (order/cons [nt, nsc_pad])
    hold superclusters; a live one (some ray of the tile enters its box)
    has each member cluster c0 + k, k < cnt (sc_box columns 6 and 7) culled
    on its own against the updated t_best — live when some ray enters the
    box and the tile's largest t_best is > 0 — and swept as in K2. All
    tiles advance slot by slot and member by member together, the ragged
    member counts masked. Returns (t, i, visits — the live member-cluster
    visits of each tile)."""
    K5.plain_runs += 1
    st = _TraceState(rays, tm, tc)
    n_clusters = boxes.shape[0]
    t12c = t12.view(12, n_clusters, tc)
    n_slots = order.shape[1]
    stop = st.stop_at(order, cons, 0)
    for slot in range(n_slots):
        run = ~stop
        if not bool(run.any()):
            break
        s = order[:, slot].long()
        srow = sc_box[s.clamp_min(0)]                          # [nt, 8]
        live_sc = st.box_hit(srow, any_hit).any(dim=1) & (s >= 0) & run
        c0 = srow[:, 6].to(torch.int64)
        cnt = torch.where(live_sc, srow[:, 7].to(torch.int64), 0)
        for k in range(int(cnt.max())):
            c = c0 + k
            box = boxes[torch.where(k < cnt, c, 0)]
            live = (st.box_hit(box, any_hit).any(dim=1)
                    & (st.t_best.amax(dim=1) > 0.0) & (k < cnt))
            st.sweep(live, c, t12c, any_hit)
        stop = stop | st.stop_at(order, cons, min(slot + 1, n_slots - 1))
    return st.t_best, st.i_best, st.visits


def trace_rol_sc(rays, tm, order, cons, t12, boxes, sc_box, tc: int,
                 any_hit: bool):
    """K5: trace a batch of ray tiles against their candidate
    superclusters (see ``trace_rol_sc_plain``). Returns (t, i, visits)."""
    if rays.device.type == "cpu":
        return trace_rol_sc_plain(rays, tm, order, cons, t12, boxes, sc_box,
                                  tc, any_hit)
    kb.check_cuda("trace_rol_sc", rays, tm, order, cons, t12, boxes, sc_box,
                  dtypes=(torch.float32, torch.float32, torch.int32,
                          torch.float32, torch.float32, torch.float32,
                          torch.float32))
    nt, _, rt = rays.shape
    if rt % 32 or rt > 1024 or tc & (tc - 1):
        raise ValueError(f"trace_rol_sc: ray tile {rt} / cluster size {tc} "
                         "unsupported")
    dev = rays.device
    t = torch.empty((nt, rt), dtype=torch.float32, device=dev)
    i = torch.empty((nt, rt), dtype=torch.int32, device=dev)
    visits = torch.empty(nt, dtype=torch.int32, device=dev)
    K5(kb.ptr(rays), kb.ptr(tm), kb.ptr(order), kb.ptr(cons), kb.ptr(t12),
       kb.ptr(boxes), kb.ptr(sc_box), kb.ptr(t), kb.ptr(i), kb.ptr(visits),
       nt, rt, order.shape[1], tc, t12.shape[1], int(any_hit))
    return t, i, visits


def _trace_rol_sc(o4, d4, tmax_col, t12, boxes, sc_box, tc, any_hit,
                  ray_tile):
    """Two-level trace of [b,4] rays: supercluster candidate lists (K1 on
    ``sc_box``), then K5. Returns (t [b,1], i [b,1])."""
    rt = ray_tile
    b = o4.shape[0]
    nt = b // rt
    rays = _pack_rays(o4, d4, rt)
    tm = tmax_col.reshape(nt, rt).contiguous()
    order, cons = tile_order(rays, tm, sc_box)
    t, i, _ = trace_rol_sc(rays, tm, order, cons, t12, boxes, sc_box, tc,
                           any_hit)
    return t.reshape(b, 1), i.reshape(b, 1)


# ---------------------------------------------------------------------------
# K9: rays-on-sublanes cluster trace
# ---------------------------------------------------------------------------

K9 = kb.Kernel("trace_ros", "trace_ros.cu", "trace_ros_launch",
               [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
               + [ctypes.c_longlong, ctypes.c_int])


def trace_ros_plain(o4, d4, tmax_col, order, cons, tx, ty, tz, boxes,
                    n_clusters: int, tc: int, any_hit: bool):
    """Plain PyTorch K9: K2's contract (``_walk_plain``) on the reference's
    rays-on-sublanes layouts — rays o4/d4 [b, 4] row-major, tmax [b, 1],
    per-tile order/cons [nt, ncl_pad], transforms as their x/y/z columns
    tx/ty/tz [4, Mpad]. Returns (t [b, 1] f32, i [b, 1] i32, visits [nt]
    i32)."""
    K9.plain_runs += 1
    b = o4.shape[0]
    nt = order.shape[0]
    rt = b // nt
    st = _TraceState(_pack_rays(o4, d4, rt), tmax_col.reshape(nt, rt), tc)
    t12c = torch.cat([tx, ty, tz]).view(12, n_clusters, tc)
    _walk_plain(st, order, cons, t12c, boxes, n_clusters, any_hit)
    return st.t_best.reshape(b, 1), st.i_best.reshape(b, 1), st.visits


def trace_ros(o4, d4, tmax_col, order, cons, tx, ty, tz, boxes,
              n_clusters: int, tc: int, any_hit: bool):
    """K9: trace [b, 4] rays, a tile of b / nt at a time, against their
    tiles' candidate clusters (see ``trace_ros_plain``). Returns (t, i,
    visits)."""
    if o4.device.type == "cpu":
        return trace_ros_plain(o4, d4, tmax_col, order, cons, tx, ty, tz,
                               boxes, n_clusters, tc, any_hit)
    kb.check_cuda("trace_ros", o4, d4, tmax_col, order, cons, tx, ty, tz,
                  boxes, dtypes=(torch.float32,) * 3
                  + (torch.int32,) + (torch.float32,) * 5)
    b = o4.shape[0]
    nt = order.shape[0]
    rt = b // nt if nt else 0
    if b != nt * rt or rt % 32 or rt > 1024 or tc & (tc - 1):
        raise ValueError(f"trace_ros: {b} rays in {nt} tiles / cluster size "
                         f"{tc} unsupported")
    dev = o4.device
    t = torch.empty((b, 1), dtype=torch.float32, device=dev)
    i = torch.empty((b, 1), dtype=torch.int32, device=dev)
    visits = torch.empty(nt, dtype=torch.int32, device=dev)
    K9(kb.ptr(o4), kb.ptr(d4), kb.ptr(tmax_col), kb.ptr(order), kb.ptr(cons),
       kb.ptr(tx), kb.ptr(ty), kb.ptr(tz), kb.ptr(boxes), kb.ptr(t),
       kb.ptr(i), kb.ptr(visits), nt, rt, order.shape[1], n_clusters, tc,
       tx.shape[1], int(any_hit))
    return t, i, visits


def _trace(o4, d4, tmax_col, scene_arrays, scene_static, any_hit, ray_tile):
    """Rays-on-sublanes trace of [b, 4] rays in lane order (the reference's
    ``_trace``, mxu_trace.py:1235-1277): candidate lists (K1), then
    K9. Returns (t [b, 1], i [b, 1])."""
    n_clusters, tc = scene_static
    tx, ty, tz, boxes = scene_arrays
    order, cons = _tile_order_v2(o4, d4, tmax_col, boxes, ray_tile)
    t, i, _ = trace_ros(o4.contiguous(), d4.contiguous(),
                        tmax_col.contiguous(), order, cons, tx, ty, tz,
                        boxes, n_clusters, tc, any_hit)
    return t, i


def _ros_tables(scene: MXUSceneT, flag: str):
    """The rays-on-sublanes trace's arguments, or the reference's refusal
    on slim tables (mxu_trace.py:1308-1310, core/trace.py:131-133)."""
    if scene.tx is None:
        raise ValueError(
            "rays-on-sublanes fallback unavailable on a slim MXUScene "
            "(vertex tables dropped at >64k tris; "
            f"{flag})")
    return ((scene.tx, scene.ty, scene.tz, scene.cluster_box),
            (scene.n_clusters, scene.cluster_size))


def _dispatch_trace(o4, d4, tmax_col, scene: MXUSceneT, any_hit,
                    ray_tile: int = RAY_TILE):
    """Select the trace kernel as the reference does (mxu_trace.py:
    1288-1314): with ``flags.ROL`` the two-level tier past SC_THRESHOLD
    clusters (K5) when the tables have superclusters, else the flat
    rays-on-lanes tier (K2; a tree cut by ``_cut_clusters_walk`` has no
    superclusters); without it the rays-on-sublanes kernel (K9), which
    slim tables cannot run."""
    if flags.ROL and scene.sc_box is not None \
            and scene.n_clusters > SC_THRESHOLD:
        return _trace_rol_sc(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                             scene.sc_box, scene.cluster_size, any_hit,
                             ROL_TILE)
    if flags.ROL:
        return _trace_rol(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                          (scene.n_clusters, scene.cluster_size), any_hit,
                          ROL_TILE)
    arrays, static = _ros_tables(scene, "use the ROL/SC kernels")
    return _trace(o4, d4, tmax_col, arrays, static, any_hit, ray_tile)


# ---------------------------------------------------------------------------
# Sorting and the pair trace
# ---------------------------------------------------------------------------

def _pad_rays(x, rt):
    n = x.shape[0]
    pad = (-n) % rt
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device)])
    return x, n


def _ray_inputs(orig: Vec3, d: Vec3, scene: MXUSceneT, t_max, ray_tile):
    """(o4 [b,4] centered origins with w=1, d4 [b,4] with w=0, tmax
    [b,1]), padded to a whole number of ray tiles."""
    n = orig.x.shape[0]
    dev = orig.x.device
    one = torch.ones(n, dtype=torch.float32, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    o4 = torch.stack([orig.x - scene.center[0], orig.y - scene.center[1],
                      orig.z - scene.center[2], one], dim=1)
    d4 = torch.stack([d.x, d.y, d.z, zero], dim=1)
    if t_max is None:
        tmax_col = torch.full((n, 1), float(F32_MAX), dtype=torch.float32,
                              device=dev)
    else:
        tmax_col = torch.as_tensor(t_max, dtype=torch.float32,
                                   device=dev).expand(n).reshape(n, 1)
    o4, _ = _pad_rays(o4, ray_tile)
    d4, _ = _pad_rays(d4, ray_tile)
    tmax_col, _ = _pad_rays(tmax_col, ray_tile)
    return o4, d4, tmax_col


def _exit_clamp(o4, d4, tmax_col, lo, hi):
    """Clamp each ray's tmax to its exit distance from the scene AABB (with
    a margin): escaping rays get tmax = 0 and sort into dead tail tiles."""
    o = o4[:, 0:3]
    dd = d4[:, 0:3]
    inv = 1.0 / torch.where(dd == 0.0, 1e-30, dd)
    t1 = (lo[None, :] - o) * inv
    t2 = (hi[None, :] - o) * inv
    tnear = torch.minimum(t1, t2).amax(dim=1)
    tfar = torch.maximum(t1, t2).amin(dim=1)
    exit_t = torch.where((tfar >= tnear) & (tfar > 0.0),
                         tfar * 1.001 + 1e-4, 0.0)
    return torch.minimum(tmax_col[:, 0], exit_t).reshape(-1, 1)


def _morton5(q):
    """Spread 5 bits of q to every 3rd bit position (int32)."""
    return ((q & 1) | ((q & 2) << 2) | ((q & 4) << 4)
            | ((q & 8) << 6) | ((q & 16) << 8))


def _sort_key(o4, d4, lo, hi):
    """Coherence key (major, minor): direction octant | origin morton (15
    bits), and a 7-bit-per-axis quantized direction."""
    d = d4[:, 0:3]
    o = o4[:, 0:3]
    i32 = torch.int32
    oct_ = ((d[:, 0] < 0).to(i32) | ((d[:, 1] < 0).to(i32) << 1)
            | ((d[:, 2] < 0).to(i32) << 2))
    ext = torch.clamp_min(hi - lo, 1e-30)
    qo = torch.clamp((o - lo[None, :]) / ext[None, :] * 31.0, 0.0, 31.0)
    qo = qo.to(i32)
    morton = (_morton5(qo[:, 0]) | (_morton5(qo[:, 1]) << 1)
              | (_morton5(qo[:, 2]) << 2))
    qd = torch.clamp((d * 0.5 + 0.5) * 127.0, 0.0, 127.0).to(i32)
    minor = (qd[:, 0] << 14) | (qd[:, 1] << 7) | qd[:, 2]
    return (oct_ << 15) | morton, minor


def _perm_apply(perm, cols):
    """Apply a row permutation to f32 columns with ONE stacked row gather."""
    g = torch.stack(cols, dim=1)[perm]
    return [g[:, k] for k in range(len(cols))]


def _perm_invert(sidx):
    """inv[sidx[j]] = j — the unsort permutation."""
    inv = torch.empty_like(sidx)
    inv[sidx] = torch.arange(sidx.shape[0], dtype=sidx.dtype,
                             device=sidx.device)
    return inv


def _perm_unsort2(sidx, t_col, i_col):
    """Restore (t f32, i int32) to original ray order with one stacked
    gather by the inverse permutation (the int column rides as bits)."""
    inv = _perm_invert(sidx)
    g = torch.stack([t_col, i_col.view(torch.float32)], dim=1)[inv]
    return g[:, 0], g[:, 1].contiguous().view(torch.int32)


def _sorted_trace(o4, d4, tmax_col, scene: MXUSceneT, any_hit,
                  ray_tile: int = RAY_TILE):
    """One ray set sorted by the coherence key, traced, and restored to
    lane order (the reference's single-set ``_sorted_trace``, mxu_trace.py:
    1406-1505, with its default key and sort-carried permutation). tmax is
    clamped to the scene exit first; rays left with tmax <= 0 sort last.
    Closest-hit sorts on the packed 30-bit key (kmaj << 12) | (kmin >> 9)
    and, when the caller gave no tmax (None), recomputes the clamp on the
    sorted rays. Any-hit sorts on both keys: one stable sort of the int64
    key (kmaj << 21) | kmin gives lax.sort(num_keys=2)'s order, kmin being
    below 2^21. The unsort gathers by the inverse permutation, as the
    reference's sort by the carried index does. Returns (t [b, 1],
    i [b, 1]); misses have t = F32_MAX."""
    b = o4.shape[0]
    dev = o4.device
    lo, hi = scene.lo, scene.hi
    fmax = torch.full((b, 1), float(F32_MAX), dtype=torch.float32,
                      device=dev)
    const_tmax = tmax_col is None
    tmax_col = _exit_clamp(o4, d4, fmax if const_tmax else tmax_col, lo, hi)
    kmaj, kmin = _sort_key(o4, d4, lo, hi)
    dead = tmax_col[:, 0] <= 0.0
    cols = [o4[:, 0], o4[:, 1], o4[:, 2], d4[:, 0], d4[:, 1], d4[:, 2]]
    if any_hit:
        kmaj = torch.where(dead, 0x7FFFFFFF, kmaj)
        key = (kmaj.to(torch.int64) << 21) | kmin.to(torch.int64)
        const_tmax = False
    else:
        key = torch.where(dead, 0x7FFFFFFF, (kmaj << 12) | (kmin >> 9))
    if not const_tmax:
        cols.append(tmax_col[:, 0])
    _, sidx = torch.sort(key, stable=True)
    g = _perm_apply(sidx, cols)
    o4s = torch.stack([g[0], g[1], g[2], torch.ones_like(g[0])], dim=1)
    d4s = torch.stack([g[3], g[4], g[5], torch.zeros_like(g[0])], dim=1)
    tm = (_exit_clamp(o4s, d4s, fmax, lo, hi) if const_tmax
          else g[6].reshape(b, 1))
    t, i = _dispatch_trace(o4s, d4s, tm, scene, any_hit, ray_tile)
    t_out, i_out = _perm_unsort2(sidx, t[:, 0], i[:, 0])
    t_out = torch.where(i_out >= 0, t_out, float(F32_MAX))
    return t_out.reshape(b, 1), i_out.reshape(b, 1)


def _single_trace(o4, d4, tmax_col, scene: MXUSceneT, any_hit, ray_tile,
                  const_tmax=False):
    """A single-set trace as the reference's entry points take it
    (mxu_trace.py:1615-1624, 2051-2059): sorted when ``flags.SORT_RAYS``,
    else the rays-on-sublanes kernel in lane order."""
    if flags.SORT_RAYS:
        return _sorted_trace(o4, d4, None if const_tmax else tmax_col,
                             scene, any_hit, ray_tile)
    arrays, static = _ros_tables(scene, "unset FLT_SORT_RAYS=0")
    return _trace(o4, d4, tmax_col, arrays, static, any_hit, ray_tile)


def closest_hit_mxu(orig: Vec3, d: Vec3, scene: MXUSceneT, t_max=None,
                    ray_tile: int = RAY_TILE):
    """Returns (t, tri_idx, u, v) like traverse.closest_hit."""
    t, tri, u, v, _ = closest_hit_mxu_full(orig, d, scene, t_max, ray_tile)
    return t, tri, u, v


def closest_hit_mxu_full(orig: Vec3, d: Vec3, scene: MXUSceneT, t_max=None,
                         ray_tile: int = RAY_TILE):
    """Returns (t, tri, u, v, col): the winner's original triangle id, and
    t, u, v recomputed from its transform row (``txy_t``). Slim tables
    without ``txy_t`` return the trace's packed t and u = v = 0, as the
    reference (mxu_trace.py:1628-1634)."""
    n = orig.x.shape[0]
    o4, d4, tmax_col = _ray_inputs(orig, d, scene, t_max, ray_tile)
    t, i = _single_trace(o4, d4, tmax_col, scene, False, ray_tile,
                         const_tmax=t_max is None)
    t = t[:n, 0]
    i = i[:n, 0]
    safe = i.clamp_min(0).long()
    tri = torch.where(i >= 0, scene.tri_map[safe], -1)
    if scene.txy_t is None:
        return t, tri, torch.zeros_like(t), torch.zeros_like(t), i
    tw = scene.txy_t[safe]                                  # [n, 12]
    O, D = o4[:n], d4[:n]

    def dot4(a, k):
        return a[:, 0] * tw[:, k] + a[:, 1] * tw[:, k + 1] \
            + a[:, 2] * tw[:, k + 2] + a[:, 3] * tw[:, k + 3]
    oz, dz = dot4(O, 8), dot4(D, 8)
    t = torch.where(i >= 0, -oz / torch.where(dz == 0.0, 1.0, dz), t)
    u = dot4(O, 0) + t * dot4(D, 0)
    v = dot4(O, 4) + t * dot4(D, 4)
    return t, tri, u, v, i


def any_hit_mxu(orig: Vec3, d: Vec3, t_max, scene: MXUSceneT,
                ray_tile: int = RAY_TILE):
    """Occlusion query. Returns bool [n]."""
    n = orig.x.shape[0]
    o4, d4, tmax_col = _ray_inputs(orig, d, scene, t_max, ray_tile)
    _, i = _single_trace(o4, d4, tmax_col, scene, True, ray_tile)
    return i[:n, 0] >= 0


def _sorted_trace_pair(eo4, ed4, so4, sd4, sh_tmax_col, scene: MXUSceneT):
    """Extension (closest-hit) and shadow (any-hit) traces under ONE
    shared coherence permutation: one stable sort of the packed 30-bit
    extension key plus one stacked row gather, two traces, one inverse-
    permutation unsort (the occlusion verdict rides bit 30 of the winner
    column). Returns (t [b,1], col [b,1], occluded [b]); misses have
    t = F32_MAX, col = -1."""
    b = eo4.shape[0]
    dev = eo4.device
    lo, hi = scene.lo, scene.hi
    with span("flt::trace.sort"):
        fmax = torch.full((b, 1), float(F32_MAX), dtype=torch.float32,
                          device=dev)
        sh_tm = _exit_clamp(so4, sd4, sh_tmax_col, lo, hi)
        kmaj, kmin = _sort_key(eo4, ed4, lo, hi)
        skey = (kmaj << 12) | (kmin >> 9)
        etm = _exit_clamp(eo4, ed4, fmax, lo, hi)
        skey = torch.where(etm[:, 0] <= 0.0, 0x7FFFFFFF, skey)
        _, sidx = torch.sort(skey, stable=True)
        srt = _perm_apply(sidx, [
            eo4[:, 0], eo4[:, 1], eo4[:, 2],
            ed4[:, 0], ed4[:, 1], ed4[:, 2],
            so4[:, 0], so4[:, 1], so4[:, 2],
            sd4[:, 0], sd4[:, 1], sd4[:, 2], sh_tm[:, 0]])
        ones = torch.ones(b, dtype=torch.float32, device=dev)
        zeros = torch.zeros(b, dtype=torch.float32, device=dev)
        eo4s = torch.stack([srt[0], srt[1], srt[2], ones], dim=1)
        ed4s = torch.stack([srt[3], srt[4], srt[5], zeros], dim=1)
        so4s = torch.stack([srt[6], srt[7], srt[8], ones], dim=1)
        sd4s = torch.stack([srt[9], srt[10], srt[11], zeros], dim=1)
        stm = srt[12]
        etm_s = _exit_clamp(eo4s, ed4s, fmax, lo, hi)
    with span("flt::trace.closest"):
        t_e, i_e = _dispatch_trace(eo4s, ed4s, etm_s, scene, False)
    with span("flt::trace.anyhit"):
        _, i_s = _dispatch_trace(so4s, sd4s, stm.reshape(b, 1), scene, True)
    with span("flt::trace.unsort"):
        packed = (i_e[:, 0] + 1) | torch.where(i_s[:, 0] >= 0, 1 << 30,
                                               0).to(torch.int32)
        t_out, p_out = _perm_unsort2(sidx, t_e[:, 0], packed)
        occ = (p_out >> 30) > 0
        col = (p_out & ((1 << 30) - 1)) - 1
        t_out = torch.where(col >= 0, t_out, float(F32_MAX))
    return t_out.reshape(b, 1), col.reshape(b, 1), occ


def trace_pair_mxu(eorig: Vec3, edir: Vec3, sorig: Vec3, sdir: Vec3,
                   sh_tmax, scene: MXUSceneT, ray_tile: int = RAY_TILE):
    """Extension closest-hit + shadow occlusion under one shared sort.
    Returns (t[n], col[n], occluded[n])."""
    n = eorig.x.shape[0]
    eo4, ed4, _ = _ray_inputs(eorig, edir, scene, None, ray_tile)
    so4, sd4, stm = _ray_inputs(sorig, sdir, scene, sh_tmax, ray_tile)
    t, col, occ = _sorted_trace_pair(eo4, ed4, so4, sd4, stm, scene)
    return t[:n, 0], col[:n, 0], occ[:n]


# ---------------------------------------------------------------------------
# K3 / K6 / K10: winner-attribute resolve
# ---------------------------------------------------------------------------

# past this many bytes of resolve tables (resolve_table_bytes) the
# reference streams them from HBM (K6) instead of keeping them resident
RESOLVE_RESIDENT_BYTES = 48 << 20

K3 = kb.Kernel("resolve_v5", "resolve_v5.cu", "resolve_v5_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int])
K6 = kb.Kernel("resolve_v5s", "resolve_v5s.cu", "resolve_v5s_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int])
K10 = kb.Kernel("resolve_v1", "resolve_v1.cu", "resolve_v1_launch",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2)


def _winner_tuv(o4, d4, tw):
    """Exact t, u, v of each ray against its winner's affine transform (tw
    [>=12, b]: the x, y, z rows of four coefficients), in the kernels'
    operation order (csrc/resolve_common.cuh ``tuv``)."""
    O, D = o4.T, d4.T

    def dot4(a, k):
        return a[0] * tw[k] + a[1] * tw[k + 1] + a[2] * tw[k + 2] \
            + a[3] * tw[k + 3]

    oz, dz = dot4(O, 8), dot4(D, 8)
    t = -oz / torch.where(dz == 0.0, 1.0, dz)
    ox, dx = dot4(O, 0), dot4(D, 0)
    oy, dy = dot4(O, 4), dot4(D, 4)
    return t, ox + t * dx, oy + t * dy


def _resolve_plain(col, o4, d4, b16r, t16r):
    """Gather each winner's B16 row and transform row, then the reference
    epilogue (_b16_epilogue_t). Returns [40, b]."""
    active = col >= 0
    safe = col.clamp_min(0).long()
    acc = b16r[safe].to(torch.float32).T                     # [128, b]
    t, u, v = _winner_tuv(o4, d4, t16r[safe].T)
    g = lambda a, w: acc[a:a + w]
    cf = g(B16.CF_HI, 15) + g(B16.CF_LO, 15)
    v0 = g(B16.V0_HI, 5) + g(B16.V0_LO, 5)
    v1 = g(B16.V1_HI, 5) + g(B16.V1_LO, 5)
    v2 = g(B16.V2_HI, 5) + g(B16.V2_LO, 5)
    vert = (1.0 - u - v) * v0 + u * v1 + v * v2
    c2 = lambda a: acc[a:a + 1] + acc[a + 1:a + 2] * 256.0
    c3 = lambda a: c2(a) + acc[a + 2:a + 3] * 65536.0
    wh = lambda cw, chh: c2(cw) * 4096.0 + c2(chh)
    res = torch.cat([
        vert,                                       # 0-4: N, UV
        c2(B16.MAT),                                # 5
        cf,                                         # 6-20
        c2(B16.TYPE),                               # 21
        c2(B16.MAP_KD) - 1.0,                       # 22 (stored +1)
        c2(B16.MAP_KS) - 1.0,                       # 23
        c2(B16.MAP_N) - 1.0,                        # 24
        c3(B16.TRI),                                # 25
        u[None], v[None], t[None],                  # 26-28
        wh(B16.TKD_W, B16.TKD_H), c3(B16.TKD_OFF),  # 29-30
        wh(B16.TKS_W, B16.TKS_H), c3(B16.TKS_OFF),  # 31-32
        wh(B16.TN_W, B16.TN_H), c3(B16.TN_OFF),     # 33-34
        torch.zeros((ATTR_COLS - 35, col.shape[0]), dtype=torch.float32,
                    device=col.device),
    ], dim=0)
    return torch.where(active[None, :], res, 0.0)


def _resolve_launch(kernel, col, o4, d4, b16r, t16r):
    kb.check_cuda(kernel.name, col, o4, d4, b16r, t16r,
                  dtypes=(torch.int32, torch.float32, torch.float32,
                          torch.bfloat16, torch.float32))
    b = col.shape[0]
    out = torch.empty((ATTR_COLS, b), dtype=torch.float32, device=col.device)
    kernel(kb.ptr(col), kb.ptr(o4), kb.ptr(d4), kb.ptr(b16r), kb.ptr(t16r),
           kb.ptr(out), b)
    return out


def resolve_v5_plain(col, o4, d4, b16r, t16r):
    """Plain PyTorch K3 (see ``_resolve_plain``)."""
    K3.plain_runs += 1
    return _resolve_plain(col, o4, d4, b16r, t16r)


def resolve_v5(col, o4, d4, b16r, t16r):
    """K3: winner attributes as the SoA [ATTR_COLS, b] matrix (see
    ``resolve_v5_plain``). col: int32 [b] winner column, -1 = miss."""
    if col.device.type == "cpu":
        return resolve_v5_plain(col, o4, d4, b16r, t16r)
    return _resolve_launch(K3, col, o4, d4, b16r, t16r)


def resolve_v5s_plain(col, o4, d4, b16r, t16r):
    """Plain PyTorch K6: K3's function (the reference's v5s differs from
    v5 only in how its tables reach the kernel)."""
    K6.plain_runs += 1
    return _resolve_plain(col, o4, d4, b16r, t16r)


def resolve_v5s(col, o4, d4, b16r, t16r):
    """K6: K3's contract for tables past RESOLVE_RESIDENT_BYTES, read with
    streaming loads (see csrc/resolve_v5s.cu)."""
    if col.device.type == "cpu":
        return resolve_v5s_plain(col, o4, d4, b16r, t16r)
    return _resolve_launch(K6, col, o4, d4, b16r, t16r)


def resolve_v1_plain(col, o4, d4, txy_t, attrs, tc: int):
    """Plain PyTorch K10: each winner's f32 transform row (txy_t [Mpad,
    12]) gives the exact t, u, v; its three vertex rows of ``attrs``
    [3 Mpad, 40] (cluster c = col // tc, row c 3tc + k tc + col % tc for
    vertex k) are interpolated column by column as ((1-u-v) a0 + u a1) +
    v a2 — material constants included, as the reference's weighted
    one-hot product does — and rows ATTR_HITU/V/T become u, v, t. A miss
    (col < 0) gives a zero column. Returns [40, b]."""
    K10.plain_runs += 1
    active = col >= 0
    safe = col.clamp_min(0).long()
    t, u, v = _winner_tuv(o4, d4, txy_t[safe].T)
    row = (safe // tc) * (3 * tc) + safe % tc
    a0, a1, a2 = (attrs[row + k * tc].T for k in range(3))   # [40, b]
    res = (1.0 - u - v) * a0 + u * a1 + v * a2
    res[ATTR_HITU] = u
    res[ATTR_HITV] = v
    res[ATTR_HITT] = t
    return torch.where(active[None, :], res, 0.0)


def resolve_v1(col, o4, d4, txy_t, attrs, tc: int):
    """K10: winner attributes from the f32 ``attrs`` table as the SoA
    [ATTR_COLS, b] matrix (see ``resolve_v1_plain``). The reference's
    kernel also takes the trace's t, which it does not read."""
    if col.device.type == "cpu":
        return resolve_v1_plain(col, o4, d4, txy_t, attrs, tc)
    kb.check_cuda("resolve_v1", col, o4, d4, txy_t, attrs,
                  dtypes=(torch.int32,) + (torch.float32,) * 4)
    b = col.shape[0]
    if txy_t.shape[1] != 12 or attrs.shape != (3 * txy_t.shape[0],
                                               ATTR_COLS):
        raise ValueError(f"resolve_v1: tables {tuple(txy_t.shape)} / "
                         f"{tuple(attrs.shape)} unsupported")
    out = torch.empty((ATTR_COLS, b), dtype=torch.float32, device=col.device)
    K10(kb.ptr(col), kb.ptr(o4), kb.ptr(d4), kb.ptr(txy_t), kb.ptr(attrs),
        kb.ptr(out), b, tc)
    return out


def resolve_hits_mxu(orig: Vec3, d: Vec3, t, col, scene: MXUSceneT,
                     ray_tile: int = RAY_TILE):
    """Per-ray winner attributes as the SoA matrix [ATTR_COLS, n] (ATTR_*
    rows), including the exact t and barycentric u, v. col: winner column
    (-1 = miss -> zero column). The reference's dispatch on what the tables
    hold (mxu_trace.py:2024-2042): with B16, K3 while the reference would
    keep its tables resident and K6 past that; without it, K10 on the f32
    ``attrs``; with neither, the reference's refusal."""
    n = col.shape[0]
    o4, d4, _ = _ray_inputs(orig, d, scene, None, ray_tile)
    col2, _ = _pad_rays(col.to(torch.int32), ray_tile)
    col2, o4, d4 = col2.contiguous(), o4.contiguous(), d4.contiguous()
    if scene.b16r is not None:
        resolve = (resolve_v5s if resolve_table_bytes(
            scene.n_clusters, scene.cluster_size) > RESOLVE_RESIDENT_BYTES
            else resolve_v5)
        out = resolve(col2, o4, d4, scene.b16r, scene.t16r)
    elif scene.attrs is not None:
        out = resolve_v1(col2, o4, d4, scene.txy_t, scene.attrs,
                         scene.cluster_size)
    else:
        raise ValueError(
            "slim MXUScene has only the B16 resolve (f32 attrs dropped): "
            "rebuild with slim=False for interpret-mode (CPU) debugging")
    return out[:, :n]
