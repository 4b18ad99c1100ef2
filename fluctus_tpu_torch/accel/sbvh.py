"""SBVH, the spatial-split BVH (Stich et al. 2009): the port's numpy copy of
the reference package's accel/sbvh.py, after src/sbvh.cpp's semantics:

  * the object-split candidate by full-sweep SAH (sbvh.cpp:162-227), sorted
    by (2x centroid, triangle id) as ``np.lexsort`` orders it;
  * the spatial-split candidate by chopped binning over NUM_SPATIAL_BINS
    = 128 bins, tried only when the object split's children overlap by
    more than SPLIT_ALPHA times the root's area (sbvh.cpp:122-129,
    sbvh.hpp:36-43);
  * reference duplication with SAH unsplitting (sbvh.cpp:364-407);
  * triangle clipping against the split planes in float64
    (splitReference, sbvh.cpp:414-453).

The output is the SAH builder's flat layout (left child = i + 1), so the
binary cache and the cluster cut take it as they take an SAH tree; leaves
may hold duplicated triangle references. The tree must equal the
reference's node for node, so every sum, clip and tie order is kept term
for term. The renderer builds SBVH trees natively
(``native.build_sbvh_native``); this builder serves the tests.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

from .bvh import BVHArrays, _aabb_area

MAX_LEAF_ELEMS = 8
MIN_LEAF_ELEMS = 1
MAX_DEPTH = 64
MAX_SPATIAL_DEPTH = 48
NUM_SPATIAL_BINS = 128
SPLIT_ALPHA = 1e-5
COST_TRI = 1.0


class _Refs(NamedTuple):
    """A packet of references: triangle ids + clipped AABBs."""
    ind: np.ndarray    # [k] int64
    bmin: np.ndarray   # [k, 3]
    bmax: np.ndarray   # [k, 3]

    def take(self, order):
        return _Refs(self.ind[order], self.bmin[order], self.bmax[order])

    @property
    def k(self):
        return len(self.ind)


def _box_of(refs: _Refs):
    return refs.bmin.min(axis=0), refs.bmax.max(axis=0)


def _sah_object_split(refs: _Refs, node_sah: float):
    """Full-sweep object SAH over 3 axes (sbvh.cpp:162-227).
    Returns (cost, order, i, left_box, right_box)."""
    k = refs.k
    best = (np.inf, None, 0, None, None)
    best_tiebreak = np.inf
    cent = refs.bmin + refs.bmax
    for dim in range(3):
        order = np.lexsort((refs.ind, cent[:, dim]))
        lo = refs.bmin[order]
        hi = refs.bmax[order]
        lmin = np.minimum.accumulate(lo, axis=0)
        lmax = np.maximum.accumulate(hi, axis=0)
        rmin = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
        la = _aabb_area(lmin[:-1], lmax[:-1])
        ra = _aabb_area(rmin[1:], rmax[1:])
        counts = np.arange(1, k, dtype=np.float64)
        cost = node_sah + COST_TRI * (counts * la + (k - counts) * ra)
        tiebreak = counts ** 2 + (k - counts) ** 2
        i = int(np.argmin(cost))
        c = cost[i]
        if c < best[0] or (c == best[0] and tiebreak[i] < best_tiebreak):
            best = (c, order, i,
                    (lmin[i].copy(), lmax[i].copy()),
                    (rmin[i + 1].copy(), rmax[i + 1].copy()))
            best_tiebreak = tiebreak[i]
    return best


def _split_reference(tri_verts: np.ndarray, ref_bmin, ref_bmax, dim, coord):
    """Clip one triangle reference against plane x[dim]=coord
    (sbvh.cpp:414-453). tri_verts: [3,3]. Returns (lmin,lmax,rmin,rmax)."""
    lmin = np.full(3, np.inf)
    lmax = np.full(3, -np.inf)
    rmin = np.full(3, np.inf)
    rmax = np.full(3, -np.inf)
    for i in range(3):
        p1 = tri_verts[i]
        p2 = tri_verts[(i + 1) % 3]
        v0p, v1p = p1[dim], p2[dim]
        if v0p <= coord:
            lmin = np.minimum(lmin, p1)
            lmax = np.maximum(lmax, p1)
        if v0p >= coord:
            rmin = np.minimum(rmin, p1)
            rmax = np.maximum(rmax, p1)
        if (v0p < coord < v1p) or (v1p < coord < v0p):
            t = max(0.0, min(1.0, (coord - v0p) / (v1p - v0p)))
            x = p1 * (1.0 - t) + p2 * t
            lmin = np.minimum(lmin, x)
            lmax = np.maximum(lmax, x)
            rmin = np.minimum(rmin, x)
            rmax = np.maximum(rmax, x)
    lmax[dim] = coord
    rmin[dim] = coord
    # intersect with original ref bounds
    lmin = np.maximum(lmin, ref_bmin)
    lmax = np.minimum(lmax, ref_bmax)
    rmin = np.maximum(rmin, ref_bmin)
    rmax = np.minimum(rmax, ref_bmax)
    return lmin, lmax, rmin, rmax


def _clip_tri_slab(verts, ref_bmin, ref_bmax, dim, a, b):
    """Vectorized AABB of triangle geometry within slab a <= x[dim] <= b,
    intersected with the reference box. verts: [P,3,3]; a, b: [P].
    Equivalent to the reference's incremental chop (splitReference applied
    at successive planes, sbvh.cpp:274-290). Returns (bmin [P,3], bmax)."""
    p = verts.shape[0]
    mn = np.full((p, 3), np.inf)
    mx = np.full((p, 3), -np.inf)
    x = verts[:, :, dim]                       # [P,3]
    inside = (x >= a[:, None]) & (x <= b[:, None])
    for i in range(3):
        m = inside[:, i, None]
        v = verts[:, i]
        mn = np.where(m, np.minimum(mn, v), mn)
        mx = np.where(m, np.maximum(mx, v), mx)
    for (i, j) in ((0, 1), (1, 2), (2, 0)):
        xi, xj = x[:, i], x[:, j]
        denom = xj - xi
        safe = np.where(denom == 0.0, 1.0, denom)
        vi, vj = verts[:, i], verts[:, j]
        for plane in (a, b):
            t = (plane - xi) / safe
            valid = (denom != 0.0) & (t > 0.0) & (t < 1.0)
            pt = vi + t[:, None] * (vj - vi)
            m = valid[:, None]
            mn = np.where(m, np.minimum(mn, pt), mn)
            mx = np.where(m, np.maximum(mx, pt), mx)
    # clamp the slab axis exactly and intersect with the reference box
    mn[:, dim] = np.maximum(mn[:, dim], a)
    mx[:, dim] = np.minimum(mx[:, dim], b)
    mn = np.maximum(mn, ref_bmin)
    mx = np.minimum(mx, ref_bmax)
    return mn, mx


def _bin_split(tris: np.ndarray, refs: _Refs, node_bmin, node_bmax,
               node_sah: float):
    """Chopped-binning spatial split search (sbvh.cpp:247-328), fully
    vectorized over (reference, bin) pairs. Returns (cost, dim, pos)."""
    k = refs.k
    origin = node_bmin
    extent = node_bmax - node_bmin
    bin_size = extent / NUM_SPATIAL_BINS
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_bin = np.where(bin_size > 0, 1.0 / bin_size, 0.0)

    first = np.clip(((refs.bmin - origin) * inv_bin).astype(np.int64),
                    0, NUM_SPATIAL_BINS - 1)
    last = np.clip(((refs.bmax - origin) * inv_bin).astype(np.int64),
                   first, NUM_SPATIAL_BINS - 1)

    best = (np.inf, -1, 0.0)
    for dim in range(3):
        if bin_size[dim] <= 0:
            continue
        bb_min = np.full((NUM_SPATIAL_BINS, 3), np.inf)
        bb_max = np.full((NUM_SPATIAL_BINS, 3), -np.inf)
        entering = np.zeros(NUM_SPATIAL_BINS, np.int64)
        exiting = np.zeros(NUM_SPATIAL_BINS, np.int64)

        f = first[:, dim]
        l = last[:, dim]
        np.add.at(entering, f, 1)
        np.add.at(exiting, l, 1)

        # single-bin references: pure scatter-reduce
        single = f == l
        if single.any():
            for c in range(3):
                np.minimum.at(bb_min[:, c], f[single], refs.bmin[single, c])
                np.maximum.at(bb_max[:, c], f[single], refs.bmax[single, c])

        # straddling references: expand to (ref, bin) pairs, clip vectorized
        straddle = np.nonzero(~single)[0]
        if len(straddle):
            spans = (l[straddle] - f[straddle] + 1)
            ref_idx = np.repeat(straddle, spans)
            # bin index within each span
            offs = np.concatenate([np.arange(s) for s in spans])
            bin_idx = f[ref_idx] + offs
            a = origin[dim] + bin_size[dim] * bin_idx
            b = a + bin_size[dim]
            verts = tris[refs.ind[ref_idx]]
            mn, mx = _clip_tri_slab(verts, refs.bmin[ref_idx],
                                    refs.bmax[ref_idx], dim, a, b)
            ok = (mn <= mx).all(axis=1)
            for c in range(3):
                np.minimum.at(bb_min[:, c], bin_idx[ok], mn[ok, c])
                np.maximum.at(bb_max[:, c], bin_idx[ok], mx[ok, c])

        # sweep (vectorized)
        rmin_s = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
        rmax_s = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
        lmin_s = np.minimum.accumulate(bb_min, axis=0)
        lmax_s = np.maximum.accumulate(bb_max, axis=0)
        left_n = np.cumsum(entering)
        right_n = k - np.cumsum(exiting)
        with np.errstate(invalid="ignore"):
            la = _aabb_area(lmin_s[:-1], lmax_s[:-1])
            ra = _aabb_area(rmin_s[1:], rmax_s[1:])
            sah = node_sah + la * left_n[:-1] + ra * right_n[:-1]
        sah = np.where(np.isfinite(la) & np.isfinite(ra), sah, np.inf)
        i = int(np.argmin(sah))
        if sah[i] < best[0]:
            best = (float(sah[i]), dim,
                    float(origin[dim] + bin_size[dim] * (i + 1)))
    return best


def _partition_spatial(tris, refs: _Refs, dim, pos):
    """Distribute refs about the plane, duplicating or unsplitting
    (sbvh.cpp:332-411). Returns (left_refs, right_refs) or None if one side
    is empty."""
    fully_left = refs.bmax[:, dim] <= pos
    fully_right = refs.bmin[:, dim] >= pos
    straddle = ~fully_left & ~fully_right

    l_ind = [refs.ind[fully_left]]
    l_bmin = [refs.bmin[fully_left]]
    l_bmax = [refs.bmax[fully_left]]
    r_ind = [refs.ind[fully_right]]
    r_bmin = [refs.bmin[fully_right]]
    r_bmax = [refs.bmax[fully_right]]

    lbox_min = refs.bmin[fully_left].min(axis=0) if fully_left.any() else np.full(3, np.inf)
    lbox_max = refs.bmax[fully_left].max(axis=0) if fully_left.any() else np.full(3, -np.inf)
    rbox_min = refs.bmin[fully_right].min(axis=0) if fully_right.any() else np.full(3, np.inf)
    rbox_max = refs.bmax[fully_right].max(axis=0) if fully_right.any() else np.full(3, -np.inf)

    n_left = int(fully_left.sum())
    n_right = int(fully_right.sum())

    ls_i, ls_min, ls_max = [], [], []
    rs_i, rs_min, rs_max = [], [], []
    for ri in np.nonzero(straddle)[0]:
        verts = tris[refs.ind[ri]]
        lmin, lmax, rmin, rmax = _split_reference(
            verts, refs.bmin[ri], refs.bmax[ri], dim, pos)

        # candidate boxes (sbvh.cpp:370-388)
        lub_min = np.minimum(lbox_min, refs.bmin[ri])
        lub_max = np.maximum(lbox_max, refs.bmax[ri])
        rub_min = np.minimum(rbox_min, refs.bmin[ri])
        rub_max = np.maximum(rbox_max, refs.bmax[ri])
        ldb_min = np.minimum(lbox_min, lmin)
        ldb_max = np.maximum(lbox_max, lmax)
        rdb_min = np.minimum(rbox_min, rmin)
        rdb_max = np.maximum(rbox_max, rmax)

        lac = COST_TRI * n_left
        rac = COST_TRI * n_right
        lbc = COST_TRI * (n_left + 1)
        rbc = COST_TRI * (n_right + 1)

        area = lambda mn, mx: _aabb_area(mn, mx) if np.isfinite(mn).all() else 0.0
        unsplit_left = area(lub_min, lub_max) * lbc + area(rbox_min, rbox_max) * rac
        unsplit_right = area(lbox_min, lbox_max) * lac + area(rub_min, rub_max) * rbc
        duplicate = area(ldb_min, ldb_max) * lbc + area(rdb_min, rdb_max) * rbc
        m = min(unsplit_left, unsplit_right, duplicate)

        if m == unsplit_left:
            ls_i.append(refs.ind[ri])
            ls_min.append(refs.bmin[ri])
            ls_max.append(refs.bmax[ri])
            lbox_min, lbox_max = lub_min, lub_max
            n_left += 1
        elif m == unsplit_right:
            rs_i.append(refs.ind[ri])
            rs_min.append(refs.bmin[ri])
            rs_max.append(refs.bmax[ri])
            rbox_min, rbox_max = rub_min, rub_max
            n_right += 1
        else:
            ls_i.append(refs.ind[ri])
            ls_min.append(lmin)
            ls_max.append(lmax)
            rs_i.append(refs.ind[ri])
            rs_min.append(rmin)
            rs_max.append(rmax)
            lbox_min, lbox_max = ldb_min, ldb_max
            rbox_min, rbox_max = rdb_min, rdb_max
            n_left += 1
            n_right += 1

    def cat(parts_i, parts_min, parts_max, extra_i, extra_min, extra_max):
        ind = np.concatenate(parts_i + ([np.array(extra_i, np.int64)] if extra_i else []))
        bmin = np.concatenate(parts_min + ([np.array(extra_min)] if extra_min else []))
        bmax = np.concatenate(parts_max + ([np.array(extra_max)] if extra_max else []))
        return _Refs(ind, bmin, bmax)

    left = cat(l_ind, l_bmin, l_bmax, ls_i, ls_min, ls_max)
    right = cat(r_ind, r_bmin, r_bmax, rs_i, rs_min, rs_max)
    if left.k == 0 or right.k == 0:
        return None
    return left, right


def build_sbvh(positions: np.ndarray, max_leaf: int = MAX_LEAF_ELEMS,
               progress=None) -> BVHArrays:
    """positions: [M, 3, 3]. Returns flat BVHArrays (same layout as SAH)."""
    m = positions.shape[0]
    tris = np.asarray(positions, np.float64)
    tri_min = tris.min(axis=1)
    tri_max = tris.max(axis=1)

    root_refs = _Refs(np.arange(m, dtype=np.int64), tri_min.copy(),
                      tri_max.copy())
    root_min, root_max = _box_of(root_refs)
    min_overlap = _aabb_area(root_min, root_max) * SPLIT_ALPHA

    nodes_bmin, nodes_bmax = [], []
    nodes_right, nodes_parent, nodes_nprims = [], [], []
    out_indices = []
    stats = dict(duplicates=0, splits=0, spatial=0)

    sys.setrecursionlimit(max(10000, 8 * m))

    def emit(bmin, bmax, parent):
        i = len(nodes_bmin)
        nodes_bmin.append(np.asarray(bmin, np.float32))
        nodes_bmax.append(np.asarray(bmax, np.float32))
        nodes_right.append(0)
        nodes_parent.append(parent)
        nodes_nprims.append(0)
        return i

    def make_leaf(node, refs: _Refs):
        nodes_nprims[node] = refs.k
        nodes_right[node] = len(out_indices)
        out_indices.append(refs.ind.astype(np.uint32))

    def build(refs: _Refs, parent: int, depth: int) -> int:
        bmin, bmax = _box_of(refs)
        node = emit(bmin, bmax, parent)
        k = refs.k

        if k <= MIN_LEAF_ELEMS or depth >= MAX_DEPTH:
            make_leaf(node, refs)
            return node

        parent_area = _aabb_area(bmin, bmax)
        node_sah = parent_area + parent_area  # 2 * costBox * area

        obj_cost, order, i_split, lb, rb = _sah_object_split(refs, node_sah)

        spatial_cost, sp_dim, sp_pos = np.inf, -1, 0.0
        if depth < MAX_SPATIAL_DEPTH and lb is not None:
            # overlap of object-split children (sbvh.cpp:125-128)
            ov_min = np.maximum(lb[0], rb[0])
            ov_max = np.minimum(lb[1], rb[1])
            if (ov_max >= ov_min).all() and \
                    _aabb_area(ov_min, ov_max) >= min_overlap:
                spatial_cost, sp_dim, sp_pos = _bin_split(
                    tris, refs, bmin, bmax, node_sah)

        leaf_cost = parent_area * k * COST_TRI
        min_cost = min(obj_cost, spatial_cost, leaf_cost)
        if min_cost == leaf_cost and k <= max_leaf:
            make_leaf(node, refs)
            return node

        parts = None
        if min_cost == spatial_cost:
            parts = _partition_spatial(tris, refs, sp_dim, sp_pos)
            if parts is not None:
                stats["spatial"] += 1
        if parts is None:
            ordered = refs.take(order)
            parts = (_Refs(ordered.ind[:i_split + 1],
                           ordered.bmin[:i_split + 1],
                           ordered.bmax[:i_split + 1]),
                     _Refs(ordered.ind[i_split + 1:],
                           ordered.bmin[i_split + 1:],
                           ordered.bmax[i_split + 1:]))

        left, right = parts
        stats["splits"] += 1
        stats["duplicates"] += left.k + right.k - k
        if progress is not None:
            progress(len(out_indices))

        build(left, node, depth + 1)
        nodes_right[node] = len(nodes_bmin)
        build(right, node, depth + 1)
        return node

    build(root_refs, -1, 0)

    indices = np.concatenate(out_indices).astype(np.uint32)
    starts = np.cumsum([0] + [len(c) for c in out_indices[:-1]])
    right = np.asarray(nodes_right, np.uint32)
    nprims = np.asarray(nodes_nprims, np.uint8)
    leaf_slots = nprims > 0
    right[leaf_slots] = starts[right[leaf_slots]]

    print(f"SBVH: {stats['splits']} splits ({stats['spatial']} spatial), "
          f"{stats['duplicates']} duplicates "
          f"({stats['duplicates'] * 100.0 / max(m, 1):.1f}%)")

    return BVHArrays(
        box_min=np.asarray(nodes_bmin, np.float32),
        box_max=np.asarray(nodes_bmax, np.float32),
        right_or_start=right,
        parent=np.asarray(nodes_parent, np.int32),
        n_prims=nprims,
        indices=indices)
