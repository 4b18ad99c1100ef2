"""SAH BVH builder and binary cache (the port's numpy copy of the SAH path
and the cache of the reference package's accel/bvh.py; its median split
modes are not ported).

Re-implements the reference's top-down full-sweep SAH builder
(src/bvh.cpp:237-440) with numpy-vectorized per-node sweeps: sort refs by
centroid along each axis (sortReferences, bvh.cpp:290-304), prefix/suffix AABB
scans replace the rightBoxes lookup (buildBoxLookup, bvh.cpp:361-369), and the
same cost model costBox=costTri=1 (bvh.hpp:70-74). Node layout matches
bvhnode.hpp:50-59: left child = node index + 1, explicit right child, leaves
hold (iStart, nPrims) into a triangle index list.

The binary cache is BVH::exportTo/importFrom's format (bvh.cpp:106-224),
byte for byte the reference package's, including the header quirk of
writing the *index* count in the node-count slot (bvh.cpp:214).
"""

from __future__ import annotations

import struct
import sys
from typing import NamedTuple

import numpy as np

MAX_LEAF_ELEMS = 8   # bvh.hpp:66
MAX_DEPTH = 64       # bvh.hpp:67
COST_BOX = 1.0
COST_TRI = 1.0


class BVHArrays(NamedTuple):
    """Flat BVH (host, numpy). Interior: right_or_start = right child index.
    Leaf (n_prims > 0): right_or_start = start into `indices`."""
    box_min: np.ndarray        # [Nn, 3] f32
    box_max: np.ndarray        # [Nn, 3] f32
    right_or_start: np.ndarray  # [Nn] uint32
    parent: np.ndarray          # [Nn] int32
    n_prims: np.ndarray         # [Nn] uint8
    indices: np.ndarray         # [K] uint32 triangle indices

    @property
    def num_nodes(self):
        return len(self.n_prims)

    def depth(self) -> int:
        """Edges from the root to the deepest node, by pointer jumping:
        ``dist[i]`` is the depth of node i less that of its ancestor
        ``anc[i]``; each pass doubles the jump, so log2(depth) passes."""
        n = self.num_nodes
        if n == 0:
            return 0
        anc = self.parent.astype(np.int64)
        anc[0] = 0
        dist = (np.arange(n) > 0).astype(np.int64)
        while anc.any():
            dist = dist + dist[anc]
            anc = anc[anc]
        return int(dist.max())


def _aabb_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def build_bvh(positions: np.ndarray, progress=None) -> BVHArrays:
    """positions: [M, 3, 3] triangle vertices. Returns flat BVH arrays.
    ``progress``, when given, is called with the number of leaves emitted
    so far before each interior node's children are built."""
    m = positions.shape[0]
    if m == 0:
        raise ValueError("empty scene")
    tri_min = positions.min(axis=1).astype(np.float32)  # [M,3]
    tri_max = positions.max(axis=1).astype(np.float32)
    centroid2 = tri_min + tri_max  # 2x centroid, the reference's sort key

    # ref arrays (reordered during build)
    ind = np.arange(m, dtype=np.uint32)

    nodes_bmin, nodes_bmax = [], []
    nodes_right, nodes_parent, nodes_nprims = [], [], []
    out_indices = []

    sys.setrecursionlimit(max(10000, 4 * m))

    def emit_node(bmin, bmax, parent):
        i = len(nodes_bmin)
        nodes_bmin.append(bmin)
        nodes_bmax.append(bmax)
        nodes_right.append(0)
        nodes_parent.append(parent)
        nodes_nprims.append(0)
        return i

    def build(sub: np.ndarray, parent: int, depth: int) -> int:
        """sub: positional index array into `ind` range — here we pass the
        actual ref ordering as an array of triangle indices directly."""
        bmin = tri_min[sub].min(axis=0)
        bmax = tri_max[sub].max(axis=0)
        node = emit_node(bmin, bmax, parent)
        k = len(sub)

        if k <= MAX_LEAF_ELEMS or depth >= MAX_DEPTH:
            nodes_nprims[node] = k
            nodes_right[node] = len(out_indices)
            out_indices.append(sub)
            return node

        order, i_split = _sah_split(sub, tri_min, tri_max, centroid2,
                                    bmin, bmax)
        sub = sub[order]
        left, right = sub[:i_split + 1], sub[i_split + 1:]
        if progress is not None:
            progress(len(out_indices))
        build(left, node, depth + 1)
        nodes_right[node] = len(nodes_bmin)
        build(right, node, depth + 1)
        return node

    def _sah_split(sub, tri_min, tri_max, centroid2, bmin, bmax):
        k = len(sub)
        best_cost = np.inf
        best_dim, best_i, best_order = 0, 0, None
        inv_parent_area = 1.0 / max(_aabb_area(bmin, bmax), 1e-30)
        for dim in range(3):
            order = np.lexsort((sub, centroid2[sub, dim]))
            s = sub[order]
            lo, hi = tri_min[s], tri_max[s]
            # prefix (left) sweep
            lmin = np.minimum.accumulate(lo, axis=0)
            lmax = np.maximum.accumulate(hi, axis=0)
            # suffix (right) sweep
            rmin = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
            la = _aabb_area(lmin[:-1], lmax[:-1])          # left = [0..s]
            ra = _aabb_area(rmin[1:], rmax[1:])            # right = [s+1..]
            counts = np.arange(1, k, dtype=np.float64)
            cost = (2.0 * COST_BOX + COST_TRI *
                    (counts * la + (k - counts) * ra) * inv_parent_area)
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost, best_dim, best_i, best_order = cost[i], dim, i, order
        if best_i == 0:  # "fix indexing" (bvh.cpp:427-437)
            best_i = 1
        return best_order, best_i

    root_sub = ind.copy()
    build(root_sub, -1, 0)

    indices = np.concatenate(out_indices).astype(np.uint32)
    # fix leaf iStart: emitted as chunk ordinal, convert to offsets
    starts = np.cumsum([0] + [len(c) for c in out_indices[:-1]])
    right = np.asarray(nodes_right, np.uint32)
    nprims = np.asarray(nodes_nprims, np.uint8)
    leaf_slots = nprims > 0
    right[leaf_slots] = starts[right[leaf_slots]]

    return BVHArrays(
        box_min=np.asarray(nodes_bmin, np.float32),
        box_max=np.asarray(nodes_bmax, np.float32),
        right_or_start=right,
        parent=np.asarray(nodes_parent, np.int32),
        n_prims=nprims,
        indices=indices)


# ---------------------------------------------------------------------------
# Binary cache (bvh.cpp:106-224 format)
# ---------------------------------------------------------------------------

# one packed little-endian node: box 6f, iStart/right u32, parent i32,
# nPrims u8 (33 bytes, no padding)
_NODE = np.dtype([("box_min", "<f4", 3), ("box_max", "<f4", 3),
                  ("right", "<u4"), ("parent", "<i4"), ("n_prims", "u1")])


def export_bvh(bvh: BVHArrays, path: str):
    """Write ``bvh`` in the reference's binary layout: index count, the
    indices, the index count again in the node-count slot (the reference's
    quirk, kept for byte compatibility), then the packed nodes."""
    nodes = np.empty(bvh.num_nodes, _NODE)
    nodes["box_min"] = bvh.box_min
    nodes["box_max"] = bvh.box_max
    nodes["right"] = bvh.right_or_start
    nodes["parent"] = bvh.parent
    nodes["n_prims"] = bvh.n_prims
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(bvh.indices)))
        f.write(bvh.indices.astype("<u4").tobytes())
        f.write(struct.pack("<I", len(bvh.indices)))
        f.write(nodes.tobytes())


def import_bvh(path: str) -> BVHArrays:
    """Read a binary cache: as many nodes as the header's count and the
    file both hold (the count slot carries the index count)."""
    with open(path, "rb") as f:
        data = f.read()
    (n_idx,) = struct.unpack_from("<I", data, 0)
    off = 4
    indices = np.frombuffer(data, "<u4", count=n_idx, offset=off).astype(
        np.uint32)
    off += 4 * n_idx
    (claimed,) = struct.unpack_from("<I", data, off)
    off += 4
    n_nodes = min(claimed, (len(data) - off) // _NODE.itemsize)
    nodes = np.frombuffer(data, _NODE, count=n_nodes, offset=off)
    return BVHArrays(
        box_min=nodes["box_min"].astype(np.float32),
        box_max=nodes["box_max"].astype(np.float32),
        right_or_start=nodes["right"].astype(np.uint32),
        parent=nodes["parent"].astype(np.int32),
        n_prims=nodes["n_prims"].astype(np.uint8),
        indices=indices)
