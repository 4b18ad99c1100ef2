"""Bitstack BVH traversal: the port of the reference package's
accel/traverse.py, the trace of a scene without cluster tables
(``DeviceScene.mxu`` None, core/trace.py).

Each ray walks the flat BVH (accel/bvh.py: left child = node + 1, the
right child or a leaf's first index in ``right_or_start``) from the root
with the reference's bitstack (bvh.cl:10-230): a node index and two
64-bit stacks, one bit per level for "the left / the right child is still
to visit". An inner node tests both children's boxes and enters the
nearer first (``lt <= rt``: the left on a tie), pushing the other; a leaf
tests its ``n_prims`` triangles in the order of ``indices`` (the first of
equal ``t`` wins: strict ``<``); a dead end pops levels until a pushed
bit turns up (the sibling is entered) or both stacks are empty. Any-hit
ends a ray at its first occluder. A miss is ``tri = -1``.

Kernel (launched on CUDA tensors; its plain PyTorch twin runs on CPU
tensors):
  ``bvh_bitstack``  csrc/bvh_bitstack.cu  (ref ``_traverse``, a
  ``lax.while_loop`` in XLA, not a Pallas kernel): one thread per ray.

The plain version ``traverse_plain`` is the reference's lockstep state
machine: every ray advances one step per iteration of a
``while (~done).any()`` loop, masked by its mode (descend into an inner
node, test a leaf, backtrack). Its stacks are 32-bit words held in int64
tensors, so that every shift is logical (torch's ``>>`` on int32 is
arithmetic). A leaf's triangle tests run for the leaf lanes of the
iteration at once (gathered, [max_leaf, k]); their winner is then chosen
in the reference's order, one slot at a time.

``TrianglesDevice`` lives in core/trace.py; ``from .traverse import
TrianglesDevice`` works as the reference's import path does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernel_build as kb
from ..vec import Vec3, cross, dot
from .bvh import BVHArrays

F32_MAX = float(np.finfo(np.float32).max)
EPSILON = 1e-12   # intersect.cl:63
_WORD = 0xFFFFFFFF


def __getattr__(name):
    # the reference's import path of the triangle arrays; core/trace.py
    # imports this module, so the name is looked up when asked for
    if name == "TrianglesDevice":
        from ..core.trace import TrianglesDevice
        return TrianglesDevice
    raise AttributeError(name)


class BVHDevice(NamedTuple):
    """The flat BVH on the device (the reference's traverse.py:69-95):
    node boxes, ``right_or_start``, ``parent``, ``n_prims`` and the
    triangle ``indices`` as int32, and ``max_leaf``, the largest leaf (at
    least 1), as an int."""
    bmin: Vec3
    bmax: Vec3
    right_or_start: torch.Tensor
    parent: torch.Tensor
    n_prims: torch.Tensor
    indices: torch.Tensor
    max_leaf: int = 8

    @staticmethod
    def from_host(bvh: BVHArrays, *, device) -> "BVHDevice":
        col = lambda a, dt: torch.from_numpy(
            np.ascontiguousarray(a, dt)).to(device)
        v = lambda a: Vec3(*(col(a[:, k], np.float32) for k in range(3)))
        return BVHDevice(
            bmin=v(bvh.box_min), bmax=v(bvh.box_max),
            right_or_start=col(bvh.right_or_start.astype(np.int32),
                               np.int32),
            parent=col(bvh.parent, np.int32),
            n_prims=col(bvh.n_prims.astype(np.int32), np.int32),
            indices=col(bvh.indices.astype(np.int32), np.int32),
            max_leaf=max(1, bvh.max_leaf_size()))


# ---------------------------------------------------------------------------
# Primitive tests (intersect.cl ports)
# ---------------------------------------------------------------------------

def intersect_aabb(orig: Vec3, inv_dir: Vec3, bmin: Vec3, bmax: Vec3,
                   t_prev):
    """Slab test (intersect.cl:41-60), NaN-propagating min/max: an origin
    on a box plane under an infinite reciprocal gives NaN, and no hit.
    Returns (hit, tmin)."""
    t1 = (bmin - orig) * inv_dir
    t2 = (bmax - orig) * inv_dir
    mn, mx = torch.minimum, torch.maximum
    tmin = mx(mx(mn(t1.x, t2.x), mn(t1.y, t2.y)), mn(t1.z, t2.z))
    tmax = mn(mn(mx(t1.x, t2.x), mx(t1.y, t2.y)), mx(t1.z, t2.z))
    hit = (tmax >= 0.0) & (tmin <= tmax) & (tmin < t_prev)
    return hit, tmin


def intersect_triangle(orig: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore (intersect.cl:62-93). Returns (ok, t, u, v)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) >= EPSILON
    idet = 1.0 / torch.where(ok, det, 1.0)
    tvec = orig - v0
    u = dot(tvec, pvec) * idet
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * idet
    t = dot(e2, qvec) * idet
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= 0.0)
    return ok, t, u, v


# ---------------------------------------------------------------------------
# The 64-bit bitstack as two 32-bit words (lo, hi), each in an int64
# ---------------------------------------------------------------------------

def _shl(lo, hi):
    return (lo << 1) & _WORD, ((hi << 1) | (lo >> 31)) & _WORD


def _shr(lo, hi):
    return (lo >> 1) | ((hi << 31) & _WORD), hi >> 1


def _empty(lo, hi):
    return (lo | hi) == 0


def _gather(a: Vec3, idx) -> Vec3:
    return Vec3(a.x[idx], a.y[idx], a.z[idx])


def _rays(orig: Vec3, d: Vec3, t_max):
    """The rays' components as contiguous float32 [n] tensors, and t_max
    (a number or a tensor) broadcast to [n]."""
    n = orig.x.shape[0]
    dev = orig.x.device
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=dev).expand(n).contiguous()
    return (Vec3(f(orig.x), f(orig.y), f(orig.z)),
            Vec3(f(d.x), f(d.y), f(d.z)), f(t_max))


def traverse_plain(orig: Vec3, d: Vec3, tris, bvh: BVHDevice, t_max,
                   any_hit: bool, counts: bool = False):
    """Plain PyTorch ``_traverse`` (traverse.py:150-286). Returns (t, tri,
    u, v): closest hit, or for any-hit t = t_max, u = v = 0 and tri 1 on
    occluded rays, -1 elsewhere. With ``counts`` also the box tests and
    triangle tests of each ray (int64 [n] each: two per inner node
    entered, a leaf's ``n_prims``)."""
    K11.plain_runs += 1
    orig, d, t = _rays(orig, d, t_max)
    t = t.clone()             # the caller's t_max stays as it is
    n = t.shape[0]
    dev = t.device
    inv = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    n_nodes = bvh.parent.shape[0]
    n_idx = bvh.indices.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    top = torch.zeros(n, **i64)
    l_lo, l_hi, r_lo, r_hi = (torch.zeros(n, **i64) for _ in range(4))
    backtrack = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    box_tests = torch.zeros(n, **i64) if counts else None
    tri_tests = torch.zeros(n, **i64) if counts else None
    slots = torch.arange(bvh.max_leaf, **i64).view(-1, 1)
    while bool((~done).any()):
        topc = top.clamp(0, n_nodes - 1)
        nprims = bvh.n_prims[topc].long()
        ros = bvh.right_or_start[topc].long()
        par = bvh.parent[topc].long()
        descend = ~done & ~backtrack
        bt = ~done & backtrack
        is_leaf = descend & (nprims > 0)
        is_inner = descend & (nprims == 0)

        # ---- inner: test both children, enter the near one first
        li = topc + 1
        ri = ros.clamp(0, n_nodes - 1)
        lg = li.clamp(max=n_nodes - 1)    # a leaf's lanes are masked below
        lhit, lt = intersect_aabb(orig, inv, _gather(bvh.bmin, lg),
                                  _gather(bvh.bmax, lg), t)
        rhit, rt = intersect_aabb(orig, inv, _gather(bvh.bmin, ri),
                                  _gather(bvh.bmax, ri), t)
        lhit = lhit & is_inner
        rhit = rhit & is_inner
        both = lhit & rhit
        left_first = lt <= rt
        go_left = (both & left_first) | (lhit & ~rhit)
        go_right = (both & ~left_first) | (rhit & ~lhit)
        inner_descend = go_left | go_right
        sl_lo, sl_hi = _shl(torch.where(both & left_first, l_lo | 1, l_lo),
                            l_hi)
        sr_lo, sr_hi = _shl(torch.where(both & ~left_first, r_lo | 1, r_lo),
                            r_hi)

        # ---- leaf: the leaf lanes' triangle tests, [max_leaf, k]
        occluded = None
        lanes = is_leaf.nonzero()[:, 0]
        if lanes.numel():
            o, dd = _gather(orig, lanes), _gather(d, lanes)
            np_k = nprims[lanes]
            slot = (ros[lanes] + slots).clamp(0, n_idx - 1)
            tidx = bvh.indices[slot].long()
            ok, tt, uu, vv = intersect_triangle(
                o, dd, _gather(tris.v0, tidx), _gather(tris.e1, tidx),
                _gather(tris.e2, tidx))
            valid = (slots < np_k) & ok & (tt > 0.0)
            t_best = t[lanes]
            if any_hit:
                occ_k = (valid & (tt < t_best)).any(dim=0)
                occluded = torch.zeros(n, dtype=torch.bool, device=dev)
                occluded[lanes] = occ_k
            else:
                tri_b, u_b, v_b = tri[lanes], u[lanes], v[lanes]
                for j in range(bvh.max_leaf):
                    c = valid[j] & (tt[j] < t_best)
                    t_best = torch.where(c, tt[j], t_best)
                    tri_b = torch.where(c, tidx[j].int(), tri_b)
                    u_b = torch.where(c, uu[j], u_b)
                    v_b = torch.where(c, vv[j], v_b)
                t[lanes], tri[lanes] = t_best, tri_b
                u[lanes], v[lanes] = u_b, v_b
            if counts:
                tri_tests[lanes] += np_k.clamp(max=bvh.max_leaf)
        if counts:
            box_tests += 2 * is_inner.long()

        # ---- backtrack one level
        l_bit = (l_lo & 1) != 0
        r_bit = (r_lo & 1) != 0
        empty = _empty(l_lo, l_hi) & _empty(r_lo, r_hi)
        bt_done = bt & empty
        bt_l = bt & ~empty & l_bit
        bt_r = bt & ~empty & ~l_bit & r_bit
        bt_up = bt & ~empty & ~l_bit & ~r_bit
        bl_lo, bl_hi = _shl(l_lo & ~1, l_hi)      # enter the right sibling
        blr_lo, blr_hi = _shl(r_lo, r_hi)
        br_lo, br_hi = _shl(r_lo & ~1, r_hi)      # enter the left sibling
        brl_lo, brl_hi = _shl(l_lo, l_hi)
        up_l_lo, up_l_hi = _shr(l_lo, l_hi)       # pop one level
        up_r_lo, up_r_hi = _shr(r_lo, r_hi)

        w = torch.where
        top = w(go_left, li, w(go_right, ri, w(bt_l, ri, w(
            bt_r, topc + 1, w(bt_up, par, top)))))

        def pick(desc, a, b, up, cur):
            return w(inner_descend, desc, w(bt_l, a, w(bt_r, b, w(
                bt_up, up, cur))))
        l_lo, l_hi, r_lo, r_hi = (
            pick(sl_lo, bl_lo, brl_lo, up_l_lo, l_lo),
            pick(sl_hi, bl_hi, brl_hi, up_l_hi, l_hi),
            pick(sr_lo, blr_lo, br_lo, up_r_lo, r_lo),
            pick(sr_hi, blr_hi, br_hi, up_r_hi, r_hi))
        backtrack = (is_leaf | (is_inner & ~inner_descend)) | (
            backtrack & ~(bt_l | bt_r))
        done = done | bt_done
        if occluded is not None:
            done = done | occluded
            tri = w(occluded, 1, tri)
    if counts:
        return t, tri, u, v, box_tests, tri_tests
    return t, tri, u, v


K11 = kb.Kernel("bvh_bitstack", "bvh_bitstack.cu", "bvh_bitstack_launch",
                [ctypes.c_void_p] * 30 + [ctypes.c_int] * 5)


def traverse(orig: Vec3, d: Vec3, tris, bvh: BVHDevice, t_max,
             any_hit: bool):
    """The bitstack traversal of every ray (see ``traverse_plain``): the
    plain version on CPU tensors, the kernel on CUDA tensors. Returns
    (t, tri, u, v)."""
    if orig.x.device.type == "cpu":
        return traverse_plain(orig, d, tris, bvh, t_max, any_hit)
    orig, d, tmax = _rays(orig, d, t_max)
    n = tmax.shape[0]
    scene_f = (*bvh.bmin, *bvh.bmax, *tris.v0, *tris.e1, *tris.e2)
    scene_i = (bvh.right_or_start, bvh.parent, bvh.n_prims, bvh.indices)
    f32, i32 = torch.float32, torch.int32
    kb.check_cuda("bvh_bitstack", *orig, *d, tmax, *scene_f, *scene_i,
                  dtypes=(f32,) * (7 + len(scene_f)) + (i32,) * 4)
    dev = tmax.device
    t = torch.empty(n, dtype=f32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    tri = torch.empty(n, dtype=i32, device=dev)
    ptrs = [kb.ptr(a) for a in (*orig, *d, tmax, *scene_f, *scene_i,
                                t, tri, u, v)]
    K11(*ptrs, n, bvh.parent.shape[0], bvh.indices.shape[0], bvh.max_leaf,
        int(any_hit), variant="any_hit" if any_hit else "closest")
    return t, tri, u, v


def closest_hit(orig: Vec3, d: Vec3, tris, bvh: BVHDevice, t_max=None):
    """Closest hit. Returns (t, tri_idx, u, v); tri_idx = -1 on miss."""
    return traverse(orig, d, tris, bvh, F32_MAX if t_max is None else t_max,
                    any_hit=False)


def any_hit(orig: Vec3, d: Vec3, t_max, tris, bvh: BVHDevice):
    """Occlusion query. Returns a bool tensor."""
    return traverse(orig, d, tris, bvh, t_max, any_hit=True)[1] >= 0


def brute_force_closest(orig: Vec3, d: Vec3, tris):
    """O(N*M) closest hit over every triangle in index order (the
    traversal's yardstick in the tests). Returns (t, tri, u, v)."""
    n = orig.x.shape[0]
    dev = orig.x.device
    t_best = torch.full((n,), F32_MAX, dtype=torch.float32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(tris.v0.x.shape[0]):
        ok, t, u, v = intersect_triangle(orig, d, _gather(tris.v0, i),
                                         _gather(tris.e1, i),
                                         _gather(tris.e2, i))
        closer = ok & (t > 0.0) & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        tri_best = torch.where(closer, i, tri_best)
        u_best = torch.where(closer, u, u_best)
        v_best = torch.where(closer, v, v_best)
    return t_best, tri_best, u_best, v_best
