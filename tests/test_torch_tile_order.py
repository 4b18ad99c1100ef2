"""K1 tile_order as redesigned for Hopper (fluctus_tpu_torch/csrc/
tile_order.cu, the per-tile sort fused in), checked on the CPU, where no
CUDA kernel runs: a numpy model of the kernel, step for step, against
``_candidate_order(tile_order_plain(...))`` — order and skey bit for bit —
on the edge-case calls chip_smoke.py hands the kernel on the card
(k1_edge_inputs: NaN, +-0, +-inf and subnormal direction components,
origins on box faces, tmax 0 / negative / +inf / NaN, an all-culled tile,
ties at 0.0, one box, box counts not a multiple of 8). The model covers:

  (a) the rays-per-thread minimum: thread t holds lanes t + k * threads;
  (b) the slab's min/max as PTX min.NaN / max.NaN: a NaN term makes the
      test miss, as the plain version's NaN-propagating minimum/maximum;
      the boxes' axes ordered low to high, and the octant path of warps
      whose rays share the sign bits of their reciprocal directions (the
      near plane of each axis picked, four min/max per pair);
  (c) per thread the minimum over its rays of hit ? tnear : 1e30 (not
      capped at 1e30: a bound past it survives where every ray enters), then
      max(bits as int, 0) (+0.0 for a minimum <= 0, -0.0 included), folded
      as unsigned bits per warp (__reduce_min_sync) and across warps
      (shared atomicMin);
  (d) the stable rank sort by (bound, index).
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch.accel import mxu_trace as tmt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card's edge-case inputs)

CULL_BITS = np.float32(1e30).view(np.uint32)
NEG_ZERO_BITS = np.uint32(0x80000000)

_SUB = np.float32(np.finfo(np.float32).smallest_subnormal)
SPECIAL = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, _SUB, -_SUB, 1e-40,
                    1.0, -1.0, 2.5, -0.5, 3.4028235e38], np.float32)


def _nan_min(a, b):
    """PTX min.NaN.f32: NaN if either operand is NaN."""
    return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan),
                    np.minimum(a, b))


def _nan_max(a, b):
    return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan),
                    np.maximum(a, b))


def _safe_inv(d):
    with np.errstate(over="ignore", divide="ignore"):
        return np.float32(1.0) / np.where(d == 0.0, np.float32(1e-30), d)


def _slab(lo, hi, o, inv, tmax, near=None):
    """(b): the slab test of boxes (lo [ncl, 3], hi [ncl, 3]) against rays
    o/inv [3, ...], tmax [...] -> (tnear, hit), [ncl, ...]. The plain
    version's ten min/max; or, given ``near`` ([3, ...] bools, the sign
    bits of inv: the high plane is the near one), the octant path's four
    on the planes it picks."""
    sh = (slice(None),) + (None,) * tmax.ndim
    with np.errstate(invalid="ignore", over="ignore"):
        a = [(lo[:, k][sh] - o[k]) * inv[k] for k in range(3)]
        b = [(hi[:, k][sh] - o[k]) * inv[k] for k in range(3)]
        if near is None:
            n = [_nan_min(x, y) for x, y in zip(a, b)]
            f = [_nan_max(x, y) for x, y in zip(a, b)]
        else:
            n = [np.where(s, y, x) for s, x, y in zip(near, a, b)]
            f = [np.where(s, x, y) for s, x, y in zip(near, a, b)]
        tnear = _nan_max(_nan_max(n[0], n[1]), n[2])
        tfar = _nan_min(_nan_min(f[0], f[1]), f[2])
        hit = (tfar >= 0.0) & (tnear <= tfar) & (tnear < tmax)
    return tnear.astype(np.float32), hit


def _ordered_boxes(boxes):
    """(1): each axis low to high (NaN compares false and stays)."""
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    swap = lo > hi
    return np.where(swap, hi, lo), np.where(swap, lo, hi)


def _entry_bits(m):
    """(c): max(bits as int32, 0) of a minimum m: the bits of m > 0, 0 for
    m <= 0 (-0.0 included), as uint32."""
    return np.maximum(m.astype(np.float32).view(np.int32), 0).astype(
        np.uint32)


def _rank_sort(bound):
    """(d): slot of bound i = #{j < i : b_j <= b_i} + #{j > i : b_j < b_i}
    (unsigned bits). Returns (order, skey)."""
    n = bound.shape[0]
    i = np.arange(n)
    le = bound[None, :] <= bound[:, None]            # [i, j]: b_j <= b_i
    lt = bound[None, :] < bound[:, None]
    rank = np.where(i[None, :] < i[:, None], le, lt).sum(axis=1)
    skey = np.empty(n, np.float32)
    order = np.empty(n, np.int32)
    key = bound.view(np.float32)
    skey[rank] = key
    order[rank] = np.where(key >= np.float32(1e30), -1, i)
    return order, skey


def k1_model(rays, tm, boxes, rays_per_thread, paths=None):
    """csrc/tile_order.cu in numpy: per tile, threads = rt / rays per thread
    (halved until it is a multiple of 32 x rays per thread, as the
    launcher does), each holding lanes t + k * threads; a warp whose rays
    share one octant (the sign bits of inv) takes the octant path. Counts
    the warps of each path into ``paths`` when given."""
    nt, _, rt = rays.shape
    ncl = boxes.shape[0]
    ncl_pad = ncl + (-ncl) % 8
    rpt = rays_per_thread
    while rt % (32 * rpt):
        rpt //= 2
    nthreads = rt // rpt
    lanes = np.arange(nthreads)[:, None] + np.arange(rpt)[None, :] * nthreads
    lo, hi = _ordered_boxes(boxes)
    order = np.empty((nt, ncl_pad), np.int32)
    skey = np.empty((nt, ncl_pad), np.float32)
    for tile in range(nt):
        # (a) the thread's rays, [nthreads, rpt]
        o = rays[tile, 0:3][:, lanes]
        inv = _safe_inv(rays[tile, 4:7][:, lanes])
        sign = inv.view(np.uint32) >> 31                      # [3, th, r]
        octs = (sign[0] | sign[1] << 1 | sign[2] << 2).reshape(-1, 32 * rpt)
        uniform = (octs == octs[:, :1]).all(axis=1)           # per warp
        if paths is not None:
            paths["octant"] += int(uniform.sum())
            paths["plain"] += int((~uniform).sum())
        tnear, hit = _slab(lo, hi, o, inv, tm[tile][lanes])   # [ncl, th, r]
        near = np.broadcast_to(sign[:, ::32, None, :1],    # lane 0's
                               (3, nthreads // 32, 32, rpt)).reshape(
                                   sign.shape).astype(bool)
        tn_o, hit_o = _slab(lo, hi, o, inv, tm[tile][lanes], near=near)
        by_warp = np.repeat(uniform, 32)[None, :, None]
        tnear = np.where(by_warp, tn_o, tnear)
        hit = np.where(by_warp, hit_o, hit)
        m = np.full(tnear.shape[:2], np.inf, np.float32)
        for k in range(rpt):                       # registers, from +inf
            m = np.fmin(m, np.where(hit[..., k], tnear[..., k],
                                    np.float32(1e30)))
        e = _entry_bits(m)
        w = e.reshape(ncl, nthreads // 32, 32).min(axis=2)   # per warp
        sbound = np.full(ncl_pad, CULL_BITS, np.uint32)
        sbound[:ncl] = 0xFFFFFFFF                  # above every entry
        for k in range(w.shape[1]):                # atomicMin per warp
            sbound[:ncl] = np.minimum(sbound[:ncl], w[:, k])
        order[tile], skey[tile] = _rank_sort(sbound)
    return order, skey


def _plain(rays, tm, boxes):
    out = tmt._candidate_order(tmt.tile_order_plain(
        torch.from_numpy(rays), torch.from_numpy(tm), torch.from_numpy(boxes)))
    return out[0].numpy(), out[1].numpy()


# (boxes, tiles, rays per tile): one box, a count not a multiple of 8,
# luxball's cluster count, tiles of 96 and 64 rays, many boxes
CALLS = [(1, 6, 128), (13, 6, 128), (33, 8, 128), (33, 6, 96), (40, 4, 64),
         (300, 4, 64)]


@pytest.mark.parametrize("rays_per_thread", [1, 2, 4, 8])
@pytest.mark.parametrize("ncl,nt,rt", CALLS)
def test_k1_model_matches_plain(ncl, nt, rt, rays_per_thread):
    """The fused K1, modelled step for step, equals the plain version's
    candidate lists bit for bit on the edge-case inputs."""
    rays, tm, boxes = chip_smoke.k1_edge_inputs(ncl, nt, rt, seed=ncl + rt)
    paths = {"octant": 0, "plain": 0}
    order, skey = k1_model(rays, tm, boxes, rays_per_thread, paths)
    ref_order, ref_skey = _plain(rays, tm, boxes)
    assert paths["octant"] > 0 and paths["plain"] > 0
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_array_equal(skey.view(np.int32),
                                  ref_skey.view(np.int32))
    assert (order[-1] == -1).all()                 # the all-culled tile
    assert (skey[-2] == 0.0).any()                 # ties at 0.0
    assert not (skey.view(np.uint32) == NEG_ZERO_BITS).any()


def test_k1_edge_inputs_reach_negative_zero_and_past_the_cull():
    """The edge-case calls hold rays that enter a box at tnear = -0.0 (an
    origin on its face): raw -0.0 bits would order after every bound, even
    1e30, as unsigned integers; the entry is +0.0 instead, in the model
    and in the plain version. They also hold a tile whose rays all enter
    a box past 1e30, whose bound is then past 1e30 too."""
    rays, tm, boxes = chip_smoke.k1_edge_inputs(33, 8, 128, seed=3)
    o = rays[:, 0:3].transpose(1, 0, 2)                     # [3, nt, rt]
    inv = _safe_inv(rays[:, 4:7].transpose(1, 0, 2))
    tnear, hit = _slab(*_ordered_boxes(boxes), o, inv, tm)
    neg_zero = hit & (tnear.view(np.uint32) == NEG_ZERO_BITS)
    assert neg_zero.sum() > 0
    assert (_entry_bits(tnear[neg_zero]) == 0).all()
    assert NEG_ZERO_BITS > CULL_BITS
    cons = tmt.tile_order_plain(torch.from_numpy(rays), torch.from_numpy(tm),
                                torch.from_numpy(boxes)).numpy()
    assert not (cons.view(np.uint32) == NEG_ZERO_BITS).any()
    assert (cons[-3] > 1e30).any() and (cons[:-3] >= 1e30).all(axis=0).any()


def test_k1_nan_test_on_special_values():
    """(b): every combination of special values as a direction component
    and as an origin component (NaN, +-0, +-inf, +-subnormal, 1e-40 whose
    inverse overflows, large): the model's entry equals the plain
    version's bound for a one-ray, one-box tile."""
    d, o = np.meshgrid(SPECIAL, SPECIAL, indexing="ij")
    n = d.size
    rays = np.zeros((n, 8, 1), np.float32)
    rays[:, 0, 0], rays[:, 1, 0], rays[:, 2, 0] = o.ravel(), 0.25, 0.5
    rays[:, 4, 0], rays[:, 5, 0], rays[:, 6, 0] = d.ravel(), 0.5, -0.25
    tm = np.full((n, 1), np.inf, np.float32)
    boxes = np.array([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.0, 1.0],
                      [0.0, 0.0, 0.0, 0.0, 2.0, 2.0, 1.0, 1.0]], np.float32)
    inv = _safe_inv(rays[:, 4:7, 0].T)
    tnear, hit = _slab(*_ordered_boxes(boxes), rays[:, 0:3, 0].T, inv,
                       tm[:, 0])
    e = _entry_bits(np.where(hit, tnear, np.float32(1e30)))
    cons = tmt.tile_order_plain(torch.from_numpy(rays), torch.from_numpy(tm),
                                torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(e.T, cons[:, :2].view(np.uint32))
    assert (e == CULL_BITS).any() and (e < CULL_BITS).any()


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from([0.0, 0.0, 0.5, 1.0, 1.0, 7.25, 1e30, 1e30,
                                 3e35]), min_size=1, max_size=80))
def test_k1_rank_sort_is_stable(keys):
    """(d) on keys with many ties (0.0, repeated values, the 1e30 cull and
    bounds past it): the rank sort equals torch.sort(stable=True) and the
    -1 cut of _candidate_order."""
    key = np.array(keys, np.float32)
    order, skey = _rank_sort(key.view(np.uint32))
    ref_order, ref_skey = tmt._candidate_order(torch.from_numpy(key)[None])
    np.testing.assert_array_equal(order, ref_order[0].numpy())
    np.testing.assert_array_equal(skey.view(np.int32),
                                  ref_skey[0].numpy().view(np.int32))
