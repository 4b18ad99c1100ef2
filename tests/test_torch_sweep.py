"""The design of the Hopper sweep (fluctus_tpu_torch/csrc/sweep_hopper.cuh,
shared by K2 trace_rol, K5 trace_rol_sc and K9 trace_ros) checked on the
CPU, where no CUDA kernel runs:

  (a) its validity test dz != 0 & t > 0 & u >= 0 & v >= 0 & (1-u)-v >= 0
      equals the reference's dz != 0 & t > 0 & min(min(u, v), 1-u-v) >= 0
      (an IEEE minimum that propagates NaN, as the plain versions' and the
      CUDA build's) for every float32 input: a grid of special values
      (NaN, +-0, +-inf, +-subnormal, 1 +- ulp) and hypothesis floats; and
      the JAX package's jnp.minimum form wherever no input is subnormal
      (XLA's CPU backend flushes subnormals);
  (b) its walk — up to 32 candidates decided per vote, and after a sweep
      only the candidates the last vote left live tested again — gives
      the plain versions' t, columns and visit counts bit for bit. A
      Python model of the kernels' walk, step for step, runs on the 2x2
      luxball grid's tables against trace_ros_plain (K9's layouts) and
      trace_rol_plain (K2's) for the flat walk, and trace_rol_sc_plain,
      on tiles that include tmax = +inf lanes, direction components of 0,
      rays parallel to the floor, a tile whose list ends at once, and
      superclusters of 1 and 64 members;
  (c) its staging index map turns t12 [12, Mpad] into 48-byte triangle
      records.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.renderer import Renderer

ROOT = os.path.join(os.path.dirname(__file__), "..")
GRID = os.path.join(ROOT, "fluctus_tpu_torch", "scenes",
                    "luxball_grid_2x2.sc.json")
WINDOW = 32          # hs::WINDOW
RT = 128             # a ray tile of whole warps at 4 rays per thread
TC = 256             # hs::TC, every table's cluster size

_TINY = np.float32(np.finfo(np.float32).tiny)
_SUB = np.float32(np.finfo(np.float32).smallest_subnormal)
SPECIAL = np.array(
    [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, _SUB, -_SUB, _TINY, -_TINY,
     1.0, -1.0, np.nextafter(np.float32(1), np.float32(2)),
     np.nextafter(np.float32(1), np.float32(0)), 0.5,
     np.nextafter(np.float32(0.5), np.float32(1)), 3.4028235e38, -3.4028235e38,
     2.0, 1e-30], np.float32)


def _valid_sweep(dz, t, u, v):
    """The sweep's form (torch, float32)."""
    dz, t, u, v = (torch.from_numpy(np.ascontiguousarray(a))
                   for a in (dz, t, u, v))
    return ((dz != 0) & (t > 0) & (u >= 0) & (v >= 0)
            & ((1.0 - u) - v >= 0)).numpy()


def _valid_reference(dz, t, u, v, xp=np):
    """The reference's form, min(min(u, v), 1-u-v) >= 0 with a
    NaN-propagating minimum: numpy's (IEEE, as the plain versions'
    torch.minimum and the CUDA build), or ``xp=jnp`` for the JAX
    package's own arithmetic."""
    dz, t, u, v = (xp.asarray(a) for a in (dz, t, u, v))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.asarray((dz != 0) & (t > 0) & (
            xp.minimum(xp.minimum(u, v), 1.0 - u - v) >= 0))


def test_validity_on_special_floats():
    g = np.meshgrid(SPECIAL, SPECIAL, SPECIAL, SPECIAL, indexing="ij")
    dz, t, u, v = (a.ravel() for a in g)
    got, ref = _valid_sweep(dz, t, u, v), _valid_reference(dz, t, u, v)
    assert got.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size
    # XLA's CPU backend flushes subnormal inputs to zero, so the JAX
    # package's own arithmetic agrees wherever no input is subnormal
    normal = ~np.any([(a != 0) & (np.abs(a) < _TINY) for a in (dz, t, u, v)],
                     axis=0)
    jref = _valid_reference(dz, t, u, v, xp=jnp)
    np.testing.assert_array_equal(got[normal], jref[normal])
    assert not np.array_equal(got, jref)


_F32 = st.floats(width=32, allow_nan=True, allow_infinity=True,
                 allow_subnormal=True)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_F32, _F32, _F32, _F32), min_size=1, max_size=64))
def test_validity_on_hypothesis_floats(rows):
    dz, t, u, v = (np.array(c, np.float32) for c in zip(*rows))
    np.testing.assert_array_equal(_valid_sweep(dz, t, u, v),
                                  _valid_reference(dz, t, u, v))


# ---------------------------------------------------------------------------
# (b) the kernels' walk, modelled step for step
# ---------------------------------------------------------------------------

def _window(n):
    return (1 << min(n, WINDOW)) - 1


def _bits_above(mask, j):
    return mask & ~((2 << j) - 1) & 0xFFFFFFFF


def _stop(ord_, cn, g, t_worst):
    return ord_[g] < 0 or cn[g] > t_worst or t_worst <= 0.0


class _Model:
    """One tile's state as the kernel holds it, advanced through the plain
    versions' slab test and sweep (tmt._TraceState on a one-tile batch)."""

    def __init__(self, rays, tm, t12c, any_hit):
        self.st = tmt._TraceState(rays, tm, TC)
        self.t12c = t12c
        self.any_hit = any_hit
        self.votes = 0

    def vote(self, bits, box_of):
        self.votes += 1
        mask = 0
        for j in range(WINDOW):
            if bits >> j & 1:
                box = box_of(j)[None]
                if bool(self.st.box_hit(box, self.any_hit).any()):
                    mask |= 1 << j
        return mask, float(self.st.t_best.amax())

    def sweep(self, c):
        self.st.sweep(torch.ones(1, dtype=torch.bool),
                      torch.tensor([c], dtype=torch.int64), self.t12c,
                      self.any_hit)


def _walk_flat(m, ord_, cn, boxes, n):
    """sweep_hopper.cuh's walk_flat (K2's and K9's walk)."""
    base = 0

    def box_of(j):
        return boxes[max(ord_[base + j], 0)]
    live, t_worst = m.vote(_window(n), box_of)
    stop = _stop(ord_, cn, 0, t_worst)
    slot = 0
    while slot < n and not stop:
        if slot - base >= WINDOW:
            base = slot
            live, _ = m.vote(_window(n - base), box_of)
        j = slot - base
        c = ord_[slot]
        if live >> j & 1 and c >= 0:
            rest = _bits_above(live, j)
            m.sweep(c)
            live, t_worst = m.vote(rest, box_of)
        stop = _stop(ord_, cn, min(slot + 1, n - 1), t_worst)
        slot += 1


def _walk_sc(m, ord_, cn, boxes, sc_box):
    """trace_rol_sc.cu's walk."""
    n = len(ord_)
    base, c0, kb = 0, 0, 0

    def sc_of(j):
        return sc_box[max(ord_[base + j], 0)]

    def member_of(j):
        return boxes[c0 + kb + j]
    live, t_worst = m.vote(_window(n), sc_of)
    stop = _stop(ord_, cn, 0, t_worst)
    slot = 0
    while slot < n and not stop:
        if slot - base >= WINDOW:
            base = slot
            live, _ = m.vote(_window(n - base), sc_of)
        j = slot - base
        s = ord_[slot]
        swept = False
        if live >> j & 1 and s >= 0:
            c0, cnt = int(sc_box[s, 6]), int(sc_box[s, 7])
            k, kb, mlive = 0, 0, 0
            while k < cnt and t_worst > 0.0:
                if k == 0 or k - kb >= WINDOW:
                    kb = k
                    mlive, _ = m.vote(_window(cnt - kb), member_of)
                ahead = mlive >> (k - kb)
                if not ahead:
                    k = kb + WINDOW
                    continue
                k += (ahead & -ahead).bit_length() - 1
                rest = _bits_above(mlive, k - kb)
                m.sweep(c0 + k)
                swept = True
                mlive, t_worst = m.vote(rest, member_of)
                k += 1
        stop = _stop(ord_, cn, min(slot + 1, n - 1), t_worst)
        if swept and not stop:
            live, _ = m.vote(_bits_above(live, j), sc_of)
        slot += 1


@pytest.fixture(scope="module")
def grid_tables(tmp_path_factory):
    r = Renderer(16, 16, device="cpu",
                 data_dir=str(tmp_path_factory.mktemp("data")))
    r.load_scene(GRID)
    sc = r.device_scene.mxu
    assert sc.n_clusters > 65 and sc.cluster_size == TC
    return sc


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _edge_rays(sc, seed):
    """[nt, 8, RT] tiles of rays from a numpy seed, toward the scene from
    above and around it; with direction components of exactly 0, rays
    parallel to the floor (dy = 0, so dz = 0 for its axis-aligned
    triangles), origins inside the boxes, and tmax = +inf lanes."""
    rng = np.random.default_rng(seed)
    nt = 6
    n = nt * RT
    lo = sc.lo.numpy().astype(np.float64)
    hi = sc.hi.numpy().astype(np.float64)
    span = hi - lo
    target = lo + rng.random((n, 3)) * span
    orig = lo + (rng.random((n, 3)) * 1.6 - 0.3) * span
    orig[:, 1] = hi[1] + rng.random(n) * span[1] * 2.0
    d = _unit(target - orig)
    d[rng.random(n) < 0.1, 0] = 0.0
    d[rng.random(n) < 0.1, 2] = 0.0
    flat = rng.random(n) < 0.1             # parallel to the floor
    d[flat, 1] = 0.0
    orig[flat] = target[flat]
    d = _unit(np.where(np.abs(d).sum(1, keepdims=True) > 0, d, 1.0))
    inside = rng.random(n) < 0.1           # start inside the boxes
    orig[inside] = target[inside]
    o4 = np.concatenate([orig, np.ones((n, 1))], 1).astype(np.float32)
    d4 = np.concatenate([d, np.zeros((n, 1))], 1).astype(np.float32)
    tm = np.where(rng.random(n) < 0.5, np.inf,
                  rng.random(n) * span.max() * 3.0).astype(np.float32)
    o4[-RT:, 1] = hi[1] + 10.0             # the last tile looks up: its
    d4[-RT:, :3] = [0.0, 1.0, 0.0]         # candidate list ends at once
    return torch.from_numpy(o4), torch.from_numpy(d4), torch.from_numpy(tm)


def _sc_box(sc):
    """Superclusters of 1, 64 and the remaining member clusters, boxes
    the union of their members'."""
    ncl = sc.n_clusters
    cuts = [(0, 1), (1, 65), (65, ncl)]
    boxes = sc.cluster_box
    out = torch.zeros((len(cuts), 8))
    for s, (a, b) in enumerate(cuts):
        out[s, 0:3] = boxes[a:b, 0:3].amin(0)
        out[s, 3:6] = boxes[a:b, 3:6].amax(0)
        out[s, 6], out[s, 7] = a, b - a
    return out


def _check(got, ref):
    for a, b, what in zip(got, ref, ("t", "columns", "visits")):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), what


@pytest.mark.parametrize("level", ["flat", "rol", "supercluster"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_windowed_walk_matches_plain(grid_tables, level, any_hit):
    sc = grid_tables
    tc = sc.cluster_size
    o4, d4, tmax = _edge_rays(sc, seed=5 + any_hit)
    rays = tmt._pack_rays(o4, d4, RT)
    nt = rays.shape[0]
    tm = tmax.view(nt, RT)
    t12c = sc.t12.view(12, sc.n_clusters, tc)
    if level == "supercluster":
        boxes = _sc_box(sc)
    else:
        boxes = sc.cluster_box
    order, cons = tmt._candidate_order(tmt.tile_order_plain(rays, tm, boxes))
    assert int(order[-1, 0]) == -1                  # ends at once
    if level == "flat":
        t, i, visits = tmt.trace_ros_plain(
            o4, d4, tmax[:, None], order, cons, sc.tx, sc.ty, sc.tz,
            sc.cluster_box, sc.n_clusters, tc, any_hit)
        ref = (t.view(nt, RT), i.view(nt, RT), visits)
    elif level == "rol":
        ref = tmt.trace_rol_plain(rays, tm, order, cons, sc.t12,
                                  sc.cluster_box, sc.n_clusters, tc, any_hit)
    else:
        # tiles 0 and 1 walk the 1-member and the 64-member supercluster
        # first
        order[0, :3] = torch.tensor([0, 1, 2], dtype=torch.int32)
        order[1, :3] = torch.tensor([1, 0, 2], dtype=torch.int32)
        cons[0:2, :3] = 0.0
        ref = tmt.trace_rol_sc_plain(rays, tm, order, cons, sc.t12,
                                     sc.cluster_box, boxes, tc, any_hit)
    t = torch.empty_like(tm)
    i = torch.empty(tm.shape, dtype=torch.int32)
    visits = torch.empty(nt, dtype=torch.int32)
    for k in range(nt):
        m = _Model(rays[k:k + 1], tm[k:k + 1], t12c, any_hit)
        ord_, cn = order[k].tolist(), cons[k].tolist()
        if level != "supercluster":
            _walk_flat(m, ord_, cn, boxes, sc.n_clusters)
        else:
            _walk_sc(m, ord_, cn, sc.cluster_box, boxes)
        t[k], i[k], visits[k] = m.st.t_best[0], m.st.i_best[0], \
            m.st.visits[0]
    _check((t, i, visits), ref)
    assert int(ref[2].sum()) > nt                   # clusters were swept
    assert bool((ref[1] >= 0).any())


def test_staging_index_map(grid_tables):
    """Element e of a cluster's 12 x tc block: coefficient k = e / tc of
    triangle j = e % tc, read at t12[k, c*tc + j] and written to float
    j*12 + k of the records (stage_t12); the same from tx/ty/tz rows
    k & 3 of block k / 4 (stage_xyz)."""
    sc = grid_tables
    tc = sc.cluster_size
    t12 = sc.t12
    m_pad = t12.shape[1]
    flat12 = t12.reshape(-1)
    xyz = [t12[0:4].reshape(-1), t12[4:8].reshape(-1), t12[8:12].reshape(-1)]
    e = torch.arange(12 * tc)
    k, j = e // tc, e % tc
    for c in (0, sc.n_clusters // 2, sc.n_clusters - 1):
        rec = torch.empty(tc * 12)
        rec[j * 12 + k] = flat12[k * m_pad + c * tc + j]
        want = t12[:, c * tc:(c + 1) * tc].T.reshape(-1)
        assert torch.equal(rec, want)
        rec2 = torch.empty(tc * 12)
        src = torch.stack([xyz[b][(k & 3) * m_pad + c * tc + j]
                           for b in range(3)])
        rec2[j * 12 + k] = src[k // 4, torch.arange(12 * tc)]
        assert torch.equal(rec2, want)
