"""The port's bitstack BVH traversal (fluctus_tpu_torch/accel/traverse.py)
and its BVH builder's split modes against the JAX package, on the CPU.

Inputs are made with numpy from a seed: a soup of 500 triangles, rays from
a sphere around it toward random points inside, and edge-case rays
(axis-parallel directions with +-0 components, origins on node boxes'
planes, origins inside boxes, t_max of 0 and +inf). The JAX package runs
its ``lax.while_loop`` traversal under ``jax.jit``. Its XLA contracts
``a * b + c`` into FMA on the CPU, the port does not (torch's elementwise
ops, and the kernel built with -fmad=false): the triangle and the
occlusion must be equal, t agrees within rtol 1e-5 (atol 1e-6). u and v
are dot products over det, which cancel on grazing rays: they agree
within 16 float32 ulps of 1 times the condition number of the ray's
barycentric (|tvec| |pvec| / |det| for u, |d| |qvec| / |det| for v, in
float64 from the hit triangle), plus 1e-6; on the seeded rays both
packages lie that close to the float64 value too. The port's traversal
against its own brute-force search (the same arithmetic): bit-equal."""

import ctypes
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import vec as jvec
from fluctus_tpu.accel import SplitMode as JSplitMode
from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel import traverse as jt

from fluctus_tpu_torch import kernel_build as kb
from fluctus_tpu_torch.accel import SplitMode, build_bvh
from fluctus_tpu_torch.accel import traverse as tt
from fluctus_tpu_torch.core import trace as ttrace
from fluctus_tpu_torch.vec import Vec3

MODES = (SplitMode.SPATIAL_MEDIAN, SplitMode.OBJECT_MEDIAN, SplitMode.SAH)
N_TRIS = 500
RTOL, ATOL = 1e-5, 1e-6
_jclosest = jax.jit(jt.closest_hit)
_jany = jax.jit(jt.any_hit)
_jbrute = jax.jit(jt.brute_force_closest)


def _soup(seed=3, m=N_TRIS):
    """m triangles of random size and orientation in a 10^3 box."""
    rng = np.random.default_rng(seed)
    c = rng.random((m, 1, 3)) * 10.0
    p = (c + rng.normal(size=(m, 3, 3)) * 0.6).astype(np.float32)
    n = rng.normal(size=(m, 3, 3)).astype(np.float32)
    uv = rng.random((m, 3, 2)).astype(np.float32)
    return p, n, uv, (np.arange(m) % 3).astype(np.int32)


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rays(bvh, seed=11, n=1024):
    """Rays from a sphere around the soup toward random points inside it,
    then the edge cases: axis-parallel directions (the other components
    +0 or -0) from random origins and from origins on a plane of a node's
    box (the slab's 0 * inf = NaN), and random directions from origins
    inside node boxes. Returns (origins, directions) [k, 3] float32."""
    rng = np.random.default_rng(seed)
    lo, hi = bvh.box_min[0], bvh.box_max[0]
    centre, radius = (lo + hi) / 2, np.linalg.norm(hi - lo) * 0.7
    o = centre + radius * _unit(rng.normal(size=(n, 3)))
    d = _unit(lo + rng.random((n, 3)) * (hi - lo) - o)
    axes = []                # +-e_a, the other components +0, then -0
    for a in range(3):
        for sign, zero in ((1.0, 0.0), (-1.0, 0.0), (1.0, -0.0),
                           (-1.0, -0.0)):
            v = [zero] * 3
            v[a] = sign
            axes.append(v)
    axes = np.array(axes)
    pick = rng.integers(0, bvh.num_nodes, 96)
    inside = bvh.box_min[pick] + rng.random((96, 3)) * (
        bvh.box_max[pick] - bvh.box_min[pick])
    plane = inside.copy()
    ax = rng.integers(0, 3, 96)
    side = rng.integers(0, 2, 96)
    plane[np.arange(96), ax] = np.where(side, bvh.box_max[pick, ax],
                                        bvh.box_min[pick, ax])
    # along another axis than the plane's: its slab is 0 * inf
    pd = axes[(4 * ((ax + 1 + side) % 3) + rng.integers(0, 4, 96))]
    rand_o = lo + rng.random((48, 3)) * (hi - lo)
    o = np.concatenate([o, np.repeat(rand_o[:4], 12, axis=0), plane, inside,
                        rand_o])
    d = np.concatenate([d, np.tile(axes, (4, 1)), pd,
                        _unit(rng.normal(size=(96, 3))),
                        axes[rng.integers(0, 12, 48)]])
    return o.astype(np.float32), d.astype(np.float32)


def _vec_t(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _vec_j(a):
    return jvec.Vec3(*(jnp.asarray(np.ascontiguousarray(a[:, k]))
                       for k in range(3)))


def _scenes(mode):
    p, n, uv, mid = _soup()
    host = build_bvh(p, mode)
    jbvh = jt.BVHDevice.from_host(jbuild_bvh(p, mode))
    jtris = jt.TrianglesDevice.from_arrays(p, n, uv, mid)
    tbvh = tt.BVHDevice.from_host(host, device="cpu")
    ttris = ttrace.TrianglesDevice.from_arrays(p, n, uv, mid, device="cpu")
    return host, (jtris, jbvh), (ttris, tbvh)


@pytest.mark.parametrize("max_leaf", [8, 3])
@pytest.mark.parametrize("mode", MODES)
def test_build_bvh_matches_reference(mode, max_leaf):
    """build_bvh in every split mode, node for node the reference's
    (boxes, right_or_start, parent, n_prims, indices), and its
    scene_bounds / max_leaf_size; SplitMode's values are the reference's."""
    assert (SplitMode.SPATIAL_MEDIAN, SplitMode.OBJECT_MEDIAN,
            SplitMode.SAH) == (JSplitMode.SPATIAL_MEDIAN,
                               JSplitMode.OBJECT_MEDIAN, JSplitMode.SAH)
    p = _soup()[0]
    ours, ref = build_bvh(p, mode, max_leaf), jbuild_bvh(p, mode, max_leaf)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.max_leaf_size() == ref.max_leaf_size() <= max_leaf
    for a, b in zip(ours.scene_bounds(), ref.scene_bounds()):
        np.testing.assert_array_equal(a, b)
    assert sorted(ours.indices.tolist()) == list(range(len(p)))


@pytest.mark.parametrize("mode", MODES)
def test_bvh_device_from_host(mode):
    """BVHDevice.from_host holds the reference's device arrays (int32
    indices, parents, right_or_start, n_prims; float32 boxes) and its
    max_leaf."""
    _, (_, jb), (_, tb) = _scenes(mode)
    for f in ("bmin", "bmax"):
        for c in range(3):
            a, b = getattr(tb, f)[c], getattr(jb, f)[c]
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("right_or_start", "parent", "n_prims", "indices"):
        a, b = getattr(tb, f), np.asarray(getattr(jb, f))
        assert a.dtype == torch.int32 and b.dtype == np.int32
        np.testing.assert_array_equal(a.numpy(), b)
    assert tb.max_leaf == jb.max_leaf


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_hits_close(got, want, o, d):
    """(t, tri, u, v) of two traces: the same triangles, t within rtol
    1e-5, u and v within their conditioned bound (module docstring)."""
    np.testing.assert_array_equal(got[1], want[1])
    _assert_close(got[0], want[0])
    p = _soup()[0].astype(np.float64)
    k = np.maximum(got[1], 0)
    v0, e1, e2 = p[k, 0], p[k, 1] - p[k, 0], p[k, 2] - p[k, 0]
    d64 = d.astype(np.float64)
    tvec = o.astype(np.float64) - v0
    pvec, qvec = np.cross(d64, e2), np.cross(tvec, e1)
    det = np.abs((e1 * pvec).sum(1))
    norm = lambda a: np.linalg.norm(a, axis=1)
    for g, w, kappa in ((got[2], want[2], norm(tvec) * norm(pvec) / det),
                        (got[3], want[3], norm(d64) * norm(qvec) / det)):
        tol = np.where(got[1] >= 0, 16 * 2.0 ** -24 * kappa, 0.0) + ATOL
        assert (np.abs(g.astype(np.float64) - w) <= tol).all(), \
            np.max(np.abs(g.astype(np.float64) - w) - tol)


@pytest.mark.parametrize("mode", MODES)
def test_closest_hit_matches_reference(mode):
    """closest_hit on the seeded rays: the same triangle on every ray
    (-1 on the same misses), t, u and v within the stated tolerances."""
    host, (jtris, jb), (ttris, tb) = _scenes(mode)
    o, d = _rays(host)
    want = [np.asarray(x) for x in _jclosest(_vec_j(o), _vec_j(d), jtris, jb)]
    got = [x.numpy() for x in tt.closest_hit(_vec_t(o), _vec_t(d), ttris,
                                             tb)]
    _assert_hits_close(got, want, o, d)
    assert 0.2 < (got[1] >= 0).mean() < 0.95


@pytest.mark.parametrize("mode", MODES)
def test_any_hit_matches_reference(mode):
    """any_hit with per-ray t_max drawn from the closest hits (half or 1.5
    times each: the two packages' t differ in the last bits, so a t_max
    of the hit itself would tie), 0 and +inf: the same occlusion on every
    ray."""
    host, (jtris, jb), (ttris, tb) = _scenes(mode)
    o, d = _rays(host)
    t_hit = tt.closest_hit(_vec_t(o), _vec_t(d), ttris, tb)[0].numpy()
    rng = np.random.default_rng(5)
    scale = rng.choice([0.5, 1.5], size=t_hit.shape)
    finite = np.where(t_hit < 1e30, t_hit * scale,
                      rng.random(t_hit.shape) * 20).astype(np.float32)
    hits = []
    for t_max in (finite, np.zeros_like(finite),
                  np.full_like(finite, np.inf)):
        want = np.asarray(_jany(_vec_j(o), _vec_j(d), jnp.asarray(t_max),
                                jtris, jb))
        got = tt.any_hit(_vec_t(o), _vec_t(d), torch.from_numpy(t_max),
                         ttris, tb).numpy()
        np.testing.assert_array_equal(got, want)
        hits.append(got.mean())
    assert 0.0 < hits[0] < hits[2] and hits[1] == 0.0


def test_brute_force_matches_reference():
    """brute_force_closest against the reference's: the same triangle on
    every ray, t, u and v within the stated tolerances."""
    host, (jtris, _), (ttris, _) = _scenes(SplitMode.SAH)
    o, d = _rays(host, n=256)
    want = [np.asarray(x) for x in _jbrute(_vec_j(o), _vec_j(d), jtris)]
    got = [x.numpy() for x in tt.brute_force_closest(_vec_t(o), _vec_t(d),
                                                     ttris)]
    _assert_hits_close(got, want, o, d)


@pytest.mark.parametrize("mode", MODES)
def test_traversal_matches_brute_force(mode):
    """The port's traversal against its own brute force (tests/test_bvh.py:
    49-95): bit-equal t, u, v and triangle, and any-hit to the closest
    hit's t_max equal to the hits."""
    host, _, (ttris, tb) = _scenes(mode)
    o, d = _rays(host)
    got = tt.closest_hit(_vec_t(o), _vec_t(d), ttris, tb)
    want = tt.brute_force_closest(_vec_t(o), _vec_t(d), ttris)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    occ = tt.any_hit(_vec_t(o), _vec_t(d), tt.F32_MAX, ttris, tb)
    assert torch.equal(occ, want[1] >= 0)
    half = torch.where(want[1] >= 0, want[0] * 0.5, tt.F32_MAX)
    kept = half.clone()
    near = tt.any_hit(_vec_t(o), _vec_t(d), half, ttris, tb)
    assert not near[want[1] >= 0].any()
    tt.closest_hit(_vec_t(o), _vec_t(d), ttris, tb, half)
    assert torch.equal(half, kept)       # the caller's t_max is not written


@pytest.mark.parametrize("depth", [31, 32, 33, 63])
def test_bitstack_shifts(depth):
    """The plain version's bitstack (32-bit words in int64) against the
    reference's uint32 pairs: push a bit at ``depth`` levels (shl with the
    low bit set, then depth - 1 plain shl), pop every level back (shr),
    with the low bits read at each step; the words equal throughout."""
    lo_t = torch.tensor([1, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    hi_t = torch.tensor([0, 0x7FFFFFFF, 0x80000000], dtype=torch.int64)
    lo_j = jnp.asarray(lo_t.numpy().astype(np.uint32))
    hi_j = jnp.asarray(hi_t.numpy().astype(np.uint32))

    def same():
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
        assert (lo_t.numpy() & 1 == np.asarray(lo_j) & 1).all()
        np.testing.assert_array_equal(tt._empty(lo_t, hi_t).numpy(),
                                      np.asarray(jt._empty(lo_j, hi_j)))
    for _ in range(depth):
        lo_t, hi_t = tt._shl(lo_t, hi_t)
        lo_j, hi_j = jt._shl(lo_j, hi_j)
        same()
    word, bit = (hi_t, depth - 32) if depth >= 32 else (lo_t, depth)
    assert int(word[0]) == 1 << bit      # lane 0 pushed its 1 to depth
    for _ in range(depth + 1):
        lo_t, hi_t = tt._shr(lo_t, hi_t)
        lo_j, hi_j = jt._shr(lo_j, hi_j)
        same()


def test_slab_and_triangle_edge_cases():
    """intersect_aabb and intersect_triangle on special inputs against the
    reference's: axis-parallel rays with +-0 components (1/d = +-inf),
    origins on the box's planes (0 * inf = NaN: no hit), t_prev 0, a
    degenerate triangle, a ray in the triangle's plane."""
    z, nz = 0.0, -0.0
    o = np.array([[0, .5, .5], [0, .5, .5], [1, .5, .5], [.5, 0, .5],
                  [.5, .5, .5], [-1, .5, .5], [-1, .5, .5], [2, 2, 2]],
                 np.float32)
    d = np.array([[z, 1, z], [nz, 1, nz], [nz, -1, z], [1, nz, z],
                  [z, nz, -1], [1, z, z], [nz, 1, z], [-1, -1, -1]],
                 np.float32)
    t_prev = np.array([1e30, 1e30, 1e30, 1e30, 1e30, 0.0, 1e30, 1e30],
                      np.float32)
    box = (np.zeros((8, 3), np.float32), np.ones((8, 3), np.float32))
    ji = jvec.Vec3(*(1.0 / jnp.asarray(d[:, k]) for k in range(3)))
    ti = Vec3(*(1.0 / torch.from_numpy(d[:, k].copy()) for k in range(3)))
    jh, jtm = jt.intersect_aabb(_vec_j(o), ji, _vec_j(box[0]),
                                _vec_j(box[1]), jnp.asarray(t_prev))
    th, ttm = tt.intersect_aabb(_vec_t(o), ti, _vec_t(box[0]),
                                _vec_t(box[1]), torch.from_numpy(t_prev))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(np.isnan(ttm.numpy()),
                                  np.isnan(np.asarray(jtm)))
    assert np.isnan(ttm.numpy()).any() and th.any() and not th.all()
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    flat = np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2]], np.float32)
    below = o - np.float32([0, 0, 1])
    for p in (tri, flat):
        v0 = np.repeat(p[:1], 8, 0)
        e1 = np.repeat(p[1:2] - p[:1], 8, 0)
        e2 = np.repeat(p[2:3] - p[:1], 8, 0)
        jr = jt.intersect_triangle(_vec_j(below), _vec_j(d),
                                   _vec_j(v0), _vec_j(e1), _vec_j(e2))
        tr = tt.intersect_triangle(_vec_t(below), _vec_t(d),
                                   _vec_t(v0), _vec_t(e1), _vec_t(e2))
        np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
        for a, b in zip(tr[1:], jr[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


def test_import_paths_and_routing():
    """TrianglesDevice imports from accel.traverse as from core.trace (the
    reference's two paths); the wrapper takes the plain version on CPU
    tensors (counted, no launch) and refuses other non-CUDA tensors."""
    from fluctus_tpu_torch.accel.traverse import TrianglesDevice
    assert TrianglesDevice is ttrace.TrianglesDevice
    with pytest.raises(AttributeError):
        tt.NoSuchName
    host, _, (ttris, tb) = _scenes(SplitMode.SAH)
    o, d = _rays(host, n=32)
    kb.reset_counts()
    tt.closest_hit(_vec_t(o), _vec_t(d), ttris, tb)
    tt.any_hit(_vec_t(o), _vec_t(d), 1.0, ttris, tb)
    assert (tt.K11.plain_runs, tt.K11.launches) == (2, 0)
    meta = lambda v: Vec3(*(c.to("meta") for c in v))
    tmeta = type(ttris)(*(meta(f) if isinstance(f, Vec3) else f.to("meta")
                          for f in ttris))
    bmeta = type(tb)(*(meta(f) if isinstance(f, Vec3) else
                       f.to("meta") if isinstance(f, torch.Tensor) else f
                       for f in tb))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tt.closest_hit(meta(_vec_t(o)), meta(_vec_t(d)), tmeta, bmeta)


def test_counts_of_the_plain_version():
    """traverse_plain(counts=True): the same hits, two box tests per inner
    node entered and a leaf's triangles per leaf; a ray whose root box is
    missed by both children tests 2 boxes and no triangle."""
    host, _, (ttris, tb) = _scenes(SplitMode.SAH)
    o, d = _rays(host, n=64)
    plain = tt.traverse_plain(_vec_t(o), _vec_t(d), ttris, tb, tt.F32_MAX,
                              False, counts=True)
    for a, b in zip(plain[:4], tt.closest_hit(_vec_t(o), _vec_t(d), ttris,
                                              tb)):
        assert torch.equal(a, b)
    boxes, tests = plain[4], plain[5]
    assert (boxes >= 2).all() and (boxes % 2 == 0).all()
    assert (tests[plain[1] >= 0] > 0).all()
    assert int(tests.sum()) <= int(boxes.sum()) * tb.max_leaf


# The kernel's source compiled for the CPU: the CUDA keywords, __ldg and the
# launch syntax stubbed out, one call of the kernel body per ray.
_CUDA_STUB = """
#pragma once
#include <math.h>
#include <stdint.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
struct Dim3 { int x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <class T> T __ldg(const T* p) { return *p; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/bvh_bitstack.cu built by g++ (-ffp-contract=off, as nvcc's
    -fmad=false) with the launch rewritten as a loop over the rays."""
    import re
    d = tmp_path_factory.mktemp("bitstack_cpu")
    csrc = os.path.join(os.path.dirname(tt.__file__), "..", "csrc")
    (d / "cuda_runtime.h").write_text(_CUDA_STUB)
    with open(os.path.join(csrc, "common.cuh")) as f:
        (d / "common.cuh").write_text(f.read())
    with open(os.path.join(csrc, "bvh_bitstack.cu")) as f:
        src = f.read()
    src, k = re.subn(
        r"(bvh_bitstack_kernel<\w+>)<<<[^>]*>>>\(([^;]*)\);",
        r"for (int r = 0; r < n; ++r) { threadIdx.x = r; blockDim.x = 1; "
        r"\1(\2); }", src)
    assert k == 2
    (d / "k.cpp").write_text(src)
    out = str(d / "libk.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(d), "-o", out,
                    str(d / "k.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(out).bvh_bitstack_launch
    fn.argtypes = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]

    def run(o, d, tris, bvh, t_max, any_hit):
        o, d, tm = tt._rays(o, d, t_max)
        n = tm.shape[0]
        t, u, v = (torch.empty(n) for _ in range(3))
        tri = torch.empty(n, dtype=torch.int32)
        ptrs = [a.data_ptr() for a in (
            *o, *d, tm, *bvh.bmin, *bvh.bmax, *tris.v0, *tris.e1, *tris.e2,
            bvh.right_or_start, bvh.parent, bvh.n_prims, bvh.indices, t, tri,
            u, v)]
        assert fn(*ptrs, n, bvh.parent.shape[0], bvh.indices.shape[0],
                  bvh.max_leaf, int(any_hit), None) == 0
        return t, tri, u, v
    return run


@pytest.mark.parametrize("mode", MODES)
def test_kernel_source_matches_plain(kernel_on_cpu, mode):
    """The CUDA source's arithmetic and control flow, run on the CPU,
    bit-equal to the plain version (t, tri, u, v) on the seeded and
    edge-case rays, closest-hit with t_max F32_MAX and mixed, any-hit with
    mixed t_max (+inf, 0, random) and +inf. The card's check of the
    compiled kernel is chip_smoke.py's phase 17."""
    host, _, (ttris, tb) = _scenes(mode)
    o, d = _rays(host)
    o, d = _vec_t(o), _vec_t(d)
    rng = np.random.default_rng(8)
    pick = rng.random(o.x.shape[0])
    mixed = torch.from_numpy(np.select(
        [pick < 0.25, pick < 0.5], [np.inf, 0.0],
        rng.random(pick.shape) * 15).astype(np.float32))
    for t_max, any_hit in ((tt.F32_MAX, False), (mixed, False),
                           (mixed, True), (np.inf, True)):
        got = kernel_on_cpu(o, d, ttris, tb, t_max, any_hit)
        want = tt.traverse_plain(o, d, ttris, tb, t_max, any_hit)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert (got[1] >= 0).any()
