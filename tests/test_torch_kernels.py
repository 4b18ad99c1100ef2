"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels run in interpret mode on the CPU, on the luxball
cluster tables (built once by the JAX package and carried across with
``tables_from_numpy``) and on rays made from a seed:

  K1 tile order    cons bit-equal, candidate order equal
  K2 trace         winner column (closest) or verdict (any-hit) equal on
                   >= 99.9% of rays, |dt| <= 2^-12 t (camera and bounce
                   rays); the same for the pair trace's (t, col, occ)
  K3 resolve       integer and material rows exact; the rows derived from
                   the recomputed t/u/v within 2^-12 (t: relative)
  K4 splat         weight exact; rgb rtol 1e-6 against the segment-sum
                   reference, 2^-16 of the summed magnitudes against the
                   two-pass bf16 kernel body

Why K2 and K3 are not held bit for bit: XLA's CPU backend contracts
``a*b + c`` into a fused multiply-add inside the jitted interpret-mode
kernel bodies (``test_xla_cpu_contracts_fma`` shows it), while the port
rounds the product and the sum separately, as its CUDA kernels do
(compiled with -fmad=false). Where the affine ``oz`` or ``u`` cancels (a
ray leaving a surface, a hit near an edge) the last bits differ.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import block_splat as tbs
from fluctus_tpu_torch.vec import Vec3 as TVec3

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
RT = 512
F32_MAX = np.float32(3.4028235e38)


@pytest.fixture(scope="module")
def lux():
    s = JScene()
    s.load_model(LUXBALL)
    p, n, uv, mid = s.triangle_arrays()
    host, st = jmt.MXUScene.build(p, jbuild_bvh(p), normals=n, uvs=uv,
                                  mat_ids=mid, materials=s.materials,
                                  return_host=True)
    return jmt.MXUScene._from_host(host, st), tmt.tables_from_numpy(
        host, st, "cpu")


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays(lux, kind, n=2048, seed=0):
    """(o4, d4, exit-clamped tmax) as numpy: camera rays through a
    jittered 64x32 film, or bounce rays leaving the camera rays' hits in
    random directions (misses restart inside the scene bounds)."""
    jsc, tsc = lux
    rng = np.random.default_rng(seed)
    center = tsc.center.numpy()
    px = rng.random(n).astype(np.float32)
    py = rng.random(n).astype(np.float32)
    o = np.tile(np.array([0.0, 1.6, 4.5], np.float32), (n, 1))
    d = _unit(np.stack([px * 2 - 1, (py * 2 - 1) * 0.6 - 0.12,
                        -np.ones(n, np.float32)], 1))
    o4 = np.concatenate([o - center, np.ones((n, 1), np.float32)], 1)
    d4 = np.concatenate([d, np.zeros((n, 1), np.float32)], 1)
    if kind == "bounce":
        tm = tmt._exit_clamp(torch.from_numpy(o4), torch.from_numpy(d4),
                             torch.full((n, 1), float(F32_MAX)), tsc.lo,
                             tsc.hi)
        t, i = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4), tm,
                              tsc.t12, tsc.cluster_box,
                              (tsc.n_clusters, tsc.cluster_size), False, RT)
        t, hit = t[:, 0].numpy(), i[:, 0].numpy() >= 0
        lo, hi = tsc.lo.numpy(), tsc.hi.numpy()
        p = np.where(hit[:, None], o4[:, :3] + d * t[:, None] * 0.999,
                     lo + rng.random((n, 3)).astype(np.float32) * (hi - lo))
        o4 = np.concatenate([p, np.ones((n, 1))], 1).astype(np.float32)
        d4 = np.concatenate([_unit(rng.normal(size=(n, 3))),
                             np.zeros((n, 1))], 1).astype(np.float32)
    tm = tmt._exit_clamp(torch.from_numpy(o4), torch.from_numpy(d4),
                         torch.full((n, 1), float(F32_MAX)), tsc.lo, tsc.hi)
    return o4, d4, tm.numpy()


def _check_trace(t, i, jt, ji):
    """Winner columns / verdicts equal on >= 99.9% of rays; every t within
    2^-12 relative where they agree (see the module docstring)."""
    same = i == ji
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_less(np.abs(t - jt)[same],
                                 np.abs(jt)[same] * 2.0 ** -12 + 1e-30)


def test_xla_cpu_contracts_fma():
    """The reason for the K2/K3 tolerances: jitted a*b + c on XLA's CPU
    backend equals the fused multiply-add, not the twice-rounded result
    the port computes."""
    import jax
    rng = np.random.default_rng(8)
    a, b, c = (rng.normal(size=100000).astype(np.float32) for _ in range(3))
    r = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fma = (a.astype(np.float64) * b + c).astype(np.float32)
    port = (torch.from_numpy(a) * torch.from_numpy(b)
            + torch.from_numpy(c)).numpy()
    assert (r == fma).all()
    assert (port == a * b + c).all() and (port != r).any()


def _any_hit_tmax(tm, seed):
    """Shadow-style tmax: a third of the lanes dead (0), the rest cut to a
    random fraction of their exit distance."""
    rng = np.random.default_rng(seed)
    f = rng.random(tm.shape).astype(np.float32) * 1.2
    return np.where(rng.random(tm.shape) < 0.33, 0.0, tm * f).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_k1_tile_order(lux, kind):
    jsc, tsc = lux
    o4, d4, tm = _rays(lux, kind)
    order, cons = jmt._tile_order_v2(jnp.asarray(o4), jnp.asarray(d4),
                                     jnp.asarray(tm), jsc.cluster_box, RT,
                                     interpret=True)
    nt = o4.shape[0] // RT
    rays = tmt._pack_rays(torch.from_numpy(o4), torch.from_numpy(d4), RT)
    tcons = tmt.tile_order_plain(rays, torch.from_numpy(tm).reshape(nt, RT),
                                 tsc.cluster_box)
    tord, tkey = tmt._candidate_order(tcons)
    # the reference returns the sorted bounds beside the order
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(cons)[:, :, 0])
    np.testing.assert_array_equal(tord.numpy(), np.asarray(order)[:, :, 0])


@pytest.mark.parametrize("kind,any_hit", [("camera", False),
                                          ("camera", True),
                                          ("bounce", False),
                                          ("bounce", True)])
def test_k2_trace(lux, kind, any_hit):
    jsc, tsc = lux
    o4, d4, tm = _rays(lux, kind, seed=1)
    if any_hit:
        tm = _any_hit_tmax(tm, 2)
    static = (tsc.n_clusters, tsc.cluster_size)
    jt, ji = jmt._trace_rol(jnp.asarray(o4), jnp.asarray(d4), jnp.asarray(tm),
                            jsc.t12, jsc.cluster_box, static, any_hit, RT,
                            True)
    tt, ti = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4),
                            torch.from_numpy(tm), tsc.t12, tsc.cluster_box,
                            static, any_hit, RT)
    assert (np.asarray(ji) >= 0).mean() > 0.05      # real hits traced
    _check_trace(tt.numpy(), ti.numpy(), np.asarray(jt), np.asarray(ji))


def test_pair_trace(lux, monkeypatch):
    """trace_pair_mxu (sort, permute, trace x2, unsort) on a ray count that
    is not a tile multiple; the reference's dispatch is routed to its
    rays-on-lanes kernels in interpret mode."""
    jsc, tsc = lux
    n = 1500
    eo4, ed4, _ = _rays(lux, "bounce", seed=3)
    so4, sd4, stm = _rays(lux, "bounce", seed=4)
    stm = _any_hit_tmax(stm, 5)[:n, 0]

    def rol_dispatch(o4, d4, tmax_col, scene, any_hit, ray_tile, interpret):
        return jmt._trace_rol(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                              (scene.n_clusters, scene.cluster_size), any_hit,
                              jmt.ROL_TILE, True)
    monkeypatch.setattr(jmt, "_dispatch_trace", rol_dispatch)

    def vecs(a4, mk, conv, center):
        return mk(*(conv(np.ascontiguousarray(a4[:n, k] + center[k]))
                    for k in range(3)))
    c = tsc.center.numpy()
    z = np.zeros(3, np.float32)
    jr = jmt.trace_pair_mxu(vecs(eo4, JVec3, jnp.asarray, c),
                            vecs(ed4, JVec3, jnp.asarray, z),
                            vecs(so4, JVec3, jnp.asarray, c),
                            vecs(sd4, JVec3, jnp.asarray, z),
                            jnp.asarray(stm), jsc, ray_tile=RT,
                            interpret=True)
    tr = tmt.trace_pair_mxu(vecs(eo4, TVec3, torch.from_numpy, c),
                            vecs(ed4, TVec3, torch.from_numpy, z),
                            vecs(so4, TVec3, torch.from_numpy, c),
                            vecs(sd4, TVec3, torch.from_numpy, z),
                            torch.from_numpy(stm), tsc)
    assert np.asarray(jr[2]).any() and (np.asarray(jr[1]) >= 0).any()
    _check_trace(tr[0].numpy(), tr[1].numpy(), np.asarray(jr[0]),
                 np.asarray(jr[1]))
    assert (tr[2].numpy() == np.asarray(jr[2])).mean() >= 0.999


def test_k3_resolve(lux):
    jsc, tsc = lux
    o4, d4, tm = _rays(lux, "bounce", seed=6)
    static = (tsc.n_clusters, tsc.cluster_size)
    _, col = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4),
                            torch.from_numpy(tm), tsc.t12, tsc.cluster_box,
                            static, False, RT)
    ref = np.asarray(jmt._resolve_v5(jnp.asarray(col.numpy()),
                                     jnp.asarray(o4), jnp.asarray(d4),
                                     jsc.b16t, jsc.t12b, static, RT, True))
    got = tmt.resolve_v5_plain(col[:, 0].contiguous(), torch.from_numpy(o4),
                               torch.from_numpy(d4), tsc.b16r,
                               tsc.t16r).numpy()
    assert (col.numpy() >= 0).mean() > 0.1
    exact = [tmt.ATTR_MAT, tmt.ATTR_TYPE, tmt.ATTR_MAP_KD, tmt.ATTR_MAP_KS,
             tmt.ATTR_MAP_N, tmt.ATTR_TRI] + list(range(tmt.ATTR_KD,
                                                       tmt.ATTR_D + 1)) \
        + list(range(tmt.ATTR_TKD_WH, tmt.ATTR_COLS))
    np.testing.assert_array_equal(got[exact], ref[exact])
    # rows from the recomputed t/u/v (FMA in the reference, see above)
    bary = list(range(tmt.ATTR_N, tmt.ATTR_UV + 2)) + [tmt.ATTR_HITU,
                                                       tmt.ATTR_HITV]
    np.testing.assert_allclose(got[bary], ref[bary], rtol=0,
                               atol=2.0 ** -12)
    t, jt = got[tmt.ATTR_HITT], ref[tmt.ATTR_HITT]
    np.testing.assert_array_less(np.abs(t - jt), np.abs(jt) * 2.0 ** -12
                                 + 1e-30)


@pytest.mark.parametrize("body", ["segment_sum", "pallas"])
def test_k4_splat(body):
    rng = np.random.default_rng(7)
    g, s, pk, c = 16, 128, 128, 4
    local = rng.integers(0, 20, g * s).astype(np.int32)   # collisions
    local[rng.random(g * s) < 0.3] = -1
    data = rng.normal(size=(c, g * s)).astype(np.float32)
    data[3] = 1.0
    data[:, local < 0] = 0.0
    film = rng.normal(size=(c, g * pk)).astype(np.float32)
    kw = (dict(interpret=True) if body == "segment_sum"
          else dict(pallas_interpret=True))
    ref = np.asarray(jbs.splat(jnp.asarray(local), jnp.asarray(data),
                               jnp.asarray(film), groups=g, **kw))
    got = tbs.splat(torch.from_numpy(local), torch.from_numpy(data),
                    torch.from_numpy(film), groups=g).numpy()
    np.testing.assert_array_equal(got[3], ref[3])
    if body == "segment_sum":
        np.testing.assert_allclose(got[:3], ref[:3], rtol=1e-6, atol=0)
    else:
        # the bf16 hi/lo product rounds each term to ~2^-17 of itself, so
        # the bound scales with the summed magnitudes, not the sum
        mag = tbs.splat_plain(torch.from_numpy(local),
                              torch.from_numpy(np.abs(data)),
                              torch.from_numpy(np.abs(film)), g).numpy()
        np.testing.assert_array_less(np.abs(got[:3] - ref[:3]),
                                     mag[:3] * 2.0 ** -16 + 1e-30)
