"""The port's single-set trace entry points, the rays-on-sublanes trace
(K9) and the microkernel integrator against the JAX package on luxball:

  K9 plain version      vs ``_trace(..., interpret=True)`` (rays in lane
                        order, K1 + K9), both modes
  _sorted_trace         vs the reference's on its production route (sort,
                        rays-on-lanes trace, unsort), both modes
  closest_hit_mxu_full, any_hit_mxu
                        with ``SORT_RAYS`` on and off
  render_sample         one sample per pixel from the same seeds: film,
                        seeds and RenderStats
  pick_single           the reference renderer's pick of the same pixel

The trace tolerances are test_torch_kernels.py's: winner columns (or
verdicts) equal on >= 99.9% of rays and |dt| <= 2^-12 t where they agree,
because XLA's CPU backend fuses ``a*b + c`` inside the reference's
interpret-mode kernels and the port does not.

On the CPU the reference runs its kernels in interpret mode, and there its
entry points skip the sort (``interpret`` selects ``_trace``). To hold the
port's sorted route to the reference's, the ``reference_route`` fixture
makes the reference take its device route — ``_interpret_pallas`` returns
False — with the trace dispatch and the resolve routed to the
interpret-mode production kernels (a test-only monkeypatch)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bxdf_types as bx
from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.accel.traverse import BVHDevice, TrianglesDevice
from fluctus_tpu.core import integrator_mk as jmk
from fluctus_tpu.core import trace as jtrace
from fluctus_tpu.core.trace import DeviceScene as JDeviceScene
from fluctus_tpu.geom import (AreaLight as JAreaLight, Camera as JCamera,
                              PostProcessParams as JPP,
                              RenderConfig as JConfig,
                              RenderParams as JParams)
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.material import materials_to_soa
from fluctus_tpu.scene.texture import pack_atlas
from fluctus_tpu.settings import Settings as JSettings
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import flags
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import trace as ttrace
from fluctus_tpu_torch.core.trace import DeviceScene as TDeviceScene
from fluctus_tpu_torch.geom import (AreaLight as TAreaLight,
                                    Camera as TCamera,
                                    PostProcessParams as TPP,
                                    RenderConfig as TConfig,
                                    RenderParams as TParams)
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3 as TVec3

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
CAM = dict(pos=(0.0, 1.6, 4.5), dir=(0.0, -0.12, -1.0), up=(0.0, 1.0, 0.0),
           right=(1.0, 0.0, 0.0), fov=60.0)
LIGHT = dict(pos=(0.0, 4.0, 0.0), N=(0.0, -1.0, 0.0), right=(1.0, 0.0, 0.0),
             up=(0.0, 0.0, 1.0), E=(50.0, 50.0, 50.0), size=(0.5, 0.5))
RT = 512
F32_MAX = np.float32(3.4028235e38)


@pytest.fixture(scope="module")
def lux():
    """(JAX scene, host arrays, port tables) of luxball's cluster tables."""
    s = JScene()
    s.load_model(LUXBALL)
    p, n, uv, mid = s.triangle_arrays()
    bvh = jbuild_bvh(p)
    host, st = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                  materials=s.materials, return_host=True)
    return dict(js=s, bvh=bvh, host=host,
                jsc=jmt.MXUScene._from_host(host, st),
                tsc=tmt.tables_from_numpy(host, st, "cpu"))


@pytest.fixture
def reference_route(monkeypatch):
    """The reference's device route on the CPU: sorted single-set traces
    through the interpret-mode rays-on-lanes kernel and the B16 resolve."""
    def rol_dispatch(o4, d4, tmax_col, scene, any_hit, ray_tile, interpret):
        return jmt._trace_rol(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                              (scene.n_clusters, scene.cluster_size), any_hit,
                              jmt.ROL_TILE, True)

    def resolve_v5(orig, d, t, col, scene, ray_tile=None, interpret=False):
        rt = ray_tile or jmt.RAY_TILE
        n = col.shape[0]
        o4, d4, _ = jmt._ray_inputs(orig, d, scene, None, rt)
        col2, _ = jmt._pad_rays(col.reshape(n, 1), rt)
        return jmt._resolve_v5(col2, o4, d4, scene.b16t, scene.t12b,
                               (scene.n_clusters, scene.cluster_size), rt,
                               True)[:, :n]
    monkeypatch.setattr(jtrace, "_interpret_pallas", lambda: False)
    monkeypatch.setattr(jmt, "_dispatch_trace", rol_dispatch)
    monkeypatch.setattr(jmt, "resolve_hits_mxu", resolve_v5)


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _world_rays(lux, kind, n, seed):
    """World-space (origins, unit directions) as numpy: camera rays of a
    jittered film, or rays leaving random points of the scene bounds in
    random directions."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        px, py = rng.random(n), rng.random(n)
        o = np.tile(np.array([0.0, 1.6, 4.5], np.float32), (n, 1))
        d = _unit(np.stack([px * 2 - 1, (py * 2 - 1) * 0.6 - 0.12,
                            -np.ones(n)], 1))
    else:
        tsc = lux["tsc"]
        lo = (tsc.lo + tsc.center).numpy()
        hi = (tsc.hi + tsc.center).numpy()
        o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
        d = _unit(rng.normal(size=(n, 3)))
    return o.astype(np.float32), d


def _vecs(o, d):
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    tv = lambda a: TVec3(*(torch.from_numpy(a[:, k].copy())
                           for k in range(3)))
    return (jv(o), jv(d)), (tv(o), tv(d))


def _tmax(n, seed):
    """Shadow-style tmax: a third of the lanes dead (0), a twentieth +inf
    (the megastep's shadow rays of lanes whose path ended on a miss), the
    rest random."""
    rng = np.random.default_rng(seed)
    tm = (rng.random(n) * 6.0).astype(np.float32)
    tm = np.where(rng.random(n) < 0.05, np.inf, tm)
    return np.where(rng.random(n) < 0.33, 0.0, tm).astype(np.float32)


def _inputs(lux, kind, n, seed, with_tmax):
    """The padded (o4, d4, tmax [b,1]) of both packages from one ray set."""
    o, d = _world_rays(lux, kind, n, seed)
    (jo, jd), (to, td) = _vecs(o, d)
    tm = _tmax(n, seed + 1) if with_tmax else None
    j = jmt._ray_inputs(jo, jd, lux["jsc"],
                        None if tm is None else jnp.asarray(tm), RT)
    t = tmt._ray_inputs(to, td, lux["tsc"],
                        None if tm is None else torch.from_numpy(tm), RT)
    return j, t


def _check_trace(t, i, jt, ji):
    """Winner columns / verdicts equal on >= 99.9% of rays; t within 2^-12
    relative where they agree."""
    same = i == ji
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_less(np.abs(t - jt)[same],
                                 np.abs(jt)[same] * 2.0 ** -12 + 1e-30)


def test_tables_carry_vertex_transforms(lux):
    """tx/ty/tz and txy_t reach the device tables unchanged on a non-slim
    scene; slim tables leave tx/ty/tz out, and the rays-on-sublanes
    routes then refuse with the reference's message."""
    host, tsc = lux["host"], lux["tsc"]
    for k in ("tx", "ty", "tz", "txy_t"):
        np.testing.assert_array_equal(getattr(tsc, k).numpy(), host[k])
    np.testing.assert_array_equal(
        torch.cat([tsc.tx, tsc.ty, tsc.tz]).numpy(), tsc.t12.numpy())
    slim = tsc._replace(tx=None, ty=None, tz=None)
    o4 = torch.zeros((RT, 4))
    with pytest.raises(ValueError, match="use the ROL/SC kernels"):
        old, flags.ROL = flags.ROL, False
        try:
            tmt._dispatch_trace(o4, o4, torch.ones((RT, 1)), slim, False)
        finally:
            flags.ROL = old
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="unset FLT_SORT_RAYS=0"):
        old, flags.SORT_RAYS = flags.SORT_RAYS, False
        try:
            ttrace.trace_extension_raw(TVec3(z, z, z), TVec3(z, z, z + 1),
                                       TDeviceScene(slim, 0))
        finally:
            flags.SORT_RAYS = old


@pytest.mark.parametrize("kind,any_hit", [("camera", False),
                                          ("bounce", False),
                                          ("bounce", True)])
def test_k9_trace_ros(lux, kind, any_hit):
    """K9's plain version (after K1 on the same lane-order tiles) against
    the reference's rays-on-sublanes trace in interpret mode."""
    jsc, tsc = lux["jsc"], lux["tsc"]
    (jo4, jd4, jtm), (to4, td4, ttm) = _inputs(lux, kind, 2048, 7, any_hit)
    static = (tsc.n_clusters, tsc.cluster_size)
    jt, ji = jmt._trace(jo4, jd4, jtm, (jsc.tx, jsc.ty, jsc.tz,
                                        jsc.cluster_box), static, any_hit,
                        RT, True)
    tmt.K9.plain_runs = 0
    tt, ti = tmt._trace(to4, td4, ttm, (tsc.tx, tsc.ty, tsc.tz,
                                        tsc.cluster_box), static, any_hit, RT)
    assert tmt.K9.plain_runs == 1
    assert (np.asarray(ji) >= 0).mean() > 0.05      # real hits traced
    _check_trace(tt.numpy(), ti.numpy(), np.asarray(jt), np.asarray(ji))
    if any_hit:
        # tmax = +inf: a swept cluster blocks the ray even where no
        # triangle is valid (its F32_MAX stand-in is below +inf), as in
        # the reference; the verdicts there are exact
        inf = np.isinf(np.asarray(jtm)[:, 0])
        assert inf.sum() > 20
        np.testing.assert_array_equal(ti.numpy()[inf], np.asarray(ji)[inf])


@pytest.mark.parametrize("any_hit,with_tmax", [(False, False), (False, True),
                                               (True, True)])
def test_sorted_trace(lux, reference_route, any_hit, with_tmax):
    """The single-set sorted trace (exit clamp, coherence key, one sort,
    rays-on-lanes trace, unsort) on 1500 bounce rays (not a tile
    multiple)."""
    (jo4, jd4, jtm), (to4, td4, ttm) = _inputs(lux, "bounce", 1500, 11,
                                               with_tmax)
    jt, ji = jmt._sorted_trace(jo4, jd4, jtm if with_tmax else None,
                               lux["jsc"], any_hit, RT, False)
    tt, ti = tmt._sorted_trace(to4, td4, ttm if with_tmax else None,
                               lux["tsc"], any_hit, RT)
    assert (np.asarray(ji) >= 0).mean() > 0.05
    _check_trace(tt.numpy(), ti.numpy(), np.asarray(jt), np.asarray(ji))


@pytest.mark.parametrize("sort_rays", [True, False])
def test_entry_points(lux, reference_route, monkeypatch, sort_rays):
    """closest_hit_mxu_full (t, tri, u, v from the winner's transform row)
    and any_hit_mxu on 1500 rays, sorted or in lane order (K9). Triangle
    ids and verdicts as the trace; u, v within 2^-12 where they agree."""
    monkeypatch.setattr(jmt, "SORT_RAYS", sort_rays)
    monkeypatch.setattr(flags, "SORT_RAYS", sort_rays)
    tmt.K9.plain_runs = 0
    o, d = _world_rays(lux, "bounce", 1500, 13)
    (jo, jd), (to, td) = _vecs(o, d)
    # off the sorted route the reference's entry points take _trace,
    # which on the CPU runs only in interpret mode
    interp = not sort_rays
    jt, jtri, ju, jv, _ = jmt.closest_hit_mxu_full(jo, jd, lux["jsc"],
                                                   interpret=interp)
    tt, ttri, tu, tv, _ = tmt.closest_hit_mxu_full(to, td, lux["tsc"])
    _check_trace(tt.numpy(), ttri.numpy(), np.asarray(jt), np.asarray(jtri))
    same = (ttri.numpy() == np.asarray(jtri)) & (ttri.numpy() >= 0)
    for a, b in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=0, atol=2.0 ** -12)
    tm = _tmax(1500, 17)
    jocc = np.asarray(jmt.any_hit_mxu(jo, jd, jnp.asarray(tm), lux["jsc"],
                                      interpret=interp))
    tocc = tmt.any_hit_mxu(to, td, torch.from_numpy(tm), lux["tsc"]).numpy()
    assert jocc.mean() > 0.05 and (tocc == jocc).mean() >= 0.999
    assert tmt.K9.plain_runs == (0 if sort_rays else 2)


def _mk_setup(lux, w, h, depth):
    js = lux["js"]
    p, n, uv, mid = js.triangle_arrays()
    types = js.material_types
    assert types == bx.BXDF_DIFFUSE | bx.BXDF_IDEAL_DIELECTRIC
    wr = js.world_radius()
    jscene = JDeviceScene(
        tris=TrianglesDevice.from_arrays(p, n, uv, mid),
        bvh=BVHDevice.from_host(lux["bvh"]),
        mats=materials_to_soa(js.materials), atlas=pack_atlas([]), env=None,
        material_types=types, mxu=lux["jsc"])
    jparams = JParams(camera=JCamera.make(**CAM),
                      area_light=JAreaLight.make(**LIGHT),
                      env_map_strength=jnp.float32(1.0),
                      world_radius=jnp.float32(wr),
                      pp=JPP(jnp.float32(1.0), jnp.int32(2)))
    jcfg = JConfig(width=w, height=h, max_bounces=depth, use_env_map=False,
                   use_area_light=True, material_types=types, backend="mxu",
                   unroll_bounces=True)
    tscene = TDeviceScene(mxu=lux["tsc"], material_types=types)
    tparams = TParams(camera=TCamera.make(**CAM, device="cpu"),
                      area_light=TAreaLight.make(**LIGHT, device="cpu"),
                      world_radius=torch.tensor(wr, dtype=torch.float32),
                      pp=TPP(torch.tensor(1.0), 2))
    tcfg = TConfig(width=w, height=h, max_bounces=depth, material_types=types)
    return (jscene, jparams, jcfg), (tscene, tparams, tcfg)


def test_render_sample_matches_reference(lux, reference_route):
    """One render_sample at 32x16 (depth 5) from seeds = pixel ids, the film
    holding an earlier sample: seeds and RenderStats bit-equal, film weight
    exact, rgb rtol 1e-5 (atol 1e-6)."""
    w, h = 32, 16
    (js, jp, jc), (ts, tp, tc) = _mk_setup(lux, w, h, 5)
    npx = w * h
    rng = np.random.default_rng(19)
    color = rng.random((3, npx)).astype(np.float32)
    jfilm = jmk.Film(JVec3(*(jnp.asarray(c) for c in color)),
                     jnp.ones(npx, jnp.float32))
    tfilm = tmk.Film(TVec3(*(torch.from_numpy(c.copy()) for c in color)),
                     torch.ones(npx))
    jf, jseed, jst = jmk.render_sample(js, jp, jfilm,
                                       jnp.arange(npx, dtype=jnp.uint32), jc)
    tf, tseed, tst = tmk.render_sample(ts, tp, tfilm,
                                       torch.arange(npx, dtype=torch.int64),
                                       tc)
    np.testing.assert_array_equal(tseed.numpy(),
                                  np.asarray(jseed).astype(np.int64))
    assert list(tst) == [int(x) for x in jst]
    assert tst.shadow_rays > 0 and tst.extension_rays > 0
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    np.testing.assert_allclose(np.stack([c.numpy() for c in tf.color]),
                               np.stack([np.asarray(c) for c in jf.color]),
                               rtol=1e-5, atol=1e-6)
    assert (np.stack([c.numpy() for c in tf.color]) > color).any()


def test_pick_single_matches_reference(tmp_path):
    """Renderer.pick_single at three NDC points (the last past the film's
    edge, clamped to its corner, where the ray misses) against the
    reference renderer's pick on the same film: hit and triangle equal,
    t rtol 1e-6; pick_dof_depth moves the focal distance to the picked
    t."""
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path / "port"),
                 device="cpu")
    r.load_scene(LUXBALL)
    js = JSettings()
    js.camera.pos, js.camera.dir = CAM["pos"], CAM["dir"]
    jr = JRenderer(16, 8, settings=js, data_dir=str(tmp_path))
    jr.load_scene(LUXBALL, use_saved_state=False)
    for ndc in ((0.5, 0.5), (0.3, 0.2), (1.2, 0.9)):
        ok, t, tri = r.pick_single(*ndc)
        jok, jt, jtri = jr.pick_single(*ndc)
        assert (ok, tri) == (jok, jtri) and ok == (ndc[0] < 1.0)
        np.testing.assert_allclose(t, jt, rtol=1e-6)
    assert r.pick_dof_depth(0.5, 0.5)
    assert r.settings.camera.focal_dist == r.pick_single(0.5, 0.5)[1]
    assert float(r.params.camera.focal_dist) == np.float32(
        r.settings.camera.focal_dist)
