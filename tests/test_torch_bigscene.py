"""The port's large-scene path against the JAX package on the CPU, on the
in-repo 2x2 luxball grid (22,568 triangles, 129 clusters, 3
superclusters: past the 96-cluster tier switch):

  (a) ``.sc.json`` loading (instancing, scale, skipMaterials, material
      overrides): triangle arrays bit-equal, materials equal
  (b) the native SAH builder: every BVH array equal
  (c) slim host tables and the supercluster boxes: bit-equal
  (d) K5 plain vs the interpret-mode ``_trace_rol_sc``: winner columns /
      any-hit verdicts equal on >= 99.9% of rays, |dt| <= 2^-12 t
  (e) K6 plain vs the interpret-mode ``_resolve_v5s``: integer and
      material rows exact, rows from the recomputed t/u/v within 2^-12
  (f) the tier switches pick K5 exactly past SC_THRESHOLD clusters and K6
      exactly past RESOLVE_RESIDENT_BYTES (plain_runs counters)
  (g) 4 wavefront segments against the JAX integrator routed to its
      supercluster trace and streamed resolve: integer state and counters
      bit-equal, film rtol 1e-5 (atol 1e-6)

Why (d) and (e) are not bit for bit: XLA's CPU backend contracts ``a*b+c``
into a fused multiply-add inside the interpret-mode kernel bodies, while
the port rounds twice, as its CUDA kernels do
(test_torch_kernels.py::test_xla_cpu_contracts_fma).
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bxdf_types as bx
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.accel.traverse import BVHDevice, TrianglesDevice
from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.core.trace import DeviceScene as JDeviceScene
from fluctus_tpu.geom import (AreaLight as JAreaLight, Camera as JCamera,
                              PostProcessParams as JPP,
                              RenderConfig as JConfig,
                              RenderParams as JParams)
from fluctus_tpu import native as jnative
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.material import materials_to_soa
from fluctus_tpu.scene.texture import pack_atlas

from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.core.trace import DeviceScene as TDeviceScene
from fluctus_tpu_torch.geom import (AreaLight as TAreaLight,
                                    Camera as TCamera,
                                    PostProcessParams as TPP,
                                    RenderConfig as TConfig,
                                    RenderParams as TParams)
from fluctus_tpu_torch.native import build_bvh_native as tbuild_native
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.scene import Scene as TScene
from fluctus_tpu_torch.settings import Settings

ROOT = os.path.join(os.path.dirname(__file__), "..")
GRID = os.path.join(ROOT, "fluctus_tpu_torch", "scenes",
                    "luxball_grid_2x2.sc.json")
LUXBALL = os.path.abspath(os.path.join(ROOT, "data", "luxball",
                                       "luxball.obj"))
RT = 512
F32_MAX = np.float32(3.4028235e38)
# the 8x8 grid's statics (361,088 triangles), as chip_smoke.py reports them
GRID8_CLUSTERS, TC = 2056, 256
CAM = dict(pos=(0.0, 8.5, 12.0), dir=(0.0, -1.0, -1.0), up=(0.0, 1.0, 0.0),
           right=(1.0, 0.0, 0.0), fov=60.0)
LIGHT = dict(pos=(0.0, 5.0, 0.0), N=(0.0, -1.0, 0.0), right=(1.0, 0.0, 0.0),
             up=(0.0, 0.0, 1.0), E=(50.0, 50.0, 50.0), size=(1.5, 1.5))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The 2x2 grid loaded by both packages, its native BVH and the JAX
    package's host tables (full and slim). The JAX package's native
    library is compiled into a private directory: its own tests compile
    it in place, non-atomically, from other test processes."""
    js, ts = JScene(), TScene()
    js.load_model(GRID)
    ts.load_model(GRID)
    p, n, uv, mid = js.triangle_arrays()
    lib = tmp_path_factory.mktemp("jnative") / "libflbvh.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", str(lib))
        mp.setattr(jnative, "_lib", None)
        bvh = jnative.build_bvh_native(p)
    kw = dict(normals=n, uvs=uv, mat_ids=mid, materials=js.materials,
              return_host=True)
    host, st = jmt.MXUScene.build(p, bvh, **kw)
    slim, slim_st = jmt.MXUScene.build(p, bvh, slim=True, **kw)
    return dict(js=js, ts=ts, bvh=bvh, host=host, st=st, slim=slim,
                slim_st=slim_st)


@pytest.fixture(scope="module")
def tables(grid):
    host, st = grid["host"], grid["st"]
    return (jmt.MXUScene._from_host(host, st),
            tmt.tables_from_numpy(host, st, "cpu"))


def _write(tmp_path, entries):
    path = tmp_path / "comp.sc.json"
    path.write_text(json.dumps(entries))
    return str(path)


def _assert_scenes_equal(js, ts):
    for a, b in zip(js.triangle_arrays(), ts.triangle_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [m.__dict__ for m in js.materials] == \
        [m.__dict__ for m in ts.materials]
    assert js.material_types == ts.material_types


def test_a_grid_loads_equal(grid):
    """The 2x2 composition: 4 instances of luxball, bit-equal arrays."""
    js, ts = grid["js"], grid["ts"]
    _assert_scenes_equal(js, ts)
    assert ts.num_triangles == 4 * 5642
    lo, hi = ts.scene_bounds()
    np.testing.assert_array_equal(lo[[0, 2]], [-12.0, -12.0])
    np.testing.assert_array_equal(hi[[0, 2]], [12.0, 12.0])


def test_a_overrides_load_equal(tmp_path):
    """scale, skipMaterials and per-instance material overrides (a
    re-inferred diffuse+specular mix, an explicit diffuse shader) load to
    the same arrays and material rows in both packages."""
    path = _write(tmp_path, [
        {"file": LUXBALL, "scale": 0.5, "translation": [1.0, 0.0, 2.0],
         "skipMaterials": ["ground"]},
        {"file": LUXBALL, "scale": 2.0, "translation": [-3.0, 0.0, 0.0],
         "skipMaterials": ["ground"],
         "materials": {"core": {"Kd": [0.1, 0.7, 0.2],
                                "Ks": [0.3, 0.3, 0.3]}}},
        {"file": LUXBALL,
         "materials": {"ground": {"shader": "diffuse",
                                  "Kd": [0.3, 0.35, 0.4]}}},
    ])
    js, ts = JScene(), TScene()
    js.load_model(path)
    ts.load_model(path)
    _assert_scenes_equal(js, ts)
    mid = ts.triangle_arrays()[3]
    # instance 2 reuses instance 1's parse (same skip set) with a cloned
    # core; instance 3 (no skip set) parses the file again
    names = [m.name for m in ts.materials]
    assert names == ["<default>", "glass", "core", "ground", "core@4",
                     "glass", "core", "ground", "ground@8"]
    assert ts.materials[4].type == bx.BXDF_MIXED
    assert ts.materials[8].Kd == (0.3, 0.35, 0.4)
    # only the third instance keeps ground triangles, all overridden
    assert (mid == 3).sum() == 0 and (mid == 7).sum() == 0
    assert (mid == 8).sum() > 0 and (mid == 4).sum() == (mid == 2).sum()


def test_a_glossy_override_renders(tmp_path):
    """An override to a GGX lobe (glossy, with Ns and Ks) loads and
    renders: its material row equals the reference's, the config carries
    the glossy bit, and 2 wavefront segments give a finite film."""
    path = _write(tmp_path, [{"file": LUXBALL, "materials": {
        "core": {"shader": "glossy", "Ks": [0.9, 0.9, 0.9], "Ns": 200}}}])
    r = Renderer(32, 16, data_dir=str(tmp_path), device="cpu")
    r.load_scene(path)
    js = JScene()
    js.load_model(path)
    _assert_scenes_equal(js, r.scene)
    assert r.config.material_types & bx.BXDF_GLOSSY
    r.init_wavefront(512)
    r.render_wavefront(2)
    film = r.wavefront_film()
    for c in (*film.color, film.weight):
        assert torch.isfinite(c).all()
    assert float(film.weight.sum()) > 0


def test_b_native_bvh_equal(grid):
    p = grid["ts"].triangle_arrays()[0]
    ours = tbuild_native(p)
    for name, a, b in zip(ours._fields, grid["bvh"], ours):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_c_slim_tables_bit_equal(grid):
    """MXUScene.build(slim=True): the same keys, the same dropped tables,
    every array (sc_box included) bit-equal, the same statics."""
    p, n, uv, mid = grid["ts"].triangle_arrays()
    th, tst = tmt.MXUScene.build(p, tbuild_native(p), normals=n, uvs=uv,
                                 mat_ids=mid,
                                 materials=grid["ts"].materials, slim=True)
    jh, jst = grid["slim"], grid["slim_st"]
    assert tst == jst and (tst["n_clusters"], tst["n_superclusters"]) == \
        (129, 3)
    assert jh.keys() == th.keys()
    for k in jh:
        if jh[k] is None:
            assert th[k] is None, k
            continue
        a, b = _bits(jh[k]), _bits(th[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("attrs", "attr_b16", "tx", "ty", "tz"):
        assert th[k] is None, k
    assert th["sc_box"].shape == (3, 8) and th["txy_t"] is not None


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays(tsc, n=1024, seed=0):
    """(o4, d4, exit-clamped tmax) as numpy: origins scattered around the
    grid, directions towards random points inside its bounds."""
    rng = np.random.default_rng(seed)
    lo, hi = tsc.lo.numpy(), tsc.hi.numpy()
    ext = np.linalg.norm(hi - lo)
    o = ((lo + hi) / 2 + rng.standard_normal((n, 3)) * 0.4 * ext).astype(
        np.float32)
    d = _unit(lo + rng.random((n, 3)) * (hi - lo) - o)
    o4 = np.concatenate([o, np.ones((n, 1))], 1).astype(np.float32)
    d4 = np.concatenate([d, np.zeros((n, 1))], 1).astype(np.float32)
    tm = tmt._exit_clamp(torch.from_numpy(o4), torch.from_numpy(d4),
                         torch.full((n, 1), float(F32_MAX)), tsc.lo, tsc.hi)
    return o4, d4, tm.numpy()


@pytest.mark.parametrize("any_hit", [False, True])
def test_d_k5_trace(tables, any_hit):
    """K1 over the supercluster boxes bit-equal (cons and order); then K5
    plain against the interpret-mode two-level kernel."""
    jsc, tsc = tables
    o4, d4, tm = _rays(tsc, seed=1)
    if any_hit:   # shadow-style: a third dead, the rest cut short
        rng = np.random.default_rng(2)
        f = rng.random(tm.shape).astype(np.float32) * 1.2
        tm = np.where(rng.random(tm.shape) < 0.33, 0.0, tm * f).astype(
            np.float32)
    order, cons = jmt._tile_order_v2(jnp.asarray(o4), jnp.asarray(d4),
                                     jnp.asarray(tm), jsc.sc_box, RT,
                                     interpret=True)
    rays = tmt._pack_rays(torch.from_numpy(o4), torch.from_numpy(d4), RT)
    tord, tkey = tmt._candidate_order(tmt.tile_order_plain(
        rays, torch.from_numpy(tm).reshape(-1, RT), tsc.sc_box))
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(cons)[:, :, 0])
    np.testing.assert_array_equal(tord.numpy(), np.asarray(order)[:, :, 0])

    jt, ji = jmt._trace_rol_sc(jnp.asarray(o4), jnp.asarray(d4),
                               jnp.asarray(tm), jsc.t12, jsc.cluster_box,
                               jsc.sc_box, (jsc.n_superclusters, TC),
                               any_hit, RT, True)
    tmt.K5.plain_runs = 0
    tt, ti = tmt._trace_rol_sc(torch.from_numpy(o4), torch.from_numpy(d4),
                               torch.from_numpy(tm), tsc.t12,
                               tsc.cluster_box, tsc.sc_box, TC, any_hit, RT)
    assert tmt.K5.plain_runs == 1
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = tt.numpy(), ti.numpy()
    assert (ji >= 0).mean() > (0.1 if any_hit else 0.2)   # real hits
    same = ti == ji
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_less(np.abs(tt - jt)[same],
                                 np.abs(jt)[same] * 2.0 ** -12 + 1e-30)


def test_e_k6_resolve(tables, grid):
    """K6 plain against the interpret-mode streamed resolve on the winners
    of a K5 trace (the reference's slim tables)."""
    jsc, tsc = tables
    o4, d4, tm = _rays(tsc, seed=3)
    _, col = tmt._trace_rol_sc(torch.from_numpy(o4), torch.from_numpy(d4),
                               torch.from_numpy(tm), tsc.t12,
                               tsc.cluster_box, tsc.sc_box, TC, False, RT)
    slim = grid["slim"]
    ref = np.asarray(jmt._resolve_v5s(
        jnp.asarray(col.numpy()), jnp.asarray(o4), jnp.asarray(d4),
        jnp.asarray(slim["b16t"]), jnp.asarray(slim["t12b"]),
        (tsc.n_clusters, TC), RT, True))
    tmt.K6.plain_runs = 0
    got = tmt.resolve_v5s(col[:, 0].contiguous(), torch.from_numpy(o4),
                          torch.from_numpy(d4), tsc.b16r, tsc.t16r).numpy()
    assert tmt.K6.plain_runs == 1
    assert (col.numpy() >= 0).mean() > 0.2
    exact = [tmt.ATTR_MAT, tmt.ATTR_TYPE, tmt.ATTR_MAP_KD, tmt.ATTR_MAP_KS,
             tmt.ATTR_MAP_N, tmt.ATTR_TRI] + list(range(tmt.ATTR_KD,
                                                       tmt.ATTR_D + 1)) \
        + list(range(tmt.ATTR_TKD_WH, tmt.ATTR_COLS))
    np.testing.assert_array_equal(got[exact], ref[exact])
    bary = list(range(tmt.ATTR_N, tmt.ATTR_UV + 2)) + [tmt.ATTR_HITU,
                                                       tmt.ATTR_HITV]
    np.testing.assert_allclose(got[bary], ref[bary], rtol=0,
                               atol=2.0 ** -12)
    t, jt = got[tmt.ATTR_HITT], ref[tmt.ATTR_HITT]
    np.testing.assert_array_less(np.abs(t - jt), np.abs(jt) * 2.0 ** -12
                                 + 1e-30)


def test_f_tier_switches(tables, monkeypatch):
    """The trace takes K5 exactly when n_clusters > SC_THRESHOLD and the
    resolve takes K6 exactly when the reference's table bytes exceed
    RESOLVE_RESIDENT_BYTES; at the 8x8 grid's statics (160.6 MiB of
    tables) that is K6, at the 2x2 grid's (10.1 MiB) K3."""
    from fluctus_tpu_torch.kernel_build import reset_counts
    from fluctus_tpu_torch.vec import Vec3
    _, tsc = tables
    assert tsc.n_clusters == 129 > tmt.SC_THRESHOLD == 96
    big = tmt.resolve_table_bytes(GRID8_CLUSTERS, TC)
    small = tmt.resolve_table_bytes(tsc.n_clusters, TC)
    assert big == 168_427_520 > tmt.RESOLVE_RESIDENT_BYTES == 48 << 20
    assert small == 10_567_680 < tmt.RESOLVE_RESIDENT_BYTES
    # the reference's own byte count on its tables, as it dispatches
    jsc, _ = tables
    assert small == jsc.b16t.size * 2 + jsc.t12b.size * 4

    o4, d4, tm = _rays(tsc, n=RT, seed=5)
    args = (torch.from_numpy(o4), torch.from_numpy(d4), torch.from_numpy(tm))
    for threshold, kernel in ((128, "K5"), (129, "K2")):
        monkeypatch.setattr(tmt, "SC_THRESHOLD", threshold)
        reset_counts()
        tmt._dispatch_trace(*args, tsc, False)
        assert (tmt.K5.plain_runs, tmt.K2.plain_runs) == \
            ((1, 0) if kernel == "K5" else (0, 1)), threshold

    c = tsc.center.numpy()
    orig = Vec3(*(torch.from_numpy(o4[:, k] + c[k]) for k in range(3)))
    d = Vec3(*(torch.from_numpy(d4[:, k]) for k in range(3)))
    col = torch.arange(RT, dtype=torch.int32) * 7
    for budget, kernel in ((small - 1, "K6"), (small, "K3")):
        monkeypatch.setattr(tmt, "RESOLVE_RESIDENT_BYTES", budget)
        reset_counts()
        tmt.resolve_hits_mxu(orig, d, None, col, tsc)
        assert (tmt.K6.plain_runs, tmt.K3.plain_runs) == \
            ((1, 0) if kernel == "K6" else (0, 1)), budget


@pytest.fixture
def reference_sc_kernels(monkeypatch):
    """Route the JAX package's dispatch to its interpret-mode supercluster
    trace, streamed resolve and segment-sum splat."""
    def sc_dispatch(o4, d4, tmax_col, scene, any_hit, ray_tile, interpret):
        return jmt._trace_rol_sc(o4, d4, tmax_col, scene.t12,
                                 scene.cluster_box, scene.sc_box,
                                 (scene.n_superclusters, scene.cluster_size),
                                 any_hit, jmt.ROL_TILE, True)

    def resolve_v5s(orig, d, t, col, scene, ray_tile=None, interpret=False):
        rt = ray_tile or jmt.RAY_TILE
        n = col.shape[0]
        o4, d4, _ = jmt._ray_inputs(orig, d, scene, None, rt)
        col2, _ = jmt._pad_rays(col.reshape(n, 1), rt)
        return jmt._resolve_v5s(col2, o4, d4, scene.b16t, scene.t12b,
                                (scene.n_clusters, scene.cluster_size), rt,
                                True)[:, :n]
    splat = jbs.splat
    monkeypatch.setattr(jmt, "_dispatch_trace", sc_dispatch)
    monkeypatch.setattr(jmt, "resolve_hits_mxu", resolve_v5s)
    monkeypatch.setattr(jbs, "splat",
                        lambda *a, **k: splat(*a, **{**k, "interpret": True}))


def _jax_state_to_numpy(st):
    def v(x):
        return tuple(np.asarray(c) for c in x) if isinstance(x, tuple) \
            else np.asarray(x)
    pool = {k: v(x) for k, x in st.pool._asdict().items() if x is not None}
    return dict(pool=pool, film=dict(color=v(st.film.color),
                                     weight=np.asarray(st.film.weight)),
                spp=np.asarray(st.spp), curr_pixel=np.asarray(st.curr_pixel))


def test_g_wavefront_slice(grid, tables, reference_sc_kernels):
    """4 segments at 64x32 with 2048 paths from one reset: the port (K5
    via its own tier switch; K3, the tables being small) against the JAX
    integrator on its supercluster trace and streamed resolve. Integer
    state and the four counters bit-equal; film weight exact, rgb rtol
    1e-5 (atol 1e-6)."""
    W, H, PATHS, GROUPS = 64, 32, 2048, 16
    jsc, tsc = tables
    js = grid["js"]
    p, n, uv, mid = js.triangle_arrays()
    types = js.material_types
    wr = js.world_radius()
    jscene = JDeviceScene(
        tris=TrianglesDevice.from_arrays(p, n, uv, mid),
        bvh=BVHDevice.from_host(grid["bvh"]),
        mats=materials_to_soa(js.materials), atlas=pack_atlas([]), env=None,
        material_types=types, mxu=jsc)
    jp = JParams(camera=JCamera.make(**CAM),
                 area_light=JAreaLight.make(**LIGHT),
                 env_map_strength=jnp.float32(1.0),
                 world_radius=jnp.float32(wr),
                 pp=JPP(jnp.float32(1.0), jnp.int32(2)))
    jc = JConfig(width=W, height=H, max_bounces=10, use_env_map=False,
                 use_area_light=True, material_types=types, backend="mxu",
                 block_ring=True, groups=GROUPS)
    ts = TDeviceScene(mxu=tsc, material_types=types)
    tp = TParams(camera=TCamera.make(**CAM, device="cpu"),
                 area_light=TAreaLight.make(**LIGHT, device="cpu"),
                 world_radius=torch.tensor(wr, dtype=torch.float32),
                 pp=TPP(torch.tensor(1.0), 2))
    tc = TConfig(width=W, height=H, max_bounces=10, material_types=types,
                 groups=GROUPS)

    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
    from fluctus_tpu_torch.kernel_build import reset_counts
    reset_counts()
    for seg in range(4):
        raw, occ = jwf.wf_trace_phase(jscene, jst.pool, jp, jc)
        jst, jcnt = jwf.wf_shade_phase(jscene, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _jax_state_to_numpy(jst)
        for k in ("pixel_index", "seed", "path_len"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                          err_msg=f"{k}, segment {seg}")
        np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
    assert (tmt.K5.plain_runs, tmt.K2.plain_runs) == (8, 0)
    assert int(jcnt.splatted) > 0 and int(jcnt.shadow) > 0
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


def test_renderer_renders_grid_on_cpu(tmp_path):
    """Renderer(device="cpu") loads the 2x2 composition (129 clusters) and
    runs 4 segments through the two-level tier: a finite film."""
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    r = Renderer(48, 32, settings=s, data_dir=str(tmp_path), device="cpu")
    r.load_scene(GRID)
    assert r.device_scene.mxu.n_clusters == 129
    r.init_wavefront(1024)
    tmt.K5.plain_runs = 0
    r.render_wavefront(4)
    assert tmt.K5.plain_runs == 8
    film = r.wavefront_film()
    for c in (*film.color, film.weight):
        assert torch.isfinite(c).all()
    st = r.wavefront_stats()
    assert float(film.weight.sum()) == st.samples > 0
