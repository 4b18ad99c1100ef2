"""The port's textures against the JAX package, on the CPU:

  HostTexture,          PNGs the test writes (RGBA, RGB, grey, 1 x 1):
  pack_atlas            rows, texel words and descriptors bit-equal
  texel fetch           _fetch_texel, fetch_texture, mat_get_float3 (with
                        and without baked descriptors) on seeded uv with
                        negative, > 1 and whole-number values: bit-equal,
                        every texel distinct so the texel ids are equal
                        too; mat_get_albedo's pow 2.2 within rtol 1e-6
  MXUScene.build        the production luxball's tables with the atlas
                        descriptors baked (B16 and attrs): every host
                        array bit-equal; the table cache round trip
  resolve rows          K3's and K10's plain versions against the
                        reference's interpret-mode kernels on rows 22-34
                        (map indices, triangle, u, v, t, descriptors)
  tangent_space_normal  seeded hits on the production tables: rtol 1e-5
                        (atol 1e-6)
  loading               the textured OBJ + MTL in both packages: the
                        same materials, textures and atlas
  wavefront, megastep   4 segments and one megastep sample of the
                        production luxball (textured, normal-mapped,
                        every GGX lobe), as test_torch_wavefront.py and
                        test_torch_mk.py hold luxball

The production luxball (chip_smoke.write_production_scene) is written
here with small maps (64^2, 32^2 and 16^2 texels). It has every GGX lobe
(glossy, rough reflection, rough dielectric), so its segments and
megastep sample also hold those lobes in a scene. The helpers of the last
two items serve test_torch_switches.py too."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bxdf_types as bx
from fluctus_tpu import texture_fetch as jtf
from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.accel.traverse import BVHDevice, TrianglesDevice
from fluctus_tpu.core import integrator_mk as jmk
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.core import trace as jtrace
from fluctus_tpu.core.trace import DeviceScene as JDeviceScene
from fluctus_tpu.geom import (AreaLight as JAreaLight, Camera as JCamera,
                              Hit as JHit, PostProcessParams as JPP,
                              RenderConfig as JConfig,
                              RenderParams as JParams)
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.material import materials_to_soa
from fluctus_tpu.scene.texture import HostTexture as JHostTexture
from fluctus_tpu.scene.texture import pack_atlas as jpack_atlas
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import texture_fetch as ttf
from fluctus_tpu_torch.accel import build_bvh
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.core import trace as ttrace
from fluctus_tpu_torch.core.trace import DeviceScene as TDeviceScene
from fluctus_tpu_torch.geom import (AreaLight as TAreaLight,
                                    Camera as TCamera, Hit as THit,
                                    PostProcessParams as TPP,
                                    RenderConfig as TConfig,
                                    RenderParams as TParams)
from fluctus_tpu_torch.renderer import Renderer, table_cache_path
from fluctus_tpu_torch.scene import Scene as TScene
from fluctus_tpu_torch.scene.texture import (HostTexture, atlas_from_numpy,
                                             pack_atlas)
from fluctus_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import write_production_scene  # noqa: E402

from test_torch_mk import reference_route  # noqa: F401
from test_torch_wavefront import (CAM, LIGHT, _jax_state_to_numpy,
                                  reference_kernels)  # noqa: F401

MAP_SIZES = (64, 32, 16)
RT = 512


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                   for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], axis=1)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def prod_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("production"))
    write_production_scene(d, MAP_SIZES, seed=3)
    return d


def port_atlas(jatlas):
    """The reference's atlas carried across as the port's."""
    return atlas_from_numpy(
        np.asarray(jatlas.texels), np.asarray(jatlas.offset),
        np.asarray(jatlas.width), np.asarray(jatlas.height),
        count=jatlas.count, device="cpu")._replace(
            has_kd=jatlas.has_kd, has_ks=jatlas.has_ks, has_n=jatlas.has_n)


def scene_setup(path, w, h, depth, groups=16):
    """(reference scene, params, config), (port scene, params, config) and
    the world radius of a scene file: the reference's host tables and
    atlas carried across, camera and light of test_torch_wavefront.py;
    the config with the block ring (wavefront) and unrolled bounces
    (megastep)."""
    js = JScene()
    js.load_model(path)
    p, n, uv, mid = js.triangle_arrays()
    bvh = jbuild_bvh(p)
    jatlas = js.device_textures()
    host, st = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                  materials=js.materials, atlas=jatlas,
                                  return_host=True)
    types = js.material_types
    wr = js.world_radius()
    jscene = JDeviceScene(
        tris=TrianglesDevice.from_arrays(p, n, uv, mid),
        bvh=BVHDevice.from_host(bvh), mats=materials_to_soa(js.materials),
        atlas=jatlas, env=None, material_types=types,
        mxu=jmt.MXUScene._from_host(host, st))
    tatlas = port_atlas(jatlas)
    tscene = TDeviceScene(
        mxu=tmt.tables_from_numpy(host, st, "cpu"), material_types=types,
        atlas=tatlas,
        tri_frames=(ttrace.make_tri_frames(p, uv, device="cpu")
                    if tatlas.count and tatlas.has_n else None))
    jparams = JParams(camera=JCamera.make(**CAM),
                      area_light=JAreaLight.make(**LIGHT),
                      env_map_strength=jnp.float32(1.0),
                      world_radius=jnp.float32(wr),
                      pp=JPP(jnp.float32(1.0), jnp.int32(2)))
    tparams = TParams(camera=TCamera.make(**CAM, device="cpu"),
                      area_light=TAreaLight.make(**LIGHT, device="cpu"),
                      world_radius=torch.tensor(wr, dtype=torch.float32),
                      pp=TPP(torch.tensor(1.0), 2))
    jcfg = JConfig(width=w, height=h, max_bounces=depth, use_env_map=False,
                   use_area_light=True, material_types=types, backend="mxu",
                   block_ring=True, groups=groups, unroll_bounces=True)
    tcfg = TConfig(width=w, height=h, max_bounces=depth, material_types=types,
                   groups=groups)
    return (jscene, jparams, jcfg), (tscene, tparams, tcfg), wr


def check_wavefront(setup, paths, segments, cap=0, resync=False,
                    **switches):
    """``segments`` wavefront segments from one wf_reset with the config
    ``switches`` on both sides (and with ``cap`` > 0 the exact spp cap at
    that many samples, K7 and K8's path): integer state (pixel_index,
    seed, path_len, shadow_pending, ring cursors, spp) and the four
    counters bit-equal each segment, film weight exact, rgb rtol 1e-5
    (atol 1e-6). With ``resync`` each segment starts the port from the
    reference's state, so that a path which the two packages' last-bit
    differences send elsewhere (the reference's XLA contracts a * b + c
    into FMA in its trace and resolve kernels: a hit point moves by an
    ulp, and a grazing continuation ray then hits or misses the surface
    it leaves) is held one segment at a time instead of diverging for
    the rest of the run. Returns the port's last state (as numpy)."""
    (js, jp, jc), (ts, tp, tc), wr = setup
    jc, tc = jc.replace(**switches), tc.replace(**switches)
    if cap:
        jc, tc = jc.replace(max_spp=1), tc.replace(max_spp=1)
        jp = jp._replace(max_spp=jnp.int32(cap))
        tp = tp._replace(max_spp=torch.tensor(cap, dtype=torch.int32))
    jst = jwf.wf_reset(jc, paths, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
    for seg in range(segments):
        if resync:
            tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst),
                                          device="cpu")
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        jst, jcnt = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _jax_state_to_numpy(jst)
        for k in ("pixel_index", "seed", "path_len", "shadow_pending"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                          err_msg=f"{k}, segment {seg}")
        np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
        np.testing.assert_array_equal(a["spp"], b["spp"])
        if resync:
            np.testing.assert_array_equal(a["film"]["weight"],
                                          b["film"]["weight"])
            np.testing.assert_allclose(np.stack(a["film"]["color"]),
                                       np.stack(b["film"]["color"]),
                                       rtol=1e-5, atol=1e-6)
    assert int(jcnt.splatted) > 0
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)
    return a


def check_megastep(setup, **switches):
    """One render_sample from seeds = pixel ids with the config
    ``switches``, the film holding an earlier sample: seeds and
    RenderStats bit-equal, film weight exact, rgb rtol 1e-5 (atol
    1e-6). Returns the port's RenderStats."""
    (js, jp, jc), (ts, tp, tc), _ = setup
    jc, tc = jc.replace(**switches), tc.replace(**switches)
    npx = tc.num_pixels
    color = np.random.default_rng(19).random((3, npx)).astype(np.float32)
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
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    np.testing.assert_allclose(np.stack([c.numpy() for c in tf.color]),
                               np.stack([np.asarray(c) for c in jf.color]),
                               rtol=1e-5, atol=1e-6)
    return tst


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def _write_pngs(d, seed):
    """Seeded PNGs of four modes and sizes; returns their names."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    specs = [("rgba.png", (5, 7, 4), "RGBA"), ("rgb.png", (16, 9, 3), "RGB"),
             ("grey.png", (8, 8), "L"), ("one.png", (1, 1, 3), "RGB")]
    for name, shape, mode in specs:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        Image.fromarray(img, mode).save(os.path.join(d, name))
    return [s[0] for s in specs]


def test_host_texture_and_pack_atlas(tmp_path):
    """HostTexture rows (flipped, RGBA) and the packed atlas: texel words,
    padded descriptors, their host tuples and count bit-equal; the usage
    flags follow the materials as the reference's."""
    names = _write_pngs(str(tmp_path), seed=1)
    ours = [HostTexture(str(tmp_path / n), n) for n in names]
    ref = [JHostTexture(str(tmp_path / n), n) for n in names]
    for a, b in zip(ours, ref):
        _eq(a.data, b.data)
        assert (a.width, a.height, a.name) == (b.width, b.height, b.name)
        assert a.data.flags["C_CONTIGUOUS"]
    ta, ja = pack_atlas(ours, device="cpu"), jpack_atlas(ref)
    _eq(ta.texels.numpy(), np.asarray(ja.texels))
    for k in ("offset", "width", "height"):
        _eq(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)))
    for k in ("count", "offset_t", "width_t", "height_t"):
        assert getattr(ta, k) == getattr(ja, k), k
    assert ta.offset.shape[0] == 128 and ta.count == 4
    empty, jempty = pack_atlas([], device="cpu"), jpack_atlas([])
    _eq(empty.texels.numpy(), np.asarray(jempty.texels))
    assert empty.count == 0 and empty.width_t == jempty.width_t

    from fluctus_tpu_torch.scene import HostMaterial
    mats = [HostMaterial(map_Kd=1), HostMaterial(map_N=0)]
    u, ju = ta.with_material_usage(mats), ja.with_material_usage(mats)
    assert (u.has_kd, u.has_ks, u.has_n) == (ju.has_kd, ju.has_ks,
                                             ju.has_n) == (True, False, True)


def _fetch_inputs(n, seed):
    """An atlas of three textures whose every texel has its own (r, g)
    bytes, and per-lane texture ids (-1 included) and uv: seeded values
    from -3 to 4, whole numbers and k / w."""
    rng = np.random.default_rng(seed)
    textures, gid = [], 0
    for h, w in ((7, 5), (16, 16), (1, 1)):
        idx = gid + np.arange(h * w)
        data = np.stack([idx & 0xFF, (idx >> 8) & 0xFF,
                         rng.integers(0, 256, h * w),
                         rng.integers(0, 256, h * w)], -1)
        gid += h * w
        tex = HostTexture.__new__(HostTexture)
        tex.data = data.reshape(h, w, 4).astype(np.uint8)
        tex.height, tex.width, tex.name = h, w, f"t{gid}"
        textures.append(tex)
    u = (rng.random(n) * 7.0 - 3.0).astype(np.float32)
    v = (rng.random(n) * 7.0 - 3.0).astype(np.float32)
    q = n // 4
    u[:q] = rng.integers(-3, 5, q)                    # whole numbers
    v[q:2 * q] = rng.integers(-20, 21, q) / 5.0       # multiples of 1/5
    u[2 * q:3 * q] = rng.integers(-40, 41, q) / 16.0  # k / 16
    tex_idx = rng.integers(-1, 3, n).astype(np.int32)
    return textures, u, v, tex_idx


def test_fetch_matches_reference():
    """_fetch_texel, fetch_texture and mat_get_float3 (descriptors
    gathered, and baked per lane) bit-equal; every texel has its own
    (r, g) bytes, so the texel ids are equal too; mat_get_albedo within
    rtol 1e-6 (XLA's and torch's pow round differently)."""
    n = 8192
    textures, u, v, tex_idx = _fetch_inputs(n, seed=2)
    ta = pack_atlas(textures, device="cpu")
    ja = jpack_atlas(textures)
    tu, tv_, ti = (torch.from_numpy(a) for a in (u, v, tex_idx))
    ju, jv_, ji = (jnp.asarray(a) for a in (u, v, tex_idx))
    got = ttf.fetch_texture(ta, ti, tu, tv_)
    ref = jtf.fetch_texture(ja, ji, ju, jv_)
    _eq(_np3(got), _np3(ref))
    rg = np.rint(_np3(got)[:, :2] * 255.0).astype(np.int64)
    ids = rg[:, 0] + (rg[:, 1] << 8)
    lanes = tex_idx == 1
    assert len(np.unique(ids[lanes])) > 200     # most of texture 1's texels

    safe = np.maximum(tex_idx, 0)
    meta = [np.asarray(a)[safe] for a in (ja.offset, ja.width, ja.height)]
    fb = np.random.default_rng(3).random((n, 3)).astype(np.float32)
    for m in (None, meta):
        tm = None if m is None else tuple(torch.from_numpy(a) for a in m)
        jm = None if m is None else tuple(jnp.asarray(a) for a in m)
        _eq(_np3(ttf.mat_get_float3(_tv(fb), tu, tv_, ti, ta, meta=tm)),
            _np3(jtf.mat_get_float3(_jv(fb), ju, jv_, ji, ja, meta=jm)))
        np.testing.assert_allclose(
            _np3(ttf.mat_get_albedo(_tv(fb), tu, tv_, ti, ta, meta=tm)),
            _np3(jtf.mat_get_albedo(_jv(fb), ju, jv_, ji, ja, meta=jm)),
            rtol=1e-6, atol=0)
    # an empty atlas gives the fallback
    empty = pack_atlas([], device="cpu")
    _eq(_np3(ttf.mat_get_float3(_tv(fb), tu, tv_, ti, empty)), fb)


@pytest.fixture(scope="module")
def prod_tables(prod_dir):
    """Both packages' scenes and MXU tables of the production luxball."""
    js, ts = JScene(), TScene()
    path = os.path.join(prod_dir, "production.sc.json")
    js.load_model(path)
    ts.load_model(path)
    p, n, uv, mid = js.triangle_arrays()
    bvh = jbuild_bvh(p)
    kw = dict(normals=n, uvs=uv, mat_ids=mid)
    jatlas = js.device_textures()
    ref = jmt.MXUScene.build(p, bvh, materials=js.materials, atlas=jatlas,
                             return_host=True, **kw)
    tatlas = ts.device_textures(device="cpu")
    ours = tmt.MXUScene.build(p, bvh, materials=ts.materials, atlas=tatlas,
                              **kw)
    return dict(js=js, ts=ts, p=p, bvh=bvh, kw=kw, ref=ref, ours=ours,
                jatlas=jatlas, tatlas=tatlas)


def test_build_bakes_descriptors(prod_tables, tmp_path):
    """MXUScene.build with the production luxball's atlas: every host
    array (attrs and B16 with the descriptor columns) bit-equal to the
    reference's, has_tex_meta set; the descriptors sit on the textured
    triangles. The port's table cache is read by the reference's
    build_cached and by the port's load_table_cache unchanged. Sizes past
    the descriptors' packing raise."""
    t = prod_tables
    (host, st), (jhost, jst) = t["ours"], t["ref"]
    assert st == jst and st["has_tex_meta"]
    for k, a in jhost.items():
        if a is None:
            assert host[k] is None, k
        else:
            b = np.asarray(a)
            _eq(host[k], b.view(np.uint16) if k in ("attr_b16", "b16t")
                else b)
    a = host["attrs"]
    cols = a[:, tmt.ATTR_TKD_WH:tmt.ATTR_TN_OFF + 1]
    used = np.abs(a[:, tmt.ATTR_N:tmt.ATTR_N + 3]).sum(1) > 0
    textured = used & (a[:, [tmt.ATTR_MAP_KD, tmt.ATTR_MAP_KS,
                             tmt.ATTR_MAP_N]] >= 0).any(1)
    assert (cols[textured] != 0).any(1).all() and textured.sum() > 1000

    path = str(tmp_path / "tables.npz")
    tmt.MXUScene.build_cached(path, t["p"], t["bvh"],
                              materials=t["ts"].materials,
                              atlas=t["tatlas"], **t["kw"])
    back, bst = tmt.load_table_cache(path)
    assert bst == st
    jsc = jmt.MXUScene.build_cached(path, None, None)
    assert jsc.has_tex_meta
    _eq(np.asarray(jsc.attrs), host["attrs"])
    _eq(np.asarray(jsc.b16t).view(np.uint16), host["b16t"])
    assert tmt.tables_from_numpy(back, bst, "cpu").has_tex_meta

    big = t["tatlas"]._replace(width_t=(4096,) + t["tatlas"].width_t[1:])
    with pytest.raises(ValueError, match="4096"):
        tmt.MXUScene.build(t["p"], t["bvh"], materials=t["ts"].materials,
                           atlas=big, **t["kw"])


def test_table_cache_follows_texture_sizes(tmp_path):
    """The table cache's key has no texture sizes, so the file records the
    descriptors it baked: Renderer.load_scene misses, then hits; with the
    albedo map replaced by one of another size under the same name it
    misses again and rebuilds, and the rebuilt tables bake the new size
    (equal to a fresh build's); the next load hits."""
    from PIL import Image
    scene_dir = tmp_path / "scene"
    path = write_production_scene(str(scene_dir), MAP_SIZES, seed=3)
    r = Renderer(16, 8, data_dir=str(tmp_path / "data"), device="cpu")
    r.load_scene(path)
    assert r.cache_hit == dict(bvh=False, tables=False)
    r.load_scene(path)
    assert r.cache_hit == dict(bvh=True, tables=True)
    before = r.device_scene.mxu.attrs.clone()
    Image.fromarray(np.full((24, 40, 3), 128, np.uint8), "RGB").save(
        scene_dir / "albedo.png")
    r.load_scene(path)
    assert r.cache_hit == dict(bvh=True, tables=False)
    atlas = r.device_scene.atlas
    assert [t.name for t in r.scene.textures][1] == "albedo.png"
    assert (atlas.width_t[1], atlas.height_t[1]) == (40, 24)
    p, n, uv, mid = r.scene.triangle_arrays()
    fresh, _ = tmt.MXUScene.build(p, build_bvh(p), normals=n, uvs=uv,
                                  mat_ids=mid, materials=r.scene.materials,
                                  atlas=atlas)
    cached, _ = tmt.load_table_cache(
        table_cache_path(str(tmp_path / "data"), r.scene, "sah", False))
    _eq(cached["attrs"], fresh["attrs"])
    assert not torch.equal(r.device_scene.mxu.attrs, before)
    r.load_scene(path)
    assert r.cache_hit == dict(bvh=True, tables=True)


def _camera_rays(tsc, n, seed):
    """(o4, d4, tmax) numpy arrays of jittered camera rays of CAM."""
    rng = np.random.default_rng(seed)
    px, py = rng.random(n), rng.random(n)
    o = np.tile(np.array(CAM["pos"], np.float32), (n, 1))
    d = np.stack([px * 2 - 1, (py * 2 - 1) * 0.6 - 0.12, -np.ones(n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    center = tsc.center.numpy()
    o4 = np.concatenate([o - center, np.ones((n, 1), np.float32)], 1)
    d4 = np.concatenate([d, np.zeros((n, 1), np.float32)], 1)
    tm = tmt._exit_clamp(torch.from_numpy(o4), torch.from_numpy(d4),
                         torch.full((n, 1), float(np.finfo(np.float32).max)),
                         tsc.lo, tsc.hi)
    return o4, d4, tm


def test_resolve_rows_textured(prod_tables):
    """K3's and K10's plain versions on the winners of the production
    tables: rows 22-25 (map indices, triangle) and 29-34 (descriptors)
    equal to the reference's interpret-mode v5 and v1 kernels after
    rounding, u, v within 2^-12 and t within 2^-12 relative (the
    reference's XLA contracts a * b + c into FMA; test_torch_kernels.py),
    and the descriptor rows non-zero on the textured lanes."""
    t = prod_tables
    host, st = t["ref"]
    jsc = jmt.MXUScene._from_host(host, st)
    tsc = tmt.tables_from_numpy(host, st, "cpu")
    o4, d4, tm = _camera_rays(tsc, 2048, seed=4)
    static = (tsc.n_clusters, tsc.cluster_size)
    tt, col = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4), tm,
                             tsc.t12, tsc.cluster_box, static, False, RT)
    c = col[:, 0].contiguous()
    to4, td4 = torch.from_numpy(o4), torch.from_numpy(d4)
    j = lambda a: jnp.asarray(np.asarray(a))
    runs = [(tmt.resolve_v5_plain(c, to4, td4, tsc.b16r, tsc.t16r),
             jmt._resolve_v5(j(col), j(o4), j(d4), jsc.b16t, jsc.t12b,
                             static, RT, True)),
            (tmt.resolve_v1_plain(c, to4, td4, tsc.txy_t, tsc.attrs,
                                  tsc.cluster_size),
             jmt._resolve(j(col), j(tt), j(o4), j(d4), jsc.txy_t, jsc.attrs,
                          static, RT, True).T)]
    exact = list(range(tmt.ATTR_MAP_KD, tmt.ATTR_TRI + 1)) \
        + list(range(tmt.ATTR_TKD_WH, tmt.ATTR_TN_OFF + 1))
    for got, ref in runs:
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(np.rint(got[exact]),
                                      np.rint(ref[exact]))
        np.testing.assert_allclose(got[tmt.ATTR_HITU:tmt.ATTR_HITV + 1],
                                   ref[tmt.ATTR_HITU:tmt.ATTR_HITV + 1],
                                   rtol=0, atol=2.0 ** -12)
        jt = ref[tmt.ATTR_HITT]
        np.testing.assert_array_less(np.abs(got[tmt.ATTR_HITT] - jt),
                                     np.abs(jt) * 2.0 ** -12 + 1e-30)
        textured = (c.numpy() >= 0) & (
            got[tmt.ATTR_MAP_KD:tmt.ATTR_MAP_N + 1] > -0.5).any(0)
        assert textured.mean() > 0.1
        desc = got[tmt.ATTR_TKD_WH:tmt.ATTR_TN_OFF + 1]
        assert (desc[:, textured] != 0).any(0).all()


def test_tangent_space_normal(prod_tables):
    """Seeded hits on the production tables' triangles (the ground with
    the normal map, others without, misses, degenerate uv frames): the
    port's normal mapping against the reference's, with the map's
    descriptors gathered and baked: rtol 1e-5 (atol 1e-6: two
    normalizations, whose rsqrt rounds differently in XLA and torch)."""
    t = prod_tables
    js, p = t["js"], t["p"]
    _, n, uv, mid = js.triangle_arrays()
    uv = uv.copy()
    uv[:40] = 0.25                                   # degenerate frames
    rng = np.random.default_rng(5)
    m = 4096
    tri = rng.integers(-1, len(p), m).astype(np.int32)
    ground = np.flatnonzero(mid == 3)
    tri[: m // 2] = ground[rng.integers(0, len(ground), m // 2)]
    tri[m // 2:m // 2 + 64] = rng.integers(0, 40, 64)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uu, vv = (rng.random(m) * 6 - 3).astype(np.float32), \
        (rng.random(m) * 6 - 3).astype(np.float32)
    mapn = np.array([mat.map_N for mat in js.materials], np.int32)[
        mid[np.maximum(tri, 0)]]
    mapn[tri < 0] = -1
    assert (mapn >= 0).mean() > 0.4
    jatlas, tatlas = t["jatlas"], port_atlas(t["jatlas"])
    tris = TrianglesDevice.from_arrays(p, n, uv, mid)
    frames = ttrace.make_tri_frames(p, uv, device="cpu")
    z = np.zeros(m, np.float32)
    zi = np.zeros(m, np.int32)
    jhit = JHit(P=_jv(nrm), N=_jv(nrm), uv_u=jnp.asarray(uu),
                uv_v=jnp.asarray(vv), t=jnp.asarray(z), i=jnp.asarray(tri),
                area_light_hit=jnp.asarray(zi), mat_id=jnp.asarray(zi))
    thit = THit(P=_tv(nrm), N=_tv(nrm), uv_u=torch.from_numpy(uu),
                uv_v=torch.from_numpy(vv), t=torch.from_numpy(z),
                i=torch.from_numpy(tri), area_light_hit=torch.from_numpy(zi),
                mat_id=torch.from_numpy(zi))
    safe = np.maximum(mapn, 0)
    meta = [np.asarray(a)[safe] for a in (jatlas.offset, jatlas.width,
                                          jatlas.height)]
    for mm in (None, meta):
        got = ttrace.tangent_space_normal(
            thit, frames, torch.from_numpy(mapn), tatlas,
            meta=None if mm is None else tuple(map(torch.from_numpy, mm)))
        ref = jtrace.tangent_space_normal(
            jhit, tris, jnp.asarray(mapn), jatlas,
            meta=None if mm is None else tuple(map(jnp.asarray, mm)))
        np.testing.assert_allclose(_np3(got), _np3(ref), rtol=1e-5,
                                   atol=1e-6)
        moved = np.abs(_np3(got) - nrm).max(1) > 1e-3
        assert moved[mapn >= 0].mean() > 0.5 and not moved[mapn < 0].any()
    plain = pack_atlas([], device="cpu")
    assert ttrace.tangent_space_normal(thit, None, torch.from_numpy(mapn),
                                       plain) is thit.N


def test_textured_obj_loads_equal(prod_dir, tmp_path, capsys):
    """The production OBJ + MTL in both packages: materials (map indices
    included: map_bump is the normal map), textures and the atlas equal;
    a texture named twice is loaded once; a missing file gives -1 and a
    file that is not an image -1 with the reference's message."""
    path = os.path.join(prod_dir, "production.obj")
    js, ts = JScene(), TScene()
    js.load_model(path)
    ts.load_model(path)
    assert [m.__dict__ for m in ts.materials] == \
        [m.__dict__ for m in js.materials]
    names = {m.name: (m.map_Kd, m.map_Ks, m.map_N) for m in ts.materials}
    assert names["ground"] == (1, -1, 2) and names["core"] == (-1, 0, -1)
    assert [t.name for t in ts.textures] == ["specular.png", "albedo.png",
                                              "normal.png"]
    for a, b in zip(ts.textures, js.textures):
        _eq(a.data, b.data)
    ta, ja = ts.device_textures(device="cpu"), js.device_textures()
    _eq(ta.texels.numpy(), np.asarray(ja.texels))
    assert (ta.offset_t, ta.has_kd, ta.has_ks, ta.has_n) == \
        (ja.offset_t, ja.has_kd, ja.has_ks, ja.has_n)

    assert ts.try_import_texture(prod_dir, "albedo.png") == 1
    assert len(ts.textures) == 3
    assert ts.try_import_texture(prod_dir, "absent.png") == -1
    (tmp_path / "bad.png").write_bytes(b"not an image")
    capsys.readouterr()
    assert ts.try_import_texture(str(tmp_path), "bad.png") == -1
    ours = capsys.readouterr().out
    assert js.try_import_texture(str(tmp_path), "bad.png") == -1
    assert ours.startswith("texture load failed for") and \
        capsys.readouterr().out.startswith("texture load failed for")


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------

GGX_SCENE_TYPES = (bx.BXDF_DIFFUSE | bx.BXDF_GLOSSY
                   | bx.BXDF_GGX_ROUGH_REFLECTION
                   | bx.BXDF_GGX_ROUGH_DIELECTRIC | bx.BXDF_IDEAL_DIELECTRIC)


def test_textured_wavefront_matches_reference(prod_dir, reference_kernels):
    """4 segments of the production luxball (textured, normal-mapped,
    every GGX lobe) at 32x16 with 512 paths, depth 10 (see
    check_wavefront). One pool of 512 paths and the megastep's 512
    pixels: the reference compiles its operations for one shape."""
    setup = scene_setup(os.path.join(prod_dir, "production.sc.json"), 32,
                        16, 10)
    tscene, _, tcfg = setup[1]
    assert tscene.mxu.has_tex_meta and tscene.tri_frames is not None
    assert tcfg.material_types == GGX_SCENE_TYPES
    check_wavefront(setup, 512, 4)


def test_textured_megastep_matches_reference(prod_dir, reference_route):
    """One megastep sample of the production luxball at 32x16, depth 5
    (see check_megastep)."""
    setup = scene_setup(os.path.join(prod_dir, "production.sc.json"), 32,
                        16, 5)
    assert setup[1][2].material_types == GGX_SCENE_TYPES
    st = check_megastep(setup)
    assert st.shadow_rays > 0 and st.extension_rays > 0
