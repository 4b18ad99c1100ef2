"""The trace's third branch against the JAX package's, on the CPU: tables
that can resolve nothing (slim tables, past 65,536 triangles, stored
without B16 by a table cache) trace with ``closest_hit_mxu_full`` and
build their hits with ``reconstruct_hit`` over the triangle arrays, and
the logic resolves their materials with ``resolve_material``.

  TrianglesDevice      from_arrays: every field bit-equal (exact)
  reconstruct_hit      seeded (t, triangle, u, v) with misses: triangle,
                       material ids exact; P, N, uv within rtol 1e-6
                       (atol 1e-6): the reference's XLA contracts
                       a * b + c into FMA
  resolve_material     seeded material ids (with -1) and uvs on the
                       production luxball's textured materials: ids,
                       types, maps and constants exact, the textures'
                       Kd (pow 2.2) and Ks within rtol 1e-6
  trace_extension      camera and bounce rays on the production luxball's
                       slim tables without B16, with ``txy_t`` (t, u, v
                       recomputed from the winner's transform) and without
                       (the trace's packed t, u = v = 0): the closest
                       triangle on >= 99.9% of the rays; where it agrees
                       t within 2^-12 |t|, u, v, N and uv within 2^-12,
                       the material id exact; the ShadingParams None
  wavefront, megastep  4 segments and one megastep sample on those tables
                       (test_torch_texture.check_wavefront /
                       check_megastep's tolerances)
  Renderer             a table cache without attrs or B16 uploads the
                       triangle arrays and materials and renders without
                       a resolve kernel; the B16 and attrs routes upload
                       neither
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bsdf as jbsdf
from fluctus_tpu.accel.traverse import TrianglesDevice as JTriangles
from fluctus_tpu.core import trace as jtrace
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.material import materials_to_soa as jmaterials_to_soa
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import bsdf as tbsdf
from fluctus_tpu_torch import kernel_build as kb
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import trace as ttrace
from fluctus_tpu_torch.renderer import Renderer, table_cache_path
from fluctus_tpu_torch.scene.material import materials_to_soa
from fluctus_tpu_torch.vec import Vec3 as TVec3

from test_torch_mk import reference_route  # noqa: F401
from test_torch_texture import (check_megastep, check_wavefront, port_atlas,
                                prod_dir, scene_setup)  # noqa: F401
from test_torch_wavefront import reference_kernels  # noqa: F401

HERE = os.path.dirname(__file__)
LUXBALL = os.path.join(HERE, "..", "data", "luxball", "luxball.obj")
# what a slim table cache without B16 holds: no attrs, attr_b16, b16t or
# vertex tables; "coarse" also lacks txy_t (slim tables past 12 MiB)
BARE = ("attrs", "attr_b16", "b16t", "tx", "ty", "tz")
COARSE = BARE + ("txy_t",)


def _prod(prod_dir):
    return os.path.join(prod_dir, "production.sc.json")


@pytest.fixture
def reference_bare(reference_kernels, monkeypatch):
    """The reference's device route for its third branch: its closest hit
    and any-hit sorted through the interpret-mode rays-on-lanes kernel."""
    monkeypatch.setattr(jtrace, "_interpret_pallas", lambda: False)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _arrays(prod_dir):
    s = JScene()
    s.load_model(_prod(prod_dir))
    return s, s.triangle_arrays()


def test_triangles_device_matches_reference(prod_dir):
    _, (p, n, uv, mid) = _arrays(prod_dir)
    ours = ttrace.TrianglesDevice.from_arrays(p, n, uv, mid, device="cpu")
    ref = JTriangles.from_arrays(p, n, uv, mid)
    for name, a, b in zip(ours._fields, ours, ref):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            x, y = _np(x), _np(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_reconstruct_hit_matches_reference(prod_dir):
    _, (p, n, uv, mid) = _arrays(prod_dir)
    ours = ttrace.TrianglesDevice.from_arrays(p, n, uv, mid, device="cpu")
    ref = JTriangles.from_arrays(p, n, uv, mid)
    rng = np.random.default_rng(31)
    k = 2048
    o = rng.normal(size=(k, 3)).astype(np.float32)
    d = rng.normal(size=(k, 3)).astype(np.float32)
    t = rng.uniform(0.1, 5.0, k).astype(np.float32)
    tri = rng.integers(-1, len(p), k).astype(np.int32)
    u = rng.random(k, np.float32) * 0.5
    v = rng.random(k, np.float32) * 0.5
    tv = lambda a: TVec3(*(torch.from_numpy(a[:, c].copy())
                           for c in range(3)))
    jv = lambda a: JVec3(*(jnp.asarray(a[:, c]) for c in range(3)))
    th = ttrace.reconstruct_hit(tv(o), tv(d), torch.from_numpy(t),
                                torch.from_numpy(tri), torch.from_numpy(u),
                                torch.from_numpy(v), ours)
    jh = jtrace.reconstruct_hit(jv(o), jv(d), jnp.asarray(t),
                                jnp.asarray(tri), jnp.asarray(u),
                                jnp.asarray(v), ref)
    for f in ("i", "mat_id", "area_light_hit", "t"):
        np.testing.assert_array_equal(_np(getattr(th, f)),
                                      _np(getattr(jh, f)), err_msg=f)
    for f in ("P", "N"):
        for a, b in zip(getattr(th, f), getattr(jh, f)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    for f in ("uv_u", "uv_v"):
        np.testing.assert_allclose(_np(getattr(th, f)), _np(getattr(jh, f)),
                                   rtol=1e-6, atol=1e-6)


def test_resolve_material_matches_reference(prod_dir):
    js, _ = _arrays(prod_dir)
    jatlas = js.device_textures()
    assert jatlas.count > 0
    rng = np.random.default_rng(37)
    k = 4096
    mid = rng.integers(-1, len(js.materials), k).astype(np.int32)
    u = rng.uniform(-1.5, 2.5, k).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, k).astype(np.float32)
    ours = tbsdf.resolve_material(
        materials_to_soa(js.materials, device="cpu"), torch.from_numpy(mid),
        torch.from_numpy(u), torch.from_numpy(v), port_atlas(jatlas))
    ref = jbsdf.resolve_material(jmaterials_to_soa(js.materials),
                                 jnp.asarray(mid), jnp.asarray(u),
                                 jnp.asarray(v), jatlas)
    for name, a, b in zip(ours._fields, ours, ref):
        if a is None:
            assert b is None, name
            continue
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if name in ("Kd", "Ks"):
                np.testing.assert_allclose(_np(x), _np(y), rtol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(_np(x), _np(y), err_msg=name)
    textured = np.array([m.map_Kd >= 0 for m in js.materials])[
        np.maximum(mid, 0)]
    assert textured.any() and not textured.all()


def _rays(kind, n, seed):
    """Camera rays through the production luxball's view, or bounce rays
    from points near its surfaces in random directions."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o = np.tile(np.float32([0.0, 1.6, 4.5]), (n, 1))
        d = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.5, 0.3, n),
                      -np.ones(n)], 1)
    else:
        o = rng.uniform([-1.5, 0.05, -1.5], [1.5, 1.5, 1.5], (n, 3))
        d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("strip", [BARE, COARSE], ids=["txy_t", "coarse"])
@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_third_branch_matches_reference(prod_dir, reference_route, strip,
                                        kind):
    (js, jp, _), (ts, tp, _), _ = scene_setup(_prod(prod_dir), 8, 8, 2,
                                              strip=strip)
    assert not ttrace.has_resolve_tables(ts) and ts.tris is not None
    assert (ts.mxu.txy_t is None) == (strip == COARSE)
    o, d = _rays(kind, 4096, 41)
    tv = lambda a: TVec3(*(torch.from_numpy(a[:, c].copy())
                           for c in range(3)))
    jv = lambda a: JVec3(*(jnp.asarray(a[:, c]) for c in range(3)))
    kb.reset_counts()
    th, tsp = ttrace.trace_extension(tv(o), tv(d), ts, tp.area_light, True,
                                     want_shading=True)
    assert all(k.plain_runs == 0 for k in kb.KERNELS.values()
               if k.name.startswith("resolve"))
    jh, jsp = jtrace.trace_extension(jv(o), jv(d), js, jp.area_light,
                                     jnp.asarray(True), want_shading=True)
    assert tsp is None and jsp is None
    i, ji = _np(th.i), _np(jh.i)
    same = i == ji
    assert (ji >= 0).mean() > 0.5 and same.mean() >= 0.999, same.mean()
    t, jt = _np(th.t)[same], _np(jh.t)[same]
    np.testing.assert_array_less(np.abs(t - jt), np.abs(jt) * 2.0 ** -12
                                 + 1e-30)
    for f in ("uv_u", "uv_v"):
        np.testing.assert_allclose(_np(getattr(th, f))[same],
                                   _np(getattr(jh, f))[same], rtol=0,
                                   atol=2.0 ** -12)
    for a, b in zip(th.N, jh.N):
        np.testing.assert_allclose(_np(a)[same], _np(b)[same], rtol=0,
                                   atol=2.0 ** -12)
    for f in ("mat_id", "area_light_hit"):
        np.testing.assert_array_equal(_np(getattr(th, f))[same],
                                      _np(getattr(jh, f))[same])


@pytest.mark.parametrize("strip", [BARE, COARSE], ids=["txy_t", "coarse"])
def test_third_branch_wavefront_matches_reference(prod_dir, reference_bare,
                                                  strip):
    """4 segments of the production luxball (textured, normal-mapped) on
    tables without resolve tables, 32x16 with 512 paths, depth 10."""
    setup = scene_setup(_prod(prod_dir), 32, 16, 10, strip=strip)
    assert setup[1][0].tris is not None
    check_wavefront(setup, 512, 4)


def test_third_branch_megastep_matches_reference(prod_dir, reference_route):
    """One megastep sample on the same tables, 32x16, depth 5."""
    st = check_megastep(scene_setup(_prod(prod_dir), 32, 16, 5, strip=BARE))
    assert st.shadow_rays > 0 and st.extension_rays > 0


def test_renderer_uploads_triangles_only_for_bare_tables(tmp_path):
    """Renderer.load_scene: the B16 route and the attrs route (a table
    cache without B16) upload no triangle arrays or materials; a table
    cache without attrs or B16 uploads both and renders two segments
    with no resolve kernel, a finite film and whole weights."""
    r = Renderer(64, 36, data_dir=str(tmp_path), device="cpu")
    r.load_scene(LUXBALL)
    assert r.device_scene.tris is None and r.device_scene.mats is None
    path = table_cache_path(str(tmp_path), r.scene, "sah", False)
    host, st = tmt.load_table_cache(path)
    tmt.write_table_cache(path, dict(host, b16t=None, attr_b16=None), st)
    r.load_scene(LUXBALL)
    assert r.device_scene.mxu.attrs is not None
    assert r.device_scene.tris is None and r.device_scene.mats is None
    tmt.write_table_cache(path, dict(host, b16t=None, attr_b16=None,
                                     attrs=None), st)
    r.load_scene(LUXBALL)
    ds = r.device_scene
    assert r.cache_hit == dict(bvh=True, tables=True)
    assert not ttrace.has_resolve_tables(ds)
    assert ds.tris is not None and ds.mats is not None
    r.init_wavefront(2048)
    kb.reset_counts()
    r.render_wavefront(2)
    assert (tmt.K3.plain_runs, tmt.K6.plain_runs, tmt.K10.plain_runs) == \
        (0, 0, 0)
    film = r.wavefront_film()
    assert torch.isfinite(torch.stack(list(film.color))).all()
    w = film.weight
    assert torch.equal(w, torch.round(w)) and float(w.sum()) > 0
