"""The port's scene hash, hierarchy cache and table cache against the JAX
package's: the same hashes, the same bytes in a hierarchy file, a table
cache either package writes and the other reads, the reference's cache
file name, and the renderer's load through the caches (a hit builds
nothing; a table cache without B16 renders through K10). Every file goes
under pytest's ``tmp_path``; nothing is read from or written to the
repository's ``data/``."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.accel.bvh import export_bvh as jexport_bvh
from fluctus_tpu.accel.bvh import import_bvh as jimport_bvh
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.scene import file_hash as jfile_hash

from fluctus_tpu_torch import kernel_build as kb
from fluctus_tpu_torch import renderer as trenderer
from fluctus_tpu_torch.accel import build_bvh as tbuild_bvh
from fluctus_tpu_torch.accel import export_bvh, import_bvh
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.renderer import Renderer, table_cache_path
from fluctus_tpu_torch.scene import Scene as TScene
from fluctus_tpu_torch.scene.scene import file_hash
from fluctus_tpu_torch.settings import Settings

HERE = os.path.dirname(__file__)
LUXBALL = os.path.join(HERE, "..", "data", "luxball", "luxball.obj")
GRID = os.path.join(HERE, "..", "fluctus_tpu_torch", "scenes",
                    "luxball_grid_2x2.sc.json")
LUXBALL_HASH = "17871883730237587163"


@pytest.fixture(scope="module")
def lux():
    js, ts = JScene(), TScene()
    js.load_model(LUXBALL)
    ts.load_model(LUXBALL)
    p, n, uv, mid = ts.triangle_arrays()
    bvh = tbuild_bvh(p)
    kw = dict(normals=n, uvs=uv, mat_ids=mid)
    host, st = tmt.MXUScene.build(p, bvh, materials=ts.materials, **kw)
    return dict(js=js, ts=ts, p=p, bvh=bvh, kw=kw, host=host, st=st)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_host_equal(a, b):
    """Two host table dicts (either package's): the same keys present, each
    array bit-equal (bf16 as uint16 bits)."""
    for k in tmt._HOST_KEYS:
        if a.get(k) is None or b.get(k) is None:
            assert a.get(k) is None and b.get(k) is None, k
            continue
        x, y = _bits(a[k]), _bits(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("path", [LUXBALL, GRID])
def test_scene_hash_matches_reference(path):
    """file_hash and Scene.hash equal the JAX package's: an OBJ's hash is
    its file hash; the .sc.json's chains the hashes of the files it
    references."""
    js, ts = JScene(), TScene()
    js.load_model(path)
    ts.load_model(path)
    assert file_hash(path) == jfile_hash(path)
    assert ts.hash == js.hash and ts.hash.isdigit()
    if path == LUXBALL:
        assert ts.hash == LUXBALL_HASH == file_hash(path)
    else:
        assert ts.hash != file_hash(path)


def test_bvh_cache_bytes_match_reference(lux, tmp_path):
    """export_bvh writes the JAX export_bvh's bytes for luxball's BVH (the
    index count in the node-count slot included); import_bvh gives the
    arrays back, as does the reference's import of the port's file."""
    ours, ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    export_bvh(lux["bvh"], str(ours))
    jexport_bvh(lux["bvh"], str(ref))
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_bytes()[:4] == ours.read_bytes()[
        4 + 4 * len(lux["bvh"].indices):8 + 4 * len(lux["bvh"].indices)]
    for back in (import_bvh(str(ours)), jimport_bvh(str(ours))):
        for name, a, b in zip(lux["bvh"]._fields, lux["bvh"], back):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_bvh_depth_matches_reference(lux):
    """BVHArrays.depth (pointer jumping) equals the JAX package's node loop
    on luxball's BVH and on a 3000-triangle random soup's."""
    from fluctus_tpu.accel.bvh import BVHArrays as JBVHArrays
    soup = np.random.default_rng(7).random((3000, 3, 3)).astype(np.float32)
    for bvh in (lux["bvh"], tbuild_bvh(soup)):
        assert bvh.depth() == JBVHArrays(*bvh).depth() > 0


def test_build_cached_miss_then_hit(lux, tmp_path, monkeypatch):
    """A miss builds and writes the npz; a hit builds nothing (build is
    patched to raise) and gives the same host tables; the upload of either
    is bit-equal."""
    path = str(tmp_path / "mxu_tables" / "t.npz")
    host, st = tmt.MXUScene.build_cached(path, lux["p"], lux["bvh"],
                                         materials=lux["ts"].materials,
                                         **lux["kw"])
    assert os.path.exists(path) and os.listdir(tmp_path / "mxu_tables") \
        == ["t.npz"]
    _assert_host_equal(host, lux["host"])

    def no_build(*a, **k):
        raise AssertionError("a cache hit must not build")
    monkeypatch.setattr(tmt.MXUScene, "build", no_build)
    hit, st2 = tmt.MXUScene.build_cached(path, lux["p"], lux["bvh"],
                                         materials=lux["ts"].materials,
                                         **lux["kw"])
    assert st2 == st
    _assert_host_equal(hit, lux["host"])
    a = tmt.tables_from_numpy(host, st, "cpu")
    b = tmt.tables_from_numpy(hit, st2, "cpu")
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.view(torch.int16) if x.dtype ==
                               torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype ==
                               torch.bfloat16 else y), name
        else:
            assert x == y, name


def test_table_cache_shared_with_reference(lux, tmp_path, monkeypatch):
    """A cache the JAX package's build_cached writes loads in the port to
    tables equal to the port's build; a cache the port writes loads in the
    JAX package (its build patched to raise) to its own build's tables."""
    js = lux["js"]
    jpath = str(tmp_path / "jax.npz")
    jmt.MXUScene.build_cached(jpath, lux["p"], jbuild_bvh(lux["p"]),
                              materials=js.materials, **lux["kw"])
    host, st = tmt.load_table_cache(jpath)
    assert st == lux["st"]
    _assert_host_equal(host, lux["host"])

    tpath = str(tmp_path / "port.npz")
    tmt.write_table_cache(tpath, lux["host"], lux["st"])
    jhost, _ = jmt.MXUScene.build(lux["p"], jbuild_bvh(lux["p"]),
                                  materials=js.materials, return_host=True,
                                  **lux["kw"])

    def no_build(*a, **k):
        raise AssertionError("a cache hit must not build")
    monkeypatch.setattr(jmt.MXUScene, "build", no_build)
    jsc = jmt.MXUScene.build_cached(tpath, lux["p"], None)
    _assert_host_equal({k: getattr(jsc, k) for k in tmt._HOST_KEYS}, jhost)


def test_cache_file_names_follow_the_reference(lux, tmp_path):
    """The renderer writes hierarchies/hierarchy_<hash>.bin and the table
    cache under the reference's recipe (renderer.py:118-131), computed here
    over the JAX Scene's materials; a second load hits both and builds
    nothing."""
    import hashlib
    js = lux["js"]
    mh = hashlib.blake2b(repr([m.__dict__ for m in js.materials]).encode(),
                         digest_size=6).hexdigest()
    name = (f"mxu_{js.hash}_{mh}_sah_c256s{jmt.SC_CLUSTERS}"
            f"_v{jmt.TABLE_VERSION}.npz")
    assert tmt.TABLE_VERSION == jmt.TABLE_VERSION
    assert table_cache_path(str(tmp_path), lux["ts"], "sah", False) == \
        os.path.join(str(tmp_path), "mxu_tables", name)
    r = Renderer(16, 8, data_dir=str(tmp_path), device="cpu")
    r.load_scene(LUXBALL)
    assert r.cache_hit == dict(bvh=False, tables=False)
    assert sorted(os.listdir(tmp_path / "mxu_tables")) == [name]
    assert sorted(os.listdir(tmp_path / "hierarchies")) == [
        f"hierarchy_{LUXBALL_HASH}.bin"]
    assert set(r.load_seconds) == {"load", "bvh", "tables", "upload"}
    r.load_scene(LUXBALL)
    assert r.cache_hit == dict(bvh=True, tables=True)


def test_hierarchy_cache_rules(lux, tmp_path, monkeypatch):
    """_init_hierarchy: a hit imports and builds nothing; a scene without a
    hash builds and writes nothing (as the reference); the SBVH split mode
    keys its own file: a miss builds the SBVH natively and writes
    ``hierarchy_<hash>_sbvh.bin``, which the SAH tree's file is not."""
    r = Renderer(16, 8, data_dir=str(tmp_path), device="cpu")
    scene = lux["ts"]
    bvh, hit = r._init_hierarchy(scene)
    assert not hit
    monkeypatch.setattr(trenderer, "build_bvh", lambda p: 1 / 0)
    again, hit = r._init_hierarchy(scene)
    assert hit
    for a, b in zip(bvh, again):
        np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    nohash = TScene()
    nohash.load_model(LUXBALL)
    nohash.hash = ""
    r2 = Renderer(16, 8, data_dir=str(tmp_path / "fresh"), device="cpu")
    _, hit = r2._init_hierarchy(nohash)
    assert not hit and not os.path.exists(tmp_path / "fresh")
    s = Settings()
    s.split_mode = "sbvh"
    sbvh, hit = Renderer(16, 8, settings=s, data_dir=str(tmp_path),
                         device="cpu")._init_hierarchy(scene)
    assert not hit
    assert os.path.exists(tmp_path / "hierarchies"
                          / f"hierarchy_{scene.hash}_sbvh.bin")
    assert len(sbvh.indices) >= scene.num_triangles


def test_no_b16_cache_loads_and_resolves_through_k10(tmp_path):
    """A table cache whose b16t and attr_b16 are 0-d (absent) loads
    through Renderer.load_scene to tables without B16, and a wavefront
    segment then resolves through K10's plain version, not K3's."""
    r = Renderer(64, 36, data_dir=str(tmp_path), device="cpu")
    r.load_scene(LUXBALL)
    full = r.device_scene.mxu
    path = table_cache_path(str(tmp_path), r.scene, "sah", False)
    host, st = tmt.load_table_cache(path)
    tmt.write_table_cache(path, dict(host, b16t=None, attr_b16=None), st)
    with np.load(path) as z:
        assert z["b16t"].ndim == 0 and z["attr_b16"].ndim == 0
    r.load_scene(LUXBALL)
    sc = r.device_scene.mxu
    assert r.cache_hit == dict(bvh=True, tables=True)
    assert sc.b16r is None and sc.t16r is None and sc.attrs is not None
    assert torch.equal(sc.attrs, full.attrs)
    r.init_wavefront(2048)
    kb.reset_counts()
    r.render_wavefront(1)
    assert (tmt.K10.plain_runs, tmt.K3.plain_runs, tmt.K6.plain_runs) == \
        (1, 0, 0)
