"""The port's SBVH against the JAX package's, on the CPU:

  build_sbvh           the numpy builder on a clustered triangle soup and
                       a slice of luxball: node for node, every array
                       bit-equal (exact)
  build_sbvh_native    against the reference's native builder, its source
                       compiled here with the same flags: node for node,
                       every array bit-equal (exact); against the port's
                       numpy builder as the reference's own test holds
                       them: node and index counts equal, SAH cost within
                       rtol 1e-6
  validity             every triangle covered, children inside their
                       parent's box (1e-4), parent links
  the hierarchy cache  export_bvh of either package read by the other's
                       import_bvh (exact)
  MXUScene.build       on an SBVH tree whose leaves hold duplicated
                       references: the cuts and every host table
                       bit-equal (exact); and on trees whose leaf slices
                       are permuted out of DFS order, SAH and SBVH, through
                       the explicit walk (exact, no superclusters)
  trace_extension      on SBVH tables against the reference's
                       interpret-mode kernels: the closest triangle on
                       >= 99.9% of the rays, t within 2^-12 |t| and the
                       normal within 2^-12 where it agrees (the reference's
                       XLA contracts a * b + c into FMA)
  a wavefront run      4 segments on SBVH tables against the reference's
                       (test_torch_texture.check_wavefront's tolerances)
  Renderer             split_mode "sbvh": a miss builds natively and
                       writes hierarchy_<hash>_sbvh.bin, then a hit
"""

import ctypes
import os
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.accel.bvh import BVHArrays as JBVHArrays
from fluctus_tpu.accel.bvh import export_bvh as jexport_bvh
from fluctus_tpu.accel.bvh import import_bvh as jimport_bvh
from fluctus_tpu.accel.sbvh import build_sbvh as jbuild_sbvh
from fluctus_tpu.core import trace as jtrace
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import bxdf_types as bx
from fluctus_tpu_torch.accel import build_bvh, export_bvh, import_bvh
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.accel.sbvh import build_sbvh
from fluctus_tpu_torch.core import trace as ttrace
from fluctus_tpu_torch.native import build_sbvh_native
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.scene import Scene as TScene
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3 as TVec3

from test_torch_cache import _assert_host_equal
from test_torch_mk import reference_route  # noqa: F401
from test_torch_ply import write_ply
from test_torch_texture import check_wavefront, scene_setup
from test_torch_wavefront import reference_kernels  # noqa: F401

HERE = os.path.dirname(__file__)
LUXBALL = os.path.join(HERE, "..", "data", "luxball", "luxball.obj")
REF_SRC = os.path.join(HERE, "..", "fluctus_tpu", "native", "bvh_builder.cpp")


def tri_soup(m, seed):
    """A clustered triangle soup (the reference's test_sbvh_native.py
    soup): cluster centres overlap, so spatial splits duplicate refs."""
    rng = np.random.default_rng(seed)
    k = max(m // 64, 1)
    centers = rng.uniform(-10, 10, (k, 3))
    c = centers[rng.integers(0, k, m)] + rng.normal(0, 0.8, (m, 3))
    v = rng.normal(0, 0.35, (m, 3, 3))
    return (c[:, None, :] + v).astype(np.float32)


def _luxball_positions(n=None):
    s = TScene()
    s.load_model(LUXBALL)
    return s.triangle_arrays()[0][:n]


def _eq_tree(a, b):
    """Two trees (either package's BVHArrays) node for node."""
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _validate(bvh, m):
    """Every triangle in some leaf; each child inside its parent's box
    (1e-4) and linked to it."""
    covered = np.zeros(m, bool)
    leafs = bvh.n_prims > 0
    for s, k in zip(bvh.right_or_start[leafs].astype(np.int64),
                    bvh.n_prims[leafs]):
        covered[bvh.indices[s:s + k]] = True
    assert covered.all()
    idx = np.nonzero(~leafs)[0]
    for ch in (idx + 1, bvh.right_or_start[idx].astype(np.int64)):
        assert (bvh.box_min[idx] <= bvh.box_min[ch] + 1e-4).all()
        assert (bvh.box_max[idx] >= bvh.box_max[ch] - 1e-4).all()
        assert (bvh.parent[ch] == idx).all()


def _sah_cost(bvh):
    ext = np.clip(bvh.box_max - bvh.box_min, 0, None)
    area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2]
                + ext[:, 1] * ext[:, 2])
    leaf = bvh.n_prims > 0
    return (area[~leaf].sum()
            + (area[leaf] * bvh.n_prims[leaf]).sum()) / max(area[0], 1e-30)


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's native SBVH, its source built here (g++ -O3 -shared
    -fPIC, its own flags) rather than through fluctus_tpu.native.get_lib,
    which compiles into the package folder without a rename."""
    out = str(tmp_path_factory.mktemp("refnative") / "libref.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", out, REF_SRC],
                   check=True, capture_output=True, timeout=240)
    lib = ctypes.CDLL(out)
    lib.flsbvh_build.restype = ctypes.c_int64
    lib.flsbvh_build.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int32]
    lib.flsbvh_num_indices.restype = ctypes.c_int64
    lib.flsbvh_num_indices.argtypes = []
    lib.flsbvh_read.restype = None
    lib.flsbvh_read.argtypes = [ctypes.c_void_p] * 6

    def build(p):
        tris = np.ascontiguousarray(p.reshape(-1, 9), np.float32)
        n = lib.flsbvh_build(tris.ctypes.data, tris.shape[0], 8)
        k = lib.flsbvh_num_indices()
        arrs = JBVHArrays(np.empty((n, 3), np.float32),
                          np.empty((n, 3), np.float32),
                          np.empty(n, np.uint32), np.empty(n, np.int32),
                          np.empty(n, np.uint8), np.empty(k, np.uint32))
        lib.flsbvh_read(*(a.ctypes.data for a in arrs))
        return arrs
    return build


@pytest.mark.parametrize("which", ["soup", "luxball_slice"])
def test_numpy_sbvh_matches_reference(which):
    p = tri_soup(700, 3) if which == "soup" else _luxball_positions(1200)
    ours, ref = build_sbvh(p), jbuild_sbvh(p)
    _eq_tree(ours, ref)
    _validate(ours, len(p))
    if which == "soup":
        assert len(ours.indices) > len(p)      # spatial splits duplicated


@pytest.mark.parametrize("which", ["soup700", "soup20k", "luxball"])
def test_native_sbvh_matches_reference_native(ref_native, which):
    p = {"soup700": lambda: tri_soup(700, 3),
         "soup20k": lambda: tri_soup(20000, 11),
         "luxball": _luxball_positions}[which]()
    ours = build_sbvh_native(p, verbose=False)
    _eq_tree(ours, ref_native(p))
    _validate(ours, len(p))


def test_native_sbvh_matches_numpy_as_the_reference():
    """Port native against port numpy as tests/test_sbvh_native.py holds
    the reference's two builders: the same node and index counts and SAH
    cost (rtol 1e-6); they differ only in the depth cap's handling."""
    p = tri_soup(700, 3)
    nat, py = build_sbvh_native(p, verbose=False), build_sbvh(p)
    assert len(nat.n_prims) == len(py.n_prims)
    assert len(nat.indices) == len(py.indices)
    np.testing.assert_allclose(_sah_cost(nat), _sah_cost(py), rtol=1e-6)


def test_sbvh_hierarchy_file_shared(tmp_path):
    """An SBVH tree written by either package is read by the other."""
    bvh = build_sbvh_native(tri_soup(3000, 5), verbose=False)
    export_bvh(bvh, str(tmp_path / "port.bin"))
    _eq_tree(jimport_bvh(str(tmp_path / "port.bin")), bvh)
    jexport_bvh(JBVHArrays(*bvh), str(tmp_path / "ref.bin"))
    _eq_tree(import_bvh(str(tmp_path / "ref.bin")), bvh)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()


def _soup_attrs(p, seed):
    """Unit vertex normals, uvs and 3 material ids for a soup."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=p.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=2, keepdims=True)
    uv = rng.random((len(p), 3, 2), np.float32)
    return n, uv, rng.integers(0, 3, len(p)).astype(np.int32)


def _permute_leaves(bvh, seed):
    """The same tree with its leaf slices stored in a shuffled order: the
    index list is no longer in DFS order (a foreign cache's layout)."""
    leaves = np.nonzero(bvh.n_prims > 0)[0]
    perm = np.random.default_rng(seed).permutation(len(leaves))
    right = bvh.right_or_start.copy()
    parts, pos = [], 0
    for li in leaves[perm]:
        s, k = int(bvh.right_or_start[li]), int(bvh.n_prims[li])
        parts.append(bvh.indices[s:s + k])
        right[li] = pos
        pos += k
    return bvh._replace(right_or_start=right,
                        indices=np.concatenate(parts).astype(np.uint32))


@pytest.mark.parametrize("tree", ["sbvh", "sbvh_permuted", "sah_permuted"])
def test_tables_on_sbvh_and_foreign_trees(tree):
    """MXUScene.build on an SBVH tree with duplicated references (each
    cluster deduped), and on trees whose leaf slices are out of DFS order
    (the explicit walk, which both packages take, and which gives no
    superclusters): the cuts and every host table equal the reference's."""
    p = tri_soup(3000, 5)
    n, uv, mid = _soup_attrs(p, 6)
    bvh = (build_bvh(p) if tree.startswith("sah")
           else build_sbvh_native(p, verbose=False))
    if tree.endswith("permuted"):
        bvh = _permute_leaves(bvh, 7)
    jbvh = JBVHArrays(*bvh)
    ours, ref = tmt._cut_clusters(bvh, 256), jmt._cut_clusters(jbvh, 256)
    assert len(ours[0]) == len(ref[0]) > 1
    for (i0, lo0, hi0), (i1, lo1, hi1) in zip(ours[0], ref[0]):
        for x, y in ((i0, i1), (lo0, lo1), (hi0, hi1)):
            np.testing.assert_array_equal(x, y)
    if tree.endswith("permuted"):
        assert ours[1] is None and ours[2] is None and ref[1] is None
    else:
        assert len(bvh.indices) > len(p)
        assert any(len(np.unique(c[0])) < len(c[0]) for c in ours[0])
        for x, y in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(tmt._cut_supers(bvh, ours[1], ours[2], 256 * 8),
                        jmt._cut_supers(jbvh, ref[1], ref[2], 256 * 8)):
            np.testing.assert_array_equal(x, y)
    from fluctus_tpu.scene.material import HostMaterial as JMat
    from fluctus_tpu_torch.scene.material import HostMaterial as TMat
    kw = dict(normals=n, uvs=uv, mat_ids=mid)
    mats = [dict(Kd=(0.5, 0.4, 0.3)),
            dict(Ks=(0.9, 0.9, 0.9), type=bx.BXDF_GLOSSY),
            dict(Ke=(2.0, 2.0, 2.0), type=bx.BXDF_EMISSIVE)]
    host, st = tmt.MXUScene.build(p, bvh, materials=[TMat(**m) for m in mats],
                                  **kw)
    jhost, jst = jmt.MXUScene.build(p, jbvh, materials=[JMat(**m)
                                                        for m in mats],
                                    return_host=True, **kw)
    _assert_host_equal(host, jhost)
    assert st == {k: jst[k] for k in st}
    assert (host["sc_box"] is None) == tree.endswith("permuted")


@pytest.fixture(scope="module")
def soup_scene(tmp_path_factory):
    """The soup, shrunk to luxball's size, as a PLY the loaders read."""
    d = tmp_path_factory.mktemp("soup")
    p = tri_soup(3000, 5) * np.float32(0.12)
    verts = p.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3).tolist()
    return write_ply(d / "soup.ply", verts, faces)


def _sbvh(p):
    """The port's native SBVH as the reference's BVHArrays."""
    return JBVHArrays(*build_sbvh_native(p, verbose=False))


def test_trace_extension_on_sbvh_tables(soup_scene, reference_route):
    """The closest hit and its resolve on SBVH tables (duplicated refs)
    from seeded rays aimed at the soup's triangles, against the
    reference's route."""
    (js, _, _), (ts, _, _), _ = scene_setup(soup_scene, 8, 8, 2,
                                            build=_sbvh)
    rng = np.random.default_rng(23)
    n = 4096
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    p = tri_soup(3000, 5) * np.float32(0.12)
    aim = p[rng.integers(0, len(p), n)].mean(axis=1)   # a triangle's centre
    d = (aim + rng.normal(0, 0.02, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tv = lambda a: TVec3(*(torch.from_numpy(a[:, k].copy())
                           for k in range(3)))
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    th = ttrace.trace_extension(tv(o), tv(d), ts, None, False)
    jh = jtrace.trace_extension(jv(o), jv(d), js, None, False)
    i, ji = th.i.numpy(), np.asarray(jh.i)
    same = i == ji
    assert (ji >= 0).mean() > 0.3 and same.mean() >= 0.999, same.mean()
    t, jt = th.t.numpy()[same], np.asarray(jh.t)[same]
    np.testing.assert_array_less(np.abs(t - jt), np.abs(jt) * 2.0 ** -12
                                 + 1e-30)
    for a, b in zip(th.N, jh.N):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=0, atol=2.0 ** -12)
    np.testing.assert_array_equal(th.mat_id.numpy()[same],
                                  np.asarray(jh.mat_id)[same])


def test_wavefront_on_sbvh_tables(soup_scene, reference_kernels):
    """4 segments on the soup's SBVH tables at 32x16 with 512 paths."""
    check_wavefront(scene_setup(soup_scene, 32, 16, 10, build=_sbvh), 512, 4)


def test_renderer_builds_and_caches_sbvh(tmp_path, capsys):
    """Renderer._init_hierarchy with split_mode "sbvh": a miss builds the
    native SBVH (the reference's line printed) and writes
    hierarchy_<hash>_sbvh.bin; the next call hits it and builds nothing."""
    s = Settings()
    s.split_mode = "sbvh"
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path), device="cpu")
    scene = TScene()
    scene.load_model(LUXBALL)
    bvh, hit = r._init_hierarchy(scene)
    assert not hit
    out = capsys.readouterr().out
    assert "SBVH(native):" in out and "BVH built:" in out
    path = tmp_path / "hierarchies" / f"hierarchy_{scene.hash}_sbvh.bin"
    _eq_tree(jimport_bvh(str(path)), bvh)
    _eq_tree(bvh, build_sbvh_native(scene.triangle_arrays()[0],
                                    verbose=False))
    again, hit = r._init_hierarchy(scene)
    assert hit and "BVH cache hit" in capsys.readouterr().out
    _eq_tree(again, bvh)
