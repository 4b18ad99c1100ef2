"""The port's host scene code (OBJ loader, SAH BVH, cluster tables) against
the JAX package's on the in-repo luxball scene: every array bit-equal,
including the bf16 bits of the B16 resolve table."""

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
from fluctus_tpu.scene import Scene as JScene

from fluctus_tpu_torch.accel import build_bvh as tbuild_bvh
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.scene import Scene as TScene

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")


@pytest.fixture(scope="module")
def luxball():
    js, ts = JScene(), TScene()
    js.load_model(LUXBALL)
    ts.load_model(LUXBALL)
    return js, ts


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_scene_and_bvh_equal(luxball):
    js, ts = luxball
    for a, b in zip(js.triangle_arrays(), ts.triangle_arrays()):
        np.testing.assert_array_equal(a, b)
    assert js.material_types == ts.material_types == 66
    assert [m.__dict__ for m in js.materials] == \
        [m.__dict__ for m in ts.materials]
    assert js.world_radius() == ts.world_radius()
    p = js.triangle_arrays()[0]
    for a, b in zip(jbuild_bvh(p), tbuild_bvh(p)):
        np.testing.assert_array_equal(a, b)


def test_host_tables_bit_equal(luxball):
    """MXUScene.build(return_host=True): same keys, every array bit-equal
    (bf16 compared as uint16 bits), same statics."""
    js, ts = luxball
    p, n, uv, mid = js.triangle_arrays()
    bvh = jbuild_bvh(p)
    jh, jst = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                 materials=js.materials, return_host=True)
    th, tst = tmt.MXUScene.build(p, tbuild_bvh(p), normals=n, uvs=uv,
                                 mat_ids=mid, materials=ts.materials)
    assert jst == tst and tst["n_clusters"] == 33
    assert jh.keys() == th.keys()
    for k in jh:
        if jh[k] is None:
            assert th[k] is None, k
            continue
        a, b = _bits(jh[k]), _bits(th[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_bf16_split_matches_ml_dtypes():
    """torch's float32 -> bfloat16 conversion rounds to nearest even like
    ml_dtypes: the bits agree on random, tie and special values."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.normal(size=100000).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 100000),
        # exact ties between two bf16 values, both parities
        (np.arange(1, 4097, dtype=np.uint32) << 16 | 0x8000).view(
            np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, 3.4e38], np.float32),
    ]).astype(np.float32)
    ref = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tmt._bf16_bits(x), ref)
    hi, lo = tmt._b16_split(x[:100000])
    rhi = x[:100000].astype(ml_dtypes.bfloat16).astype(np.float32)
    rlo = (x[:100000] - rhi).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(hi, rhi)
    np.testing.assert_array_equal(lo, rlo)


def test_tables_from_numpy_layouts(luxball):
    """tables_from_numpy on the JAX host dict: the row-major re-packs K3
    reads (b16r, t16r) hold the same bits as the reference layouts (the
    cluster-blocked b16t/t12b stay on the host and are compared there)."""
    js, _ = luxball
    p, n, uv, mid = js.triangle_arrays()
    jh, jst = jmt.MXUScene.build(p, jbuild_bvh(p), normals=n, uvs=uv,
                                 mat_ids=mid, materials=js.materials,
                                 return_host=True)
    sc = tmt.tables_from_numpy(jh, jst, "cpu")
    b16r = sc.b16r.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(b16r, _bits(jh["attr_b16"]))
    ncl, tc = jst["n_clusters"], jst["cluster_size"]
    np.testing.assert_array_equal(
        b16r.reshape(ncl, tc, tmt.B16.COLS).transpose(0, 2, 1).reshape(
            ncl * tmt.B16.COLS, tc), _bits(jh["b16t"]))
    np.testing.assert_array_equal(
        sc.t16r.numpy().reshape(ncl, tc, 16).transpose(0, 2, 1).reshape(
            ncl * 16, tc), jh["t12b"])
    np.testing.assert_array_equal(sc.t16r[:, :12].numpy(), jh["txy_t"])
    np.testing.assert_array_equal(sc.sc_box.numpy(), jh["sc_box"])
    assert not hasattr(sc, "b16t") and not hasattr(sc, "t12b")
    np.testing.assert_array_equal(sc.t12.numpy(), jh["t12"])
    np.testing.assert_array_equal(sc.lo.numpy(),
                                  jh["cluster_box"][:, 0:3].min(0))
    assert (sc.n_clusters, sc.cluster_size) == (33, 256)


def test_materials_to_soa(luxball):
    """The device material table holds the reference's rows (the
    reference pads its table to 128 rows for the TPU; the port does not)."""
    from fluctus_tpu.scene.material import materials_to_soa as jsoa
    js, ts = luxball
    j, t = jsoa(js.materials), ts.device_materials(device="cpu")
    m = len(ts.materials)
    for name in t._fields:
        a, b = getattr(j, name), getattr(t, name)
        if isinstance(b, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x)[:m])
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a)[:m])
