"""K10 — the resolve from the f32 ``attrs`` table — and the route to it:
tables without B16 (as a table cache can hold them) against the JAX
package's own no-B16 route on luxball.

  K10 plain version     vs ``_resolve(..., interpret=True)`` on camera and
                        bounce rays
  resolve_hits_mxu      vs the reference's on tables without B16
  the dispatch          B16 -> K3 (K6 past 48 MiB), attrs -> K10, neither
                        -> the reference's refusal
  4 wavefront segments  and one ``render_sample``, both packages on the
                        no-B16 tables

The JAX package takes K10 on the CPU by itself: in interpret mode its
``resolve_hits_mxu`` always runs ``_resolve`` (mxu_trace.py:2024-2042), so
unlike the B16 tests nothing reroutes its resolve; its tables are given
without B16 all the same (``b16t``/``attr_b16`` None), as the route on the
card has them.

Tolerances. The reference interpolates with an f32 HIGHEST product over
3 tc terms of which three are nonzero, and XLA's CPU backend contracts
``a*b + c`` into a fused multiply-add (test_torch_kernels.py::
test_xla_cpu_contracts_fma); the port rounds every product and sum, as its
kernel does (-fmad=false). So: the rows built from integers (material id,
BXDF type, map ids, triangle id) equal after rint; the barycentric rows
(normal, uv, hit u/v) within 2^-12 and t within 2^-12 |t|, K3's test
bounds, since the recomputed t/u/v cancel where a ray leaves a surface;
the interpolated material constants ((1-u-v) k + u k + v k, not exactly
k) within 2^-20 |k| — the largest difference found is a few ulp.
"""

import dataclasses
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
from fluctus_tpu.core import integrator_mk as jmk
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.core import trace as jtrace
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.vec import Vec3 as TVec3

from test_torch_kernels import _rays
from test_torch_mk import _mk_setup
from test_torch_wavefront import (PATHS, SEGMENTS, _jax_state_to_numpy,
                                  _setup as _wf_setup)

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
RT = 512
EXACT_ROWS = [tmt.ATTR_MAT, tmt.ATTR_TYPE, tmt.ATTR_MAP_KD, tmt.ATTR_MAP_KS,
              tmt.ATTR_MAP_N, tmt.ATTR_TRI]
BARY_ROWS = list(range(tmt.ATTR_N, tmt.ATTR_UV + 2)) + [tmt.ATTR_HITU,
                                                        tmt.ATTR_HITV]
CONST_ROWS = list(range(tmt.ATTR_KD, tmt.ATTR_D + 1))


def _no_b16(jsc, tsc):
    """The same tables without B16, in both packages."""
    return (dataclasses.replace(jsc, b16t=None, attr_b16=None),
            tsc._replace(b16r=None, t16r=None))


@pytest.fixture(scope="module")
def lux():
    s = JScene()
    s.load_model(LUXBALL)
    p, n, uv, mid = s.triangle_arrays()
    bvh = jbuild_bvh(p)
    host, st = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                  materials=s.materials, return_host=True)
    jsc = jmt.MXUScene._from_host(host, st)
    tsc = tmt.tables_from_numpy(host, st, "cpu")
    return dict(js=s, bvh=bvh, host=host, st=st, jsc=jsc, tsc=tsc,
                no_b16=_no_b16(jsc, tsc))


def _check_rows(got, ref):
    """got, ref [40, b]: the tolerances of the module docstring."""
    np.testing.assert_array_equal(np.rint(got[EXACT_ROWS]),
                                  np.rint(ref[EXACT_ROWS]))
    np.testing.assert_allclose(got[BARY_ROWS], ref[BARY_ROWS], rtol=0,
                               atol=2.0 ** -12)
    np.testing.assert_array_less(np.abs(got[CONST_ROWS] - ref[CONST_ROWS]),
                                 np.abs(ref[CONST_ROWS]) * 2.0 ** -20
                                 + 1e-30)
    t, jt = got[tmt.ATTR_HITT], ref[tmt.ATTR_HITT]
    np.testing.assert_array_less(np.abs(t - jt), np.abs(jt) * 2.0 ** -12
                                 + 1e-30)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_k10_plain_matches_reference(lux, kind):
    """resolve_v1_plain on the winners of the port's trace against the
    reference's ``_resolve`` in interpret mode (its [b, 40] transposed);
    misses give zero columns in both."""
    jsc, tsc = lux["jsc"], lux["tsc"]
    o4, d4, tm = _rays((jsc, tsc), kind, seed=21)
    static = (tsc.n_clusters, tsc.cluster_size)
    t, col = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4),
                            torch.from_numpy(tm), tsc.t12, tsc.cluster_box,
                            static, False, RT)
    ref = np.asarray(jmt._resolve(jnp.asarray(col.numpy()),
                                  jnp.asarray(t.numpy()), jnp.asarray(o4),
                                  jnp.asarray(d4), jsc.txy_t, jsc.attrs,
                                  static, RT, True)).T
    tmt.K10.plain_runs = 0
    got = tmt.resolve_v1(col[:, 0].contiguous(), torch.from_numpy(o4),
                         torch.from_numpy(d4), tsc.txy_t, tsc.attrs,
                         tsc.cluster_size).numpy()
    assert tmt.K10.plain_runs == 1
    hit = col.numpy()[:, 0] >= 0
    assert hit.mean() > 0.1 and (~hit).any()
    assert (got[:, ~hit] == 0).all() and (ref[:, ~hit] == 0).all()
    _check_rows(got, ref)


def test_k10_within_the_b16_gate_of_k3(lux):
    """On the same winners K10 (f32 attrs) and K3 (the bf16 hi+lo table)
    agree within the reference's v5-vs-v1 gate (tests/test_mxu_resolve.py:
    97-103): integer rows after rint, N/UV/KD/NS/t within rtol 2e-3, atol
    2e-3."""
    jsc, tsc = lux["jsc"], lux["tsc"]
    o4, d4, tm = _rays((jsc, tsc), "bounce", seed=22)
    _, col = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4),
                            torch.from_numpy(tm), tsc.t12, tsc.cluster_box,
                            (tsc.n_clusters, tsc.cluster_size), False, RT)
    args = (col[:, 0].contiguous(), torch.from_numpy(o4),
            torch.from_numpy(d4))
    v1 = tmt.resolve_v1_plain(*args, tsc.txy_t, tsc.attrs,
                              tsc.cluster_size).numpy()
    v5 = tmt.resolve_v5_plain(*args, tsc.b16r, tsc.t16r).numpy()
    np.testing.assert_array_equal(np.rint(v1[EXACT_ROWS]),
                                  np.rint(v5[EXACT_ROWS]))
    for c, w in ((tmt.ATTR_N, 3), (tmt.ATTR_UV, 2), (tmt.ATTR_KD, 3),
                 (tmt.ATTR_NS, 1), (tmt.ATTR_HITT, 1)):
        np.testing.assert_allclose(v1[c:c + w], v5[c:c + w], rtol=2e-3,
                                   atol=2e-3)


def _vecs(a4, center, conv, mk, n):
    return mk(*(conv(np.ascontiguousarray(a4[:n, k] + center[k]))
                for k in range(3)))


def test_resolve_hits_mxu_without_b16(lux):
    """The port's resolve_hits_mxu on the no-B16 tables (1500 rays, not a
    tile multiple) against the reference's own resolve_hits_mxu in
    interpret mode on its no-B16 tables: [40, n], K10's plain version run
    once and K3 not at all."""
    jsc, tsc = lux["no_b16"]
    o4, d4, tm = _rays((lux["jsc"], lux["tsc"]), "bounce", seed=23)
    n = 1500
    t, col = tmt._trace_rol(torch.from_numpy(o4), torch.from_numpy(d4),
                            torch.from_numpy(tm), tsc.t12, tsc.cluster_box,
                            (tsc.n_clusters, tsc.cluster_size), False, RT)
    t, col = t[:n, 0].contiguous(), col[:n, 0].contiguous()
    c = tsc.center.numpy()
    z = np.zeros(3, np.float32)
    ref = np.asarray(jmt.resolve_hits_mxu(
        _vecs(o4, c, jnp.asarray, JVec3, n), _vecs(d4, z, jnp.asarray,
                                                   JVec3, n),
        jnp.asarray(t.numpy()), jnp.asarray(col.numpy()), jsc,
        interpret=True))
    tmt.K3.plain_runs = tmt.K10.plain_runs = 0
    got = tmt.resolve_hits_mxu(_vecs(o4, c, torch.from_numpy, TVec3, n),
                               _vecs(d4, z, torch.from_numpy, TVec3, n), t,
                               col, tsc).numpy()
    assert (tmt.K10.plain_runs, tmt.K3.plain_runs) == (1, 0)
    assert got.shape == ref.shape == (tmt.ATTR_COLS, n)
    _check_rows(got, ref)


@pytest.mark.parametrize("tables,ran", [("b16", "resolve_v5"),
                                        ("b16_past_48MiB", "resolve_v5s"),
                                        ("attrs", "resolve_v1"),
                                        ("neither", None)])
def test_resolve_dispatch(lux, tables, ran):
    """resolve_hits_mxu picks the resolve by what the tables hold, as the
    reference: B16 -> K3 (K6 once the reference's table bytes pass 48
    MiB), else attrs -> K10, else its refusal. The plain-run counters say
    which ran; no other resolve runs."""
    from fluctus_tpu_torch import kernel_build as kb
    tsc = lux["tsc"]
    sc = {"b16": tsc, "b16_past_48MiB": tsc._replace(n_clusters=4096),
          "attrs": lux["no_b16"][1],
          "neither": lux["no_b16"][1]._replace(attrs=None)}[tables]
    z = torch.zeros(8)
    orig = TVec3(z, z + 1.6, z + 4.5)
    d = TVec3(z, z, z - 1.0)
    col = torch.arange(8, dtype=torch.int32) * 97 - 1
    kb.reset_counts()
    if ran is None:
        with pytest.raises(ValueError, match="slim MXUScene has only the "
                           "B16 resolve"):
            tmt.resolve_hits_mxu(orig, d, z, col, sc)
    else:
        out = tmt.resolve_hits_mxu(orig, d, z, col, sc)
        assert out.shape == (tmt.ATTR_COLS, 8) and (out[:, 0] == 0).all()
    runs = {k.name: k.plain_runs for k in kb.KERNELS.values()
            if k.plain_runs}
    assert runs == ({} if ran is None else {ran: 1})


def test_tables_from_reference_host_without_b16(lux):
    """tables_from_numpy on the reference's host dict with B16 left out:
    no b16r/t16r, attrs and txy_t uploaded bit for bit."""
    host = dict(lux["host"], b16t=None, attr_b16=None)
    sc = tmt.tables_from_numpy(host, lux["st"], "cpu")
    assert sc.b16r is None and sc.t16r is None
    np.testing.assert_array_equal(sc.attrs.numpy(), host["attrs"])
    np.testing.assert_array_equal(sc.txy_t.numpy(), host["txy_t"])
    assert sc.attrs.shape == (3 * 33 * 256, tmt.ATTR_COLS)


@pytest.fixture
def reference_trace(monkeypatch):
    """The reference's trace dispatch routed to its interpret-mode
    rays-on-lanes kernel and its splat to the segment-sum reference; its
    resolve is left as it is (K10 in interpret mode)."""
    def rol_dispatch(o4, d4, tmax_col, scene, any_hit, ray_tile, interpret):
        return jmt._trace_rol(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                              (scene.n_clusters, scene.cluster_size), any_hit,
                              jmt.ROL_TILE, True)
    splat = jbs.splat
    monkeypatch.setattr(jmt, "_dispatch_trace", rol_dispatch)
    monkeypatch.setattr(jbs, "splat",
                        lambda *a, **k: splat(*a, **{**k, "interpret": True}))


def test_wavefront_without_b16_matches_reference(reference_trace):
    """4 wavefront segments from one reset on the no-B16 tables, the port
    resolving through K10's plain version, the reference through its own
    K10: integer state, ring cursors and counters bit-equal; film weight
    exact; film rgb rtol 1e-5 (atol 1e-6). No lane's lobe choice flipped
    (the integer state would show it)."""
    (js, jp, jc), (ts, tp, tc), wr = _wf_setup()
    jsc, tsc = _no_b16(js.mxu, ts.mxu)
    js, ts = dataclasses.replace(js, mxu=jsc), ts._replace(mxu=tsc)
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
    tmt.K3.plain_runs = tmt.K10.plain_runs = 0
    for seg in range(SEGMENTS):
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        jst, jcnt = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _jax_state_to_numpy(jst)
        for k in ("pixel_index", "seed", "path_len"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                          err_msg=f"{k}, segment {seg}")
        np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
    assert (tmt.K10.plain_runs, tmt.K3.plain_runs) == (SEGMENTS, 0)
    assert int(jcnt.splatted) > 0
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


def test_render_sample_without_b16_matches_reference(lux, reference_trace,
                                                     monkeypatch):
    """One render_sample (megastep) at 32x16, depth 5, on the no-B16
    tables: the reference on its device route (sorted single-set traces;
    ``_interpret_pallas`` patched False) with its resolve_hits_mxu run in
    interpret mode, hence K10. Seeds and RenderStats bit-equal, film
    weight exact, rgb rtol 1e-5 (atol 1e-6)."""
    jres = jmt.resolve_hits_mxu
    monkeypatch.setattr(jtrace, "_interpret_pallas", lambda: False)
    monkeypatch.setattr(jmt, "resolve_hits_mxu",
                        lambda *a, **k: jres(*a, **{**k, "interpret": True}))
    jsc, tsc = lux["no_b16"]
    w, h = 32, 16
    (js, jp, jc), (ts, tp, tc) = _mk_setup(lux, w, h, 5)
    js, ts = dataclasses.replace(js, mxu=jsc), ts._replace(mxu=tsc)
    npx = w * h
    tmt.K3.plain_runs = tmt.K10.plain_runs = 0
    jf, jseed, jst = jmk.render_sample(
        js, jp, jmk.Film.zeros(npx), jnp.arange(npx, dtype=jnp.uint32), jc)
    tf, tseed, tst = tmk.render_sample(
        ts, tp, tmk.Film.zeros(npx, "cpu"),
        torch.arange(npx, dtype=torch.int64), tc)
    assert tmt.K10.plain_runs == 6 and tmt.K3.plain_runs == 0
    np.testing.assert_array_equal(tseed.numpy(),
                                  np.asarray(jseed).astype(np.int64))
    assert list(tst) == [int(x) for x in jst]
    assert tst.shadow_rays > 0 and tst.extension_rays > 0
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    np.testing.assert_allclose(np.stack([c.numpy() for c in tf.color]),
                               np.stack([np.asarray(c) for c in jf.color]),
                               rtol=1e-5, atol=1e-6)
