"""The port's wavefront slice against the JAX package on luxball: from one
wf_reset (carried across with ``wf_state_from_numpy``), 4 segments of the
phased, fused-shade path with the block-bound pool, and the port's
``Renderer(device="cpu")`` end to end.

The reference runs its Pallas kernels in interpret mode: its dispatch is
routed to the rays-on-lanes trace, the B16 resolve and the segment-sum
splat (monkeypatched in the test only)."""

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
from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.core.trace import DeviceScene as JDeviceScene
from fluctus_tpu.geom import (AreaLight as JAreaLight, Camera as JCamera,
                              PostProcessParams as JPP,
                              RenderConfig as JConfig,
                              RenderParams as JParams)
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
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
CAM = dict(pos=(0.0, 1.6, 4.5), dir=(0.0, -0.12, -1.0), up=(0.0, 1.0, 0.0),
           right=(1.0, 0.0, 0.0), fov=60.0)
LIGHT = dict(pos=(0.0, 4.0, 0.0), N=(0.0, -1.0, 0.0), right=(1.0, 0.0, 0.0),
             up=(0.0, 0.0, 1.0), E=(50.0, 50.0, 50.0), size=(0.5, 0.5))
W, H, PATHS, GROUPS, SEGMENTS = 64, 32, 2048, 16, 4


@pytest.fixture
def reference_kernels(monkeypatch):
    """Route the JAX package's kernel dispatch to its interpret-mode
    production kernels."""
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
    splat = jbs.splat
    monkeypatch.setattr(jmt, "_dispatch_trace", rol_dispatch)
    monkeypatch.setattr(jmt, "resolve_hits_mxu", resolve_v5)
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


def _setup():
    s = JScene()
    s.load_model(LUXBALL)
    p, n, uv, mid = s.triangle_arrays()
    bvh = jbuild_bvh(p)
    host, st = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                  materials=s.materials, return_host=True)
    types = s.material_types
    assert types == bx.BXDF_DIFFUSE | bx.BXDF_IDEAL_DIELECTRIC
    wr = s.world_radius()
    jscene = JDeviceScene(
        tris=TrianglesDevice.from_arrays(p, n, uv, mid),
        bvh=BVHDevice.from_host(bvh), mats=materials_to_soa(s.materials),
        atlas=pack_atlas([]), env=None, material_types=types,
        mxu=jmt.MXUScene._from_host(host, st))
    jparams = JParams(camera=JCamera.make(**CAM),
                      area_light=JAreaLight.make(**LIGHT),
                      env_map_strength=jnp.float32(1.0),
                      world_radius=jnp.float32(wr),
                      pp=JPP(jnp.float32(1.0), jnp.int32(2)))
    jcfg = JConfig(width=W, height=H, max_bounces=10, use_env_map=False,
                   use_area_light=True, material_types=types, backend="mxu",
                   block_ring=True, groups=GROUPS)
    tscene = TDeviceScene(mxu=tmt.tables_from_numpy(host, st, "cpu"),
                          material_types=types)
    tparams = TParams(camera=TCamera.make(**CAM, device="cpu"),
                      area_light=TAreaLight.make(**LIGHT, device="cpu"),
                      world_radius=torch.tensor(wr, dtype=torch.float32),
                      pp=TPP(torch.tensor(1.0), 2))
    tcfg = TConfig(width=W, height=H, max_bounces=10, material_types=types,
                   groups=GROUPS)
    return (jscene, jparams, jcfg), (tscene, tparams, tcfg), wr


def test_wavefront_slice_matches_reference(reference_kernels):
    """4 segments from one reset. Integer state (pixel_index, seed,
    path_len, ring cursors) and all four counters bit-equal; film weight
    exact; film rgb rtol 1e-5 (atol 1e-6 for near-black pixels)."""
    (js, jp, jc), (ts, tp, tc), wr = _setup()
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
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
    assert int(jcnt.splatted) > 0
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


def test_state_numpy_round_trip():
    """Every tensor of a wf_reset state through numpy and back, without
    and with the denoiser (whose pool flag and guide features are None
    without it)."""
    for denoiser in (False, True):
        cfg = TConfig(width=W, height=H, groups=GROUPS, denoiser=denoiser)
        st = twf.wf_reset(cfg, PATHS, world_radius=3.0, device="cpu")
        back = twf.wf_state_from_numpy(twf.wf_state_to_numpy(st),
                                       device="cpu")
        leaves = list(zip(torch.utils._pytree.tree_leaves(st),
                          torch.utils._pytree.tree_leaves(back)))
        assert len(leaves) == len(torch.utils._pytree.tree_leaves(back))
        for a, b in leaves:
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert (st.features is not None) == denoiser
        assert (back.pool.first_diffuse_hit is not None) == denoiser


def test_pad_unpad_and_true_pid():
    cfg = TConfig(width=37, height=11, groups=16)    # ragged tail group
    p_true, pk = twf._block_geom(cfg)
    x = torch.arange(cfg.num_pixels, dtype=torch.float32)
    padded = twf.pad_pixels(x, cfg, fill=-1)
    assert padded.shape[0] == cfg.groups * pk
    assert torch.equal(twf.unpad_pixels(padded, cfg), x)
    idx = torch.arange(cfg.groups * pk, dtype=torch.int32)
    live = padded >= 0
    assert torch.equal(twf.padded_to_true_pid(cfg, idx)[live].float(),
                       padded[live])
    jcfg = JConfig(width=37, height=11, groups=16, block_ring=True)
    np.testing.assert_array_equal(
        np.asarray(jwf.pad_pixels(jnp.asarray(x.numpy()), jcfg, fill=-1)),
        padded.numpy())
    # the flat ring keeps the true layout: all three are identities, as
    # the reference's
    flat = cfg.replace(block_ring=False)
    assert twf.pad_pixels(x, flat, fill=-1) is x
    assert twf.unpad_pixels(x, flat) is x
    assert twf.padded_to_true_pid(flat, idx) is idx
    jflat = jcfg.replace(block_ring=False)
    np.testing.assert_array_equal(
        np.asarray(jwf.pad_pixels(jnp.asarray(x.numpy()), jflat, fill=-1)),
        twf.pad_pixels(x, flat, fill=-1).numpy())


def _renderer(data_dir):
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    r = Renderer(64, 36, settings=s, data_dir=str(data_dir), device="cpu")
    r.load_scene(LUXBALL)
    return r


def test_renderer_cpu_end_to_end(tmp_path):
    """Renderer(device="cpu") on luxball at 64x36 with 2048 paths, 3
    segments: a finite film, and counters equal to driving the segment
    functions by hand from the same reset."""
    r = _renderer(tmp_path)
    r.init_wavefront(2048)
    r.render_wavefront(3)
    st = r.wavefront_stats()
    film = r.wavefront_film()
    assert film.weight.shape[0] == 64 * 36
    for c in (*film.color, film.weight):
        assert torch.isfinite(c).all()
    assert float(film.weight.sum()) == st.samples > 0

    state = twf.wf_reset(r.config, 2048, world_radius=r.world_radius,
                          device="cpu")
    total = np.zeros(4, np.int64)
    for _ in range(3):
        raw, occ = twf.wf_trace_phase(r.device_scene, state.pool, r.params,
                                      r.config)
        state, cnt = twf.wf_shade_phase(r.device_scene, r.params, state,
                                        r.config, raw, occ)
        total += [int(c) for c in cnt]
    assert list(st) == total.tolist()
    assert st.extension_rays == 3 * 2048 and st.primary_rays >= 2048
    path = tmp_path / "lux.png"
    r.save_image(str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
