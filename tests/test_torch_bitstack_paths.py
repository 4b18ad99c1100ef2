"""The port's whole render paths on the bitstack route (scenes without
cluster tables, traced through accel/traverse.py) against the JAX package,
and the reference's physics checks on that route, on the CPU.

- quad_scene (both packages build it without tables) under its area light:
  wavefront segments on the flat ring, the block ring and the block ring
  under the spp cap (the reference's block kernels in interpret mode,
  ``backend="jax"``), held as ``test_torch_texture.check_wavefront(...,
  resync=True)`` holds them: counters and integer state exact, film
  weight exact, rgb rtol 1e-5 (atol 1e-6).
- render_sample on the quad and on luxball (5,642 triangles, its SAH
  BVH) against the JAX package's (``check_megastep``).
- The white furnace, MIS consistency, the area light's direct term and
  the env-only background (tests/test_integrator.py:67-130), and the
  wavefront's furnace against the megastep's value
  (tests/test_wavefront.py:20-34), on the port's bitstack quad with the
  reference's sample counts and bounds.

The sharded runs on this route are in tests/test_torch_parallel.py (the
``_bvh`` rings and ``test_mk_sharded_bitstack_equals_unsharded``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import testing as jtesting
from fluctus_tpu.accel import build_bvh as jbuild_bvh
from fluctus_tpu.accel.traverse import BVHDevice as JBVHDevice
from fluctus_tpu.accel.traverse import TrianglesDevice as JTriangles
from fluctus_tpu.core.trace import DeviceScene as JDeviceScene
from fluctus_tpu.geom import (AreaLight as JAreaLight, Camera as JCamera,
                              PostProcessParams as JPP,
                              RenderConfig as JConfig,
                              RenderParams as JParams)
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene.material import materials_to_soa as jmaterials
from fluctus_tpu.scene.texture import pack_atlas as jpack_atlas

from fluctus_tpu_torch import bxdf_types as bx
from fluctus_tpu_torch import testing as ttesting
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.geom import (AreaLight as TAreaLight,
                                    Camera as TCamera,
                                    PostProcessParams as TPP,
                                    RenderConfig as TConfig,
                                    RenderParams as TParams)
from fluctus_tpu_torch.scene import Scene as TScene

from test_torch_texture import check_megastep, check_wavefront
from test_torch_wavefront import CAM, LIGHT, LUXBALL

QUAD = (32, 16)
QUAD_PATHS = 512
QUAD_GROUPS = 4            # the block ring: 128 lanes a group
SEGMENTS = 5


def _quad_pair(**cfg):
    """Both packages' quad_scene and quad_setup at QUAD under the area
    light, depth 3, with the RenderConfig fields ``cfg``."""
    jp, jc = jtesting.quad_setup(*QUAD, max_bounces=3, use_area_light=True,
                                 **cfg)
    tp, tc = ttesting.quad_setup(*QUAD, max_bounces=3, use_area_light=True,
                                 device="cpu", **cfg)
    return ((jtesting.quad_scene(), jp, jc),
            (ttesting.quad_scene(device="cpu"), tp, tc),
            float(jp.world_radius))


def test_quad_scene_is_the_references():
    """The port's quad_scene has no tables; its BVH, triangles and
    material are the reference's arrays."""
    js, ts = jtesting.quad_scene(), ttesting.quad_scene(device="cpu")
    assert ts.mxu is None and ts.bvh is not None
    for f in ("right_or_start", "parent", "n_prims", "indices"):
        np.testing.assert_array_equal(getattr(ts.bvh, f).numpy(),
                                      np.asarray(getattr(js.bvh, f)))
    assert ts.bvh.max_leaf == js.bvh.max_leaf
    for f in ("v0", "e1", "e2", "n0"):
        for a, b in zip(getattr(ts.tris, f), getattr(js.tris, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    kd = ts.mats.Kd.x.numpy()      # the reference pads its table
    np.testing.assert_array_equal(kd, np.asarray(js.mats.Kd.x)[:len(kd)])
    assert ts.material_types == js.material_types


@pytest.mark.parametrize("ring", ["flat", "block", "block_capped"])
def test_quad_segments_match_reference(ring):
    """SEGMENTS wavefront segments on the quad through its BVH, on the
    flat ring, the block ring, and the block ring under a cap of 2 spp
    (K7/K8's plain versions against the reference's kernels)."""
    cfg = {} if ring == "flat" else dict(block_ring=True,
                                         groups=QUAD_GROUPS)
    setup = _quad_pair(**cfg)
    last = check_wavefront(setup, QUAD_PATHS, SEGMENTS,
                           cap=2 if ring.endswith("capped") else 0,
                           resync=True)
    assert last["film"]["weight"].sum() > 0


def _luxball_pair(width=32, height=16):
    """luxball without tables in both packages: the triangle arrays, the
    SAH BVH and the materials, test_torch_wavefront's camera and light,
    depth 3, the area light on."""
    js, ts = JScene(), TScene()
    js.load_model(LUXBALL)
    ts.load_model(LUXBALL)
    p, n, uv, mid = js.triangle_arrays()
    types = js.material_types
    jscene = JDeviceScene(
        tris=JTriangles.from_arrays(p, n, uv, mid),
        bvh=JBVHDevice.from_host(jbuild_bvh(p)),
        mats=jmaterials(js.materials),
        atlas=jpack_atlas([]), env=None, material_types=types)
    tscene = ttesting.bitstack_scene(*ts.triangle_arrays(), ts.materials,
                                     ts.material_types, "cpu")
    wr = js.world_radius()
    jparams = JParams(camera=JCamera.make(**CAM),
                      area_light=JAreaLight.make(**LIGHT),
                      env_map_strength=jnp.float32(1.0),
                      world_radius=jnp.float32(wr),
                      pp=JPP(jnp.float32(1.0), jnp.int32(0)))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    tparams = TParams(camera=TCamera.make(**CAM, device="cpu"),
                      area_light=TAreaLight.make(**LIGHT, device="cpu"),
                      env_map_strength=f32(1.0), world_radius=f32(wr),
                      pp=TPP(f32(1.0), 0))
    kw = dict(width=width, height=height, max_bounces=3, use_env_map=False,
              use_area_light=True, material_types=types)
    return ((jscene, jparams, JConfig(**kw)), (tscene, tparams,
                                              TConfig(**kw)), wr)


@pytest.mark.parametrize("scene", ["quad", "luxball"])
def test_render_sample_matches_reference(scene):
    """One render_sample through the BVH: seeds and RenderStats exact,
    film weight exact, rgb rtol 1e-5 (check_megastep)."""
    setup = _quad_pair() if scene == "quad" else _luxball_pair()
    stats = check_megastep(setup)
    assert stats.samples == setup[1][2].num_pixels
    assert setup[1][0].mxu is None


# ---------------------------------------------------------------------------
# The reference's physics checks on the port's bitstack route
# ---------------------------------------------------------------------------

def _render(scene, params, config, spp):
    """spp render_samples from seeds = pixel ids: the per-pixel mean
    [H, W, 3] and the last RenderStats."""
    n = config.num_pixels
    film = tmk.Film.zeros(n, "cpu")
    seed = torch.arange(n, dtype=torch.int64)
    for _ in range(spp):
        film, seed, stats = tmk.render_sample(scene, params, film, seed,
                                              config)
    mean = torch.stack(list(film.color), -1) / film.weight[:, None]
    return mean.numpy().reshape(config.height, config.width, 3), stats


def test_white_furnace_quad_bitstack():
    """Diffuse quad (Kd = 0.5) under the uniform unit env map: the centre
    converges to the albedo 0.5^2.2 within 3% at 48 spp
    (test_integrator.py:67-78)."""
    scene = ttesting.quad_scene(kd=0.5, device="cpu")
    params, config = ttesting.quad_setup(32, 32, 3, device="cpu")
    img, stats = _render(scene, params, config, spp=48)
    expect = 0.5 ** 2.2
    assert abs(img[8:24, 8:24].mean() - expect) / expect < 0.03
    assert stats.samples == config.num_pixels


def test_mis_consistency_bitstack():
    """NEE + BSDF with MIS, NEE only and BSDF only converge to the albedo
    0.8^2.2 within 5% at 96 spp (test_integrator.py:81-93)."""
    scene = ttesting.quad_scene(kd=0.8, device="cpu")
    expect = 0.8 ** 2.2
    for impl, expl in ((True, True), (False, True), (True, False)):
        params, config = ttesting.quad_setup(32, 32, 3, device="cpu",
                                             sample_impl=impl,
                                             sample_expl=expl)
        img, _ = _render(scene, params, config, spp=96)
        val = img[8:24, 8:24].mean()
        assert abs(val - expect) / expect < 0.05, (impl, expl, val)


def test_area_light_illumination_bitstack():
    """The quad (Kd = 1) lit by a small area light 4 above it alone: the
    centre within 8% of the analytic direct term (test_integrator.py:
    96-120)."""
    scene = ttesting.quad_scene(kd=1.0, with_env=False, device="cpu")
    h = 4.0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    params = TParams(
        camera=TCamera.make(pos=(0, 0, 5), dir=(0, 0, -1), up=(0, 1, 0),
                            right=(1, 0, 0), fov=10.0, device="cpu"),
        area_light=TAreaLight.make(pos=(0, 0, h), N=(0, 0, -1),
                                   right=(1, 0, 0), up=(0, 1, 0),
                                   E=(10, 10, 10), size=(0.1, 0.1),
                                   device="cpu"),
        env_map_strength=f32(1.0), world_radius=f32(80.0),
        pp=TPP(f32(1.0), 0))
    config = TConfig(width=16, height=16, max_bounces=2, use_env_map=False,
                     use_area_light=True, material_types=bx.BXDF_DIFFUSE)
    img, _ = _render(scene, params, config, spp=256)
    lo = (1.0 / np.pi) * 10.0 * 0.2 * 0.2 / (h * h)
    assert abs(img[6:10, 6:10].mean() - lo) / lo < 0.08


def test_env_only_background_bitstack():
    """A tiny quad: the corner pixels miss it and show the unit env map
    within 0.02 (test_integrator.py:123-130)."""
    scene = ttesting.quad_scene(kd=0.5, size=0.01, device="cpu")
    params, config = ttesting.quad_setup(32, 32, 3, device="cpu")
    img, _ = _render(scene, params, config, spp=8)
    assert abs(img[:4, :4].mean() - 1.0) < 0.02


def test_wavefront_furnace_matches_mk_bitstack():
    """120 wavefront segments of 2,048 paths on the 16x16 quad through its
    BVH: every pixel sampled, the centre within 5% of the albedo the
    megastep converges to (test_wavefront.py:20-34)."""
    scene = ttesting.quad_scene(kd=0.5, device="cpu")
    params, config = ttesting.quad_setup(16, 16, 3, device="cpu")
    state = twf.wf_reset(config, 2048,
                         world_radius=float(params.world_radius),
                         device="cpu")
    for _ in range(120):
        state, _ = twf.wf_segment(scene, params, state, config)
    w = state.film.weight.numpy()
    assert w.min() > 0
    img = (state.film.color.x.numpy() / w).reshape(16, 16)
    expect = 0.5 ** 2.2
    assert abs(img[4:12, 4:12].mean() - expect) / expect < 0.05
