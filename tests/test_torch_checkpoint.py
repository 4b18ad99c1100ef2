"""Film checkpoints of the port against the JAX package, on the CPU
(luxball at 32x16, depth 4, one pool size):

  cross-load      a checkpoint the port writes (film, spp, guide
                  features) loads in the reference's Renderer and the
                  reference's writes back, loading in the port: the same
                  npz keys, every array equal; a scene or resolution
                  mismatch is refused in both
  wavefront       save after free-running segments, load into a fresh
                  Renderer's pool (film and features padded, spp with dead
                  slots parked at 2^29, as the reference's pad_pixels),
                  continue: the accumulation grows on top
  exact spp       render_single(2), save, a fresh Renderer's
                  load_checkpoint + render_single(2): spp = weight = 4 on
                  every pixel, the restored film inside the resumed one,
                  the resumed samples independent of the restored ones
                  (the port salts their seeds; the reference repeats
                  them); the same from a film left by the megastep
  features        the guide features survive a checkpoint into a live
                  wavefront state and out through wavefront_film
  vs reference    a resume of the port's checkpoint against the
                  reference's load_checkpoint with FLT_SEED_SALT set to
                  the restored sample count (the port's salt is that
                  mix): free-running with the guide features, and exact
                  spp through render_single; the restored state and the
                  counters equal, film and feature weights exact, their
                  values rtol 1e-5 (atol 1e-6)
  preview film    wavefront_preview_film (index_add_) against the
                  reference's (segment_sum) on the same pool and film
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

from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.geom import RenderConfig as JConfig
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.settings import Settings as JSettings

from fluctus_tpu_torch import flags
from fluctus_tpu_torch.core.integrator_wf import (pad_pixels, salt_seeds,
                                                  unpad_pixels,
                                                  wf_state_to_numpy)
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

from test_torch_wavefront import reference_kernels  # noqa: F401

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
PATHS = 1024
W, H = 32, 16
FEATURE_KEYS = [f"feat_{a}_{c}" for a in ("alb", "nrm")
                for c in ("x", "y", "z", "w")]


def _settings(cls, denoiser=True):
    s = cls()
    s.camera.pos, s.camera.dir = (0.0, 1.6, 4.5), (0.0, -0.12, -1.0)
    a = s.area_light
    a.pos, a.N, a.right, a.up = (0, 4, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E = (50.0, 50.0, 50.0)
    s.max_path_depth = 4
    s.wf_buffer_size = PATHS
    s.use_denoiser = denoiser
    return s


def _port(data_dir, denoiser=True, width=W, height=H):
    r = Renderer(width, height, settings=_settings(Settings, denoiser),
                 data_dir=str(data_dir), device="cpu")
    r.load_scene(LUXBALL)
    return r


def _npz(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def test_cross_load_with_reference(tmp_path):
    r = _port(tmp_path / "port")
    r.init_wavefront(PATHS)
    r.render_wavefront(4)
    ours = r.save_checkpoint(str(tmp_path / "port.npz"))
    a = _npz(ours)
    assert set(a) == {"scene_hash", "width", "height", "color_x", "color_y",
                      "color_z", "weight", "spp", *FEATURE_KEYS}
    assert a["weight"].sum() > 0 and a["feat_nrm_w"].sum() > 0

    jr = JRenderer(W, H, settings=_settings(JSettings),
                   data_dir=str(tmp_path / "ref"))
    jr.load_scene(LUXBALL)
    jr.init_wavefront(PATHS)
    assert jr.load_checkpoint(ours)
    np.testing.assert_array_equal(np.asarray(jr.film.weight), a["weight"])
    np.testing.assert_array_equal(np.asarray(jr.features.normal.y),
                                  a["feat_nrm_y"])
    np.testing.assert_array_equal(np.asarray(jr._wf_state.spp), a["spp"])
    theirs = jr.save_checkpoint(str(tmp_path / "ref.npz"))
    b = _npz(theirs)
    assert set(b) == set(a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k

    r2 = _port(tmp_path / "port")
    assert r2.load_checkpoint(theirs)
    for k, v in (("color_z", r2.film.color.z), ("weight", r2.film.weight),
                 ("feat_alb_x", r2.features.albedo.x),
                 ("feat_nrm_w", r2.features.normal_w)):
        np.testing.assert_array_equal(v.numpy(), a[k], err_msg=k)

    # another resolution (the reference's check too) is refused
    small = _port(tmp_path / "port", width=16, height=16)
    assert not small.load_checkpoint(ours)
    js = JRenderer(16, 16, settings=_settings(JSettings),
                   data_dir=str(tmp_path / "ref"))
    js.load_scene(LUXBALL)
    assert not js.load_checkpoint(ours)


def test_wavefront_resume(tmp_path):
    """A checkpoint restores the free-running pool's film and spp (padded
    as the reference's pad_pixels pads them); rendering continues on
    top."""
    r1 = _port(tmp_path, denoiser=False)
    r1.init_wavefront(PATHS)
    r1.render_wavefront(5)
    ck = r1.save_checkpoint(str(tmp_path / "wf.npz"))
    w1 = r1.wavefront_film().weight
    assert "spp" in _npz(ck) and "feat_alb_x" not in _npz(ck)

    r2 = _port(tmp_path, denoiser=False)
    r2.init_wavefront(PATHS)
    assert r2.load_checkpoint(ck)
    cfg = r2._wf_cfg
    jcfg = JConfig(width=W, height=H, groups=cfg.groups, block_ring=True)
    np.testing.assert_array_equal(
        r2._wf_state.film.weight.numpy(),
        np.asarray(jwf.pad_pixels(jnp.asarray(w1.numpy()), jcfg)))
    np.testing.assert_array_equal(
        r2._wf_state.spp.numpy(),
        np.asarray(jwf.pad_pixels(jnp.asarray(_npz(ck)["spp"]), jcfg,
                                  fill=1 << 29)))
    assert torch.equal(r2.wavefront_film().weight, w1)
    # the resumed pool draws its own stream: seeds salted with the
    # restored sample count
    fresh = r1._wf_state.pool.seed.new_tensor(range(PATHS))
    assert torch.equal(r2._wf_state.pool.seed,
                       salt_seeds(fresh, int(w1.sum())))
    r2.render_wavefront(3)
    w2 = r2.wavefront_film().weight
    assert bool((w2 >= w1).all()) and float(w2.sum()) > float(w1.sum())


@pytest.mark.parametrize("first", ["wavefront", "megastep"])
def test_exact_resume(tmp_path, monkeypatch, first):
    """render_single(2) (exact-spp wavefront, or the megastep), save, and
    a fresh Renderer's load_checkpoint + render_single(2): the restored
    film becomes the exact state's (weights as spp), and every pixel ends
    at spp = weight = 4 (the reference's renderer.py:629-643)."""
    monkeypatch.setattr(flags, "FORCE_MK", first == "megastep")
    r1 = _port(tmp_path, denoiser=False)
    r1.render_single(2)
    ck = r1.save_checkpoint(str(tmp_path / "exact.npz"))
    f1 = r1.film
    monkeypatch.setattr(flags, "FORCE_MK", False)
    r2 = _port(tmp_path, denoiser=False)
    assert r2.load_checkpoint(ck)
    film = r2.render_single(2)
    spp = unpad_pixels(r2._wf_state.spp, r2.config)
    assert bool((spp == 4).all()) and bool((film.weight == 4).all())
    assert r2._wf_exact_target == 4
    assert ("spp" in _npz(ck)) == (first == "wavefront")
    # the restored film is the resumed one's start: the added radiance
    # is the resumed samples', never negative
    for a, b in zip(film.color, f1.color):
        assert bool((a >= b).all()) and float((a - b).sum()) > 0
    # and they are samples of their own (salted seeds): no lit pixel got
    # its restored radiance again (the reference's resume repeats it)
    lit = f1.color.x > 0
    assert int(lit.sum()) > 100
    assert not bool((film.color.x == 2 * f1.color.x)[lit].any())
    # an exact state taken over from a film restored by hand: the same
    r3 = _port(tmp_path, denoiser=False)
    r3.film = r3.film._replace(weight=r3.film.weight + 3.0)
    r3.render_single_wavefront(1, accumulate=True)
    assert r3._wf_exact_target == 4 and bool((r3.film.weight == 4).all())


def test_features_through_checkpoint(tmp_path):
    """With the denoiser, the guide features go into the checkpoint, into
    a fresh Renderer's live wavefront state (padded) and back out through
    wavefront_film; the resumed pool accumulates on top of them."""
    r1 = _port(tmp_path)
    r1.init_wavefront(PATHS)
    r1.render_wavefront(4)
    ck = r1.save_checkpoint(str(tmp_path / "f.npz"))
    f1 = r1.features
    r2 = _port(tmp_path)
    r2.init_wavefront(PATHS)
    assert r2.load_checkpoint(ck)
    cfg = r2._wf_cfg
    assert torch.equal(r2._wf_state.features.normal.x,
                       pad_pixels(f1.normal.x, cfg))
    r2.wavefront_film()
    for a, b in zip(r2.features, f1):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    r2.render_wavefront(2)
    r2.wavefront_film()
    assert float(r2.features.normal_w.sum()) > float(f1.normal_w.sum())
    # a Renderer without the denoiser takes the film and leaves features
    r3 = _port(tmp_path, denoiser=False)
    assert r3.load_checkpoint(ck) and r3.features is None


def test_wavefront_preview_film_matches_reference(tmp_path):
    """wavefront_preview_film (index_add_) against the reference's method
    (segment_sum) on the same pool and film: weight exact, rgb rtol 1e-6;
    the accumulation itself is untouched."""
    from types import SimpleNamespace
    from fluctus_tpu.core.integrator_mk import Film as JFilm
    from fluctus_tpu.vec import Vec3 as JVec3
    r = _port(tmp_path, denoiser=False)
    r.init_wavefront(PATHS)
    r.render_wavefront(3)
    film = r.wavefront_film()
    got = r.wavefront_preview_film()
    assert torch.equal(r.wavefront_film().weight, film.weight)
    j = lambda t: jnp.asarray(t.numpy())
    pool = r._wf_state.pool
    fake = SimpleNamespace(
        wavefront_film=lambda: JFilm(JVec3(*(j(c) for c in film.color)),
                                     j(film.weight)),
        _wf_state=SimpleNamespace(pool=SimpleNamespace(
            pixel_index=j(pool.pixel_index), path_len=j(pool.path_len),
            Ei=JVec3(*(j(c) for c in pool.Ei)))),
        _wf_cfg=JConfig(width=W, height=H, groups=r._wf_cfg.groups,
                        block_ring=True))
    want = JRenderer.wavefront_preview_film(fake)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    assert float((got.weight - film.weight).sum()) > 0
    for a, b in zip(got.color, want.color):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------------------
# Resumes against the reference
# ---------------------------------------------------------------------------

def _reference(tmp_path, monkeypatch, ck, denoiser):
    """The reference's Renderer set to resume checkpoint ``ck`` with
    FLT_SEED_SALT at the restored sample count (set only here: the port's
    wf_reset reads the same switch). On the CPU its load_scene takes the
    jax backend and the flat ring; the route the port follows is its TPU
    route, so the MXU tables and the block-ring config that load_scene
    derives on a TPU are put in, the kernels in interpret mode."""
    fetch = jbs.fetch
    monkeypatch.setattr(jbs, "fetch",
                        lambda *a, **k: fetch(*a, **{**k, "interpret": True}))
    salt = int(_npz(ck)["weight"].astype(np.int64).sum())
    monkeypatch.setenv("FLT_SEED_SALT", str(salt))
    jr = JRenderer(W, H, settings=_settings(JSettings, denoiser),
                   data_dir=str(tmp_path / "ref"))
    jr.load_scene(LUXBALL)
    p, n, uv, mid = jr.scene.triangle_arrays()
    host, st = jmt.MXUScene.build(p, jr._bvh_host, normals=n, uvs=uv,
                                  mat_ids=mid, materials=jr.scene.materials,
                                  atlas=jr.scene.device_textures(),
                                  return_host=True)
    jr.device_scene = dataclasses.replace(
        jr.device_scene, mxu=jmt.MXUScene._from_host(host, st))
    jr.config = jr.config.replace(backend="mxu", block_ring=True,
                                  unroll_bounces=True)
    return jr


def _check_film(film, jfilm):
    np.testing.assert_array_equal(film.weight.numpy(),
                                  np.asarray(jfilm.weight))
    np.testing.assert_allclose(
        np.stack([c.numpy() for c in film.color]),
        np.stack([np.asarray(c) for c in jfilm.color]), rtol=1e-5, atol=1e-6)


def test_wavefront_resume_matches_reference(tmp_path, monkeypatch,
                                            reference_kernels):
    """The port's checkpoint after 4 free-running segments with the
    denoiser, resumed by both packages for 3 more: the restored pool
    (salted seeds, padded film, spp and features) equal to the
    reference's, then the counters equal, film and feature weights
    exact, rgb and features rtol 1e-5 (atol 1e-6)."""
    r1 = _port(tmp_path / "port")
    r1.init_wavefront(PATHS)
    r1.render_wavefront(4)
    ck = r1.save_checkpoint(str(tmp_path / "wf.npz"))
    r2 = _port(tmp_path / "port")
    r2.init_wavefront(PATHS)
    assert r2.load_checkpoint(ck)
    restored = wf_state_to_numpy(r2._wf_state)
    r2.render_wavefront(3)
    film = r2.wavefront_film()

    jr = _reference(tmp_path, monkeypatch, ck, denoiser=True)
    jr.init_wavefront(PATHS)
    assert jr.load_checkpoint(ck)
    jst = jr._wf_state
    np.testing.assert_array_equal(restored["pool"]["seed"],
                                  np.asarray(jst.pool.seed).astype(np.int64))
    np.testing.assert_array_equal(restored["spp"], np.asarray(jst.spp))
    for a, b in zip(restored["film"]["color"], jst.film.color):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(restored["features"]["normal_w"],
                                  np.asarray(jst.features.normal_w))
    jr.render_wavefront(3)
    jfilm = jr.wavefront_film()
    assert list(r2.wavefront_stats()) == list(jr.wavefront_stats())
    assert float(film.weight.sum()) > float(_npz(ck)["weight"].sum())
    _check_film(film, jfilm)
    f, jf = r2.features, jr.features
    for w, jw in ((f.albedo_w, jf.albedo_w), (f.normal_w, jf.normal_w)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    for v, jv in ((f.albedo, jf.albedo), (f.normal, jf.normal)):
        np.testing.assert_allclose(
            np.stack([c.numpy() for c in v]),
            np.stack([np.asarray(c) for c in jv]), rtol=1e-5, atol=1e-6)


def test_exact_resume_matches_reference(tmp_path, monkeypatch,
                                        reference_kernels):
    """render_single(2), save, and a fresh Renderer's load_checkpoint +
    render_single(2) in the port and in the reference: spp = weight = 4
    on every pixel in both, rgb rtol 1e-5 (atol 1e-6)."""
    r1 = _port(tmp_path / "port", denoiser=False)
    r1.render_single(2)
    ck = r1.save_checkpoint(str(tmp_path / "exact.npz"))
    r2 = _port(tmp_path / "port", denoiser=False)
    assert r2.load_checkpoint(ck)
    film = r2.render_single(2)

    jr = _reference(tmp_path, monkeypatch, ck, denoiser=False)
    assert jr.load_checkpoint(ck)
    jfilm = jr.render_single(2)
    assert bool((film.weight == 4).all())
    np.testing.assert_array_equal(
        unpad_pixels(r2._wf_state.spp, r2.config).numpy(),
        np.asarray(jwf.unpad_pixels(jr._wf_exact_state.spp, jr.config)))
    _check_film(film, jfilm)
