"""The port's denoiser against the JAX package, on the CPU:

  atrous_denoise      seeded HDR images with no guide, the albedo guide
                      and both guides, at blend 0, 0.5 and 1: rtol 1e-6
                      (atol 1e-7); a copy of the function whose shift
                      clamps at the edges (what the reference's docstring
                      says) fails that comparison: the function wraps
  K4 at 8 channels    splat_plain on the 8-channel guide-feature record
                      against the reference's splat (segment-sum and
                      interpret-mode Pallas bodies): weights exact, the
                      rest rtol 1e-6 (segment sum) or within the bf16
                      hi/lo bound (Pallas), as test_torch_kernels.py holds
                      4 channels
  wavefront           5 segments of the production luxball with the
                      denoiser on, free-running and under the exact spp
                      cap, each segment from the reference's state
                      (test_torch_texture.check_wavefront's ``resync``):
                      integer state and counters bit-equal, film weight
                      and feature weights exact, film rgb and features
                      rtol 1e-5 (atol 1e-6)
  megastep            one render_sample with features: film and features
                      rtol 1e-5 (atol 1e-6), weights exact
  renderer            render_single with the denoiser through both exact
                      routes: whole feature weights, denoised_image equal
                      to atrous_denoise of the images, save_denoised; the
                      reference's Renderer on the same film and features:
                      denoised_image rtol 1e-6 (atol 1e-7), the saved PNG
                      pixel for pixel

The scene-bearing tests share one pool size, so the reference compiles
its segment once per config."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.core import integrator_mk as jmk
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.core.denoise import atrous_denoise as jdenoise
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.settings import Settings as JSettings
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import flags
from fluctus_tpu_torch.core import block_splat as tbs
from fluctus_tpu_torch.core import denoise as tdn
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.core.pixel_ring import unpad_pixels
from fluctus_tpu_torch.image_io import save_png
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3 as TVec3

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import write_production_scene  # noqa: E402

from test_torch_mk import reference_route  # noqa: F401
from test_torch_texture import CAM, LIGHT, MAP_SIZES, scene_setup
from test_torch_wavefront import _jax_state_to_numpy
from test_torch_wavefront import reference_kernels  # noqa: F401

DEPTH = 5
SEGMENTS = 5
PATHS = 512     # one pool size: the reference compiles its segment once


def _images(seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    color = (rng.random((h, w, 3)) ** 3 * 8).astype(np.float32)
    albedo = rng.random((h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return color, albedo, normal


def _check_denoise(fn, guides, blend, seed):
    color, albedo, normal = _images(seed)
    alb = albedo if guides in ("albedo", "both") else None
    nrm = normal if guides == "both" else None
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    ref = np.asarray(jdenoise(j(color), j(alb), j(nrm), blend=blend))
    got = fn(t(color), t(alb), t(nrm), blend=blend).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    return got, color


@pytest.mark.parametrize("blend", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("guides", ["none", "albedo", "both"])
def test_atrous_matches_reference(guides, blend):
    got, color = _check_denoise(tdn.atrous_denoise, guides, blend, seed=4)
    if blend == 0.0:
        np.testing.assert_array_equal(got, color)
    else:
        assert np.abs(got - color).max() > 1e-3


def test_clamped_shift_fails():
    """A copy of atrous_denoise whose shift clamps at the image's edges
    instead of wrapping differs from the reference beyond the tolerance:
    the comparison sees the edges."""
    def clamped_shift(img, dy, dx):
        h, w = img.shape[:2]
        ys = torch.clamp(torch.arange(h) - dy, 0, h - 1)
        xs = torch.clamp(torch.arange(w) - dx, 0, w - 1)
        return img[ys][:, xs]

    wrapped = tdn._shift2d
    img = torch.arange(12.0).reshape(3, 4, 1)
    assert torch.equal(wrapped(img, 1, 0)[0], img[2])
    assert torch.equal(clamped_shift(img, 1, 0)[0], img[0])
    try:
        tdn._shift2d = clamped_shift
        with pytest.raises(AssertionError):
            _check_denoise(tdn.atrous_denoise, "both", 1.0, seed=4)
    finally:
        tdn._shift2d = wrapped
    _check_denoise(tdn.atrous_denoise, "both", 1.0, seed=4)


@pytest.mark.parametrize("body", ["segment_sum", "pallas"])
def test_splat_plain_8_channels(body):
    """The guide-feature record: [8, n] with the albedo and normal weights
    (0/1) in channels 3 and 7, against the reference's splat."""
    rng = np.random.default_rng(17)
    g, s, pk, c = 16, 128, 128, 8
    local = rng.integers(0, 20, g * s).astype(np.int32)   # collisions
    local[rng.random(g * s) < 0.3] = -1
    data = rng.normal(size=(c, g * s)).astype(np.float32)
    data[3] = rng.random(g * s) < 0.5
    data[7] = 1.0
    data[:, local < 0] = 0.0
    film = rng.normal(size=(c, g * pk)).astype(np.float32)
    kw = (dict(interpret=True) if body == "segment_sum"
          else dict(pallas_interpret=True))
    ref = np.asarray(jbs.splat(jnp.asarray(local), jnp.asarray(data),
                               jnp.asarray(film), groups=g, **kw))
    tbs.K4.plain_runs = 0
    got = tbs.splat(torch.from_numpy(local), torch.from_numpy(data),
                    torch.from_numpy(film), groups=g).numpy()
    assert tbs.K4.plain_runs == 1 and got.shape == (8, g * pk)
    np.testing.assert_array_equal(got[[3, 7]], ref[[3, 7]])
    rgb = [0, 1, 2, 4, 5, 6]
    if body == "segment_sum":
        np.testing.assert_allclose(got[rgb], ref[rgb], rtol=1e-6, atol=0)
    else:
        mag = tbs.splat_plain(torch.from_numpy(local),
                              torch.from_numpy(np.abs(data)),
                              torch.from_numpy(np.abs(film)), g).numpy()
        np.testing.assert_array_less(np.abs(got[rgb] - ref[rgb]),
                                     mag[rgb] * 2.0 ** -16 + 1e-30)


# ---------------------------------------------------------------------------
# The integrators with the denoiser
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("production"))
    return write_production_scene(d, MAP_SIZES, seed=3)


@pytest.fixture(scope="module")
def setup(scene_file):
    return scene_setup(scene_file, 32, 16, DEPTH)


def _ref_numpy(st):
    """The reference's state as numpy, its guide features included."""
    out = _jax_state_to_numpy(st)
    f = st.features
    out["features"] = dict(
        albedo=tuple(np.asarray(c) for c in f.albedo),
        albedo_w=np.asarray(f.albedo_w),
        normal=tuple(np.asarray(c) for c in f.normal),
        normal_w=np.asarray(f.normal_w))
    return out


def _check_features(a, b):
    for k in ("albedo_w", "normal_w"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("albedo", "normal"):
        np.testing.assert_allclose(np.stack(a[k]), np.stack(b[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cap", [0, 2])
def test_wavefront_features_match_reference(setup, reference_kernels,
                                            monkeypatch, cap):
    """SEGMENTS segments with the denoiser from one wf_reset, each from
    the reference's state: the pool's first-diffuse flags bit-equal, the
    guide features (weights exact, values rtol 1e-5), the film and the
    integer state as check_wavefront holds them; with ``cap`` the exact
    spp cap (K7, K8 and the features through K4)."""
    fetch = jbs.fetch
    monkeypatch.setattr(jbs, "fetch",
                        lambda *a, **k: fetch(*a, **{**k, "interpret": True}))
    (js, jp, jc), (ts, tp, tc), wr = setup
    jc, tc = jc.replace(denoiser=True), tc.replace(denoiser=True)
    if cap:
        jc, tc = jc.replace(max_spp=1), tc.replace(max_spp=1)
        jp = jp._replace(max_spp=jnp.int32(cap))
        tp = tp._replace(max_spp=torch.tensor(cap, dtype=torch.int32))
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tbs.K4.plain_runs = 0
    for seg in range(SEGMENTS):
        tst = twf.wf_state_from_numpy(_ref_numpy(jst), device="cpu")
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        jst, jcnt = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _ref_numpy(jst)
        for k in ("pixel_index", "seed", "path_len", "first_diffuse_hit"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                          err_msg=f"{k}, segment {seg}")
        np.testing.assert_array_equal(a["spp"], b["spp"])
        np.testing.assert_array_equal(a["film"]["weight"],
                                      b["film"]["weight"])
        np.testing.assert_allclose(np.stack(a["film"]["color"]),
                                   np.stack(b["film"]["color"]),
                                   rtol=1e-5, atol=1e-6)
        _check_features(a["features"], b["features"])
    # K4 splat the features each segment (and the film without the cap)
    assert tbs.K4.plain_runs == SEGMENTS * (1 if cap else 2)
    f = a["features"]
    assert f["normal_w"].sum() > 0 and f["albedo_w"].sum() > 0


def test_megastep_features_match_reference(setup, reference_route):
    """One render_sample with the denoiser, the features holding an
    earlier sample: seeds, stats and feature weights exact; film and
    features rtol 1e-5 (atol 1e-6)."""
    (js, jp, jc), (ts, tp, tc), _ = setup
    jc, tc = jc.replace(denoiser=True), tc.replace(denoiser=True)
    npx = tc.num_pixels
    rng = np.random.default_rng(23)
    vals = rng.random((8, npx)).astype(np.float32)
    vals[3] = vals[7] = 1.0
    jfeat = jmk.FeatureFilm(JVec3(*(jnp.asarray(c) for c in vals[:3])),
                            jnp.asarray(vals[3]),
                            JVec3(*(jnp.asarray(c) for c in vals[4:7])),
                            jnp.asarray(vals[7]))
    t = lambda a: torch.from_numpy(a.copy())
    tfeat = tmk.FeatureFilm(TVec3(*(t(c) for c in vals[:3])), t(vals[3]),
                            TVec3(*(t(c) for c in vals[4:7])), t(vals[7]))
    jf, jseed, jst, jfo = jmk.render_sample(
        js, jp, jmk.Film.zeros(npx), jnp.arange(npx, dtype=jnp.uint32), jc,
        jfeat)
    tf, tseed, tst, tfo = tmk.render_sample(
        ts, tp, tmk.Film.zeros(npx, "cpu"),
        torch.arange(npx, dtype=torch.int64), tc, tfeat)
    np.testing.assert_array_equal(tseed.numpy(),
                                  np.asarray(jseed).astype(np.int64))
    assert list(tst) == [int(x) for x in jst]
    np.testing.assert_allclose(np.stack([c.numpy() for c in tf.color]),
                               np.stack([np.asarray(c) for c in jf.color]),
                               rtol=1e-5, atol=1e-6)
    n = lambda v: tuple(np.asarray(c) for c in v)
    _check_features(
        dict(albedo=n(tfo.albedo), albedo_w=tfo.albedo_w.numpy(),
             normal=n(tfo.normal), normal_w=tfo.normal_w.numpy()),
        dict(albedo=n(jfo.albedo), albedo_w=np.asarray(jfo.albedo_w),
             normal=n(jfo.normal), normal_w=np.asarray(jfo.normal_w)))
    assert (tfo.normal_w.numpy() - vals[7] > 0).any()
    # without the denoiser, the three-tuple
    assert len(tmk.render_sample(ts, tp, tmk.Film.zeros(npx, "cpu"),
                                 torch.arange(npx, dtype=torch.int64),
                                 tc.replace(denoiser=False))) == 3


@pytest.mark.parametrize("force_mk", [False, True])
def test_renderer_denoised_output(scene_file, tmp_path, monkeypatch,
                                  force_mk):
    """render_single(2) with Settings.use_denoiser on either exact route:
    whole feature weights; the feature images are the accumulated
    buffers over their weights; denoised_image is atrous_denoise of the
    HDR film guided by them at denoiser_blend; save_denoised writes the
    .hdr of it and the tonemapped .png."""
    monkeypatch.setattr(flags, "FORCE_MK", force_mk)
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    s.max_path_depth = DEPTH
    s.wf_buffer_size = PATHS
    s.use_denoiser = True
    s.denoiser_blend = 0.75
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path), device="cpu")
    r.load_scene(scene_file)
    r.render_single(2)
    f = r.features
    for w in (f.albedo_w, f.normal_w):
        assert torch.equal(w, torch.round(w)) and float(w.max()) >= 1
    if force_mk:      # one path per pixel and sample: at most one each
        assert float(f.normal_w.max()) <= 2
    else:
        np.testing.assert_array_equal(
            unpad_pixels(r._wf_state.spp, r.config).numpy(), 2)
    albedo, normal = r.feature_images()
    wc = np.maximum(f.normal_w.numpy(), 1e-30)
    np.testing.assert_array_equal(
        normal[::-1].reshape(-1, 3)[:, 1], f.normal.y.numpy() / wc)
    want = tdn.atrous_denoise(torch.from_numpy(r.hdr_image().copy()),
                              torch.from_numpy(albedo.copy()),
                              torch.from_numpy(normal.copy()), blend=0.75)
    den = r.denoised_image()
    np.testing.assert_array_equal(den, want.numpy())
    assert np.isfinite(den).all() and den.shape == (8, 16, 3)
    r.save_denoised(str(tmp_path / "den.hdr"))
    r.save_denoised(str(tmp_path / "den.png"))
    assert (tmp_path / "den.hdr").stat().st_size > 0
    assert (tmp_path / "den.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    png = tmp_path / "want.png"
    from fluctus_tpu_torch.core.tonemap import postprocess
    flat = np.ascontiguousarray(den[::-1].reshape(-1, 3))
    rgb = postprocess(TVec3(*(torch.from_numpy(flat[:, k].copy())
                              for k in range(3))),
                      torch.ones(flat.shape[0]), r.params.pp.exposure,
                      r.params.pp.tm_operator)
    arr = torch.stack(list(rgb), dim=-1).numpy().reshape(8, 16, 3)[::-1]
    save_png(str(png), np.clip(arr, 0.0, 1.0))
    assert png.read_bytes() == (tmp_path / "den.png").read_bytes()

    # the reference's Renderer on the same film and features: its
    # denoised_image (rtol 1e-6, atol 1e-7, as the atrous comparison), and
    # save_denoised's PNG pixel for pixel (the reference encodes through
    # PIL, the port with its own zlib writer: the bytes differ)
    js = JSettings()
    js.max_path_depth, js.wf_buffer_size = DEPTH, PATHS
    js.use_denoiser, js.denoiser_blend = True, 0.75
    jr = JRenderer(16, 8, settings=js, data_dir=str(tmp_path / "ref"))
    jr.load_scene(scene_file)
    j = lambda t: jnp.asarray(t.numpy())
    jv = lambda v: JVec3(*(j(c) for c in v))
    jr.film = jmk.Film(jv(r.film.color), j(r.film.weight))
    jr.features = jmk.FeatureFilm(jv(f.albedo), j(f.albedo_w),
                                  jv(f.normal), j(f.normal_w))
    np.testing.assert_allclose(den, jr.denoised_image(), rtol=1e-6,
                               atol=1e-7)
    jr.save_denoised(str(tmp_path / "ref.png"))
    from PIL import Image
    pixels = [np.asarray(Image.open(tmp_path / n)) for n in ("den.png",
                                                            "ref.png")]
    assert pixels[0].shape == (8, 16, 3) and pixels[0].max() > 0
    np.testing.assert_array_equal(*pixels)


def test_feature_images_need_the_denoiser(tmp_path):
    """Without use_denoiser there are no guide features: feature_images
    raises, and denoised_image filters the film unguided."""
    s = Settings()
    s.wf_buffer_size = PATHS
    s.max_path_depth = 2
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path), device="cpu")
    r.load_scene(os.path.join(os.path.dirname(__file__), "..", "data",
                              "luxball", "luxball.obj"))
    r.render_single(1)
    assert r.features is None and r._wf_state.features is None
    with pytest.raises(RuntimeError, match="use_denoiser"):
        r.feature_images()
    want = tdn.atrous_denoise(torch.from_numpy(r.hdr_image().copy()))
    np.testing.assert_array_equal(r.denoised_image(), want.numpy())
