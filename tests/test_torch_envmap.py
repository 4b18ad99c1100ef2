"""The port's environment map against the JAX package, on the CPU:

  read_hdr, write_hdr   gallery/teapot_wavefront.hdr (512x512 RGBE) and a
                        write -> read round trip: bit-equal
  build_alias_table,    every host table of EnvironmentMap, on that file
  EnvironmentMap        and on seeded maps of 512x256 (the fast route) and
                        1024x512 (2^19 texels: no prob_alias): bit-equal
  device functions      65,536 seeded directions and randoms, fast and
                        not: texel indices and alias picks equal on
                        >= 99.99% of lanes, each differing lane within
                        4 x 2^-24 of a texel edge in u or v; radiance, pdf
                        and sampled directions rtol 1e-5 (atol 1e-6) on
                        the lanes whose indices agree
  wavefront, megastep   4 segments of the wavefront with the env map on
                        (fast_env both ways, and the env map alone) and
                        one megastep sample, as test_torch_wavefront.py
                        and test_torch_mk.py hold them without it
  Renderer              load_scene(env_map=...) on the CPU, and the
                        reference's WARNING for a missing file

(u, v) themselves differ between the packages by at most 4 x 2^-24:
XLA's CPU backend fuses ``atan2(x, -z) * c + 0.5`` into one multiply-add
and computes acos by its own decomposition, and its sin and cos differ
from torch's in the last bit on a few percent of lanes. A bilinear weight
moves by w times such a difference, so the bilinear lookup is held on the
same (u, v), and (u, v) on their own."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import envmap as je
from fluctus_tpu import rgbe as jrgbe
from fluctus_tpu.core import integrator_mk as jmk
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.settings import Settings as JSettings
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import envmap as te
from fluctus_tpu_torch import rgbe as trgbe
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3 as TVec3

from test_torch_mk import _mk_setup, lux, reference_route  # noqa: F401
from test_torch_wavefront import (CAM, LIGHT, PATHS, SEGMENTS,
                                  _jax_state_to_numpy, reference_kernels,
                                  _setup as _wf_setup)  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TEAPOT = os.path.join(ROOT, "gallery", "teapot_wavefront.hdr")
LUXBALL = os.path.join(ROOT, "data", "luxball", "luxball.obj")
N = 65536
EDGE = 4 * 2.0 ** -24       # the largest (u, v) difference allowed
STRENGTH = 0.75             # env_map_strength of the integrator tests


def _seeded_map(w, h, seed):
    """A map of lognormal texels with a bright disc and a black band (cells
    of pdf 0), made from a numpy seed."""
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(size=(h, w, 3))).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy - h // 4) ** 2 + (xx - w // 3) ** 2 < (h // 16) ** 2] *= 200.0
    img[h - h // 8:] = 0.0
    return img


_MAPS = {}


def _maps(key):
    """(reference EnvironmentMap, port EnvironmentMap) of the file or of a
    seeded map, built once per process."""
    if key not in _MAPS:
        if key == "file":
            _MAPS[key] = (je.EnvironmentMap(TEAPOT),
                          te.EnvironmentMap(TEAPOT))
        else:
            w, h = key
            img = _seeded_map(w, h, seed=w + h)
            _MAPS[key] = (je.EnvironmentMap.from_array(img),
                          te.EnvironmentMap.from_array(img))
    return _MAPS[key]


def _eq(a, b):
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# Host side: bit-equal
# ---------------------------------------------------------------------------

def test_read_hdr_matches_reference(tmp_path):
    """The in-repo 512x512 Radiance file, and a seeded image written by the
    port's writer (old-style flat scanlines), read bit-equal by both
    readers; both writers write the same bytes."""
    data, w, h = trgbe.read_hdr(TEAPOT)
    ref, rw, rh = jrgbe.read_hdr(TEAPOT)
    assert (w, h) == (rw, rh) == (512, 512)
    _eq(data, ref)
    assert np.isfinite(data).all() and data.max() > 0.0
    img = _seeded_map(48, 20, seed=1)
    ours, theirs = tmp_path / "ours.hdr", tmp_path / "theirs.hdr"
    trgbe.write_hdr(str(ours), img)
    jrgbe.write_hdr(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    back, bw, bh = trgbe.read_hdr(str(ours))
    assert (bw, bh) == (48, 20)
    _eq(back, jrgbe.read_hdr(str(ours))[0])
    step = img.max(axis=-1, keepdims=True) / 128.0   # RGBE's precision
    assert (np.abs(back - img) <= step + 1e-4).all()


def test_build_alias_table_matches_reference():
    rng = np.random.default_rng(2)
    n = 4096
    weights = rng.random(n) ** 4
    weights[rng.random(n) < 0.1] = 0.0
    pdf = weights / weights.sum() * n
    for got, ref in zip(te.build_alias_table(pdf),
                        je.build_alias_table(pdf)):
        _eq(got, ref)


@pytest.mark.parametrize("key", ["file", (512, 256), (1024, 512)])
def test_host_tables_match_reference(key):
    """Every host table bit-equal: image, pdf, prob and alias tables,
    packed RGBE words, packed alias pairs (absent past 2^18 texels) and
    1/mean(lum sin)."""
    jm, tm = _maps(key)
    assert (tm.width, tm.height) == (jm.width, jm.height)
    for c in range(3):
        _eq(tm.image[c], jm.image[c])
    for name in ("pdf_table", "prob_table", "alias_table", "packed"):
        _eq(getattr(tm, name), getattr(jm, name))
    assert (tm.prob_alias is None) == (jm.prob_alias is None) == \
        (tm.width * tm.height > 1 << 18)
    if tm.prob_alias is not None:
        _eq(tm.prob_alias, jm.prob_alias)
    _eq(tm.inv_mean_lum, jm.inv_mean_lum)
    tt = tm.device_tables("cpu")
    _eq(tt.packed.numpy().view(np.uint32), jm.packed)
    assert (tt.width, tt.height) == (jm.width, jm.height)


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def _directions(seed):
    """N unit directions: seeded normals, plus the poles, the axes and
    directions past the pdf's d.y > 0.99 cut."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3))
    d[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1]]
    d[6:64, 1] = 50.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    return (JVec3(*(jnp.asarray(d[:, k]) for k in range(3))),
            TVec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _close(got, ref, ok=None):
    got, ref = np.asarray(got), np.asarray(ref)
    if ok is not None:
        got, ref = got[..., ok], ref[..., ok]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _near_edge(x, size):
    """Whether x * size lies within EDGE * size of an integer."""
    s = np.asarray(x, np.float64) * size
    return np.abs(s - np.round(s)) <= EDGE * size


def _check_indices(got, ref, u, v, w, h):
    """Indices equal on >= 99.99% of lanes; each differing lane within EDGE
    of a texel edge in u or v. Returns the mask of equal lanes."""
    got, ref = np.asarray(got), np.asarray(ref)
    same = got == ref
    assert same.mean() >= 0.9999, same.mean()
    bad = ~same
    assert (_near_edge(u[bad], w) | _near_edge(v[bad], h)).all()
    return same


@pytest.fixture(scope="module", params=[(512, 256), "file"])
def env_pair(request):
    jm, tm = _maps(request.param)
    return jm, tm, jm.device_tables(), tm.device_tables("cpu")


def test_direction_uv_matches_reference(env_pair):
    """direction_to_uv within EDGE; uv_to_direction rtol 1e-5; the texel
    index of each direction equal but within EDGE of an edge."""
    _, _, jt, tt = env_pair
    jd, td = _directions(11)
    ju, jv = je.direction_to_uv(jd)
    tu, tv = te.direction_to_uv(td)
    ju, jv = np.asarray(ju), np.asarray(jv)
    assert np.abs(tu.numpy() - ju).max() <= EDGE
    assert np.abs(tv.numpy() - jv).max() <= EDGE
    jdir, jsin = je.uv_to_direction(jnp.asarray(ju), jnp.asarray(jv))
    tdir, tsin = te.uv_to_direction(torch.from_numpy(ju.copy()),
                                    torch.from_numpy(jv.copy()))
    _close(_np3(tdir), _np3(jdir))
    _close(tsin, jsin)
    _check_indices(te._texel_index(tt, td)[0], je._texel_index(jt, jd)[0],
                   ju, jv, tt.width, tt.height)


@pytest.mark.parametrize("fast", [False, True])
def test_env_radiance_and_pdf_matches_reference(env_pair, fast,
                                                monkeypatch):
    """env_radiance_and_pdf: the fast route's radiance and pdf (and
    eval_env_map_dir_fast) on the lanes whose texel agrees; the bilinear
    route's radiance on the same (u, v), its pdf on the lanes whose texel
    agrees."""
    _, _, jt, tt = env_pair
    jd, td = _directions(12)
    ju, jv = (np.asarray(a) for a in je.direction_to_uv(jd))
    same = _check_indices(te._texel_index(tt, td)[0],
                          je._texel_index(jt, jd)[0], ju, jv, tt.width,
                          tt.height)
    tl, tp = te.env_radiance_and_pdf(tt, td, fast)
    if not fast:
        tu, tv = te.direction_to_uv(td)
        monkeypatch.setattr(je, "direction_to_uv", lambda d: (
            jnp.asarray(tu.numpy()), jnp.asarray(tv.numpy())))
        jl = je.eval_env_map_dir(jt, jd)
        monkeypatch.undo()
        _close(_np3(tl), _np3(jl))
    jl, jp = je.env_radiance_and_pdf(jt, jd, fast)
    if fast:
        _close(_np3(tl), _np3(jl), same)
        _close(_np3(te.eval_env_map_dir_fast(tt, td)),
               _np3(je.eval_env_map_dir_fast(jt, jd)), same)
    _close(tp, jp, same)
    assert (tp.numpy()[6:64] == 0.0).all()        # past the d.y cut
    assert np.isfinite(tp.numpy()).all() and (tp.numpy() > 0).any()


@pytest.mark.parametrize("fast", [False, True])
def test_env_sample_matches_reference(env_pair, fast, monkeypatch):
    """env_sample on N seeded randoms: the alias picks equal those of the
    reference's formula on its host tables (on >= 99.99% of lanes, in
    fact on all); directions and pdfs rtol 1e-5; the fast route's
    radiance too, the bilinear route's on the same (u, v)."""
    jm, tm, jt, tt = env_pair
    rnd = np.random.default_rng(13).random(N).astype(np.float32)
    rnd[:3] = [0.0, np.float32(1.0) - np.float32(2.0 ** -24), 0.5]
    wh = tt.width * tt.height
    r = rnd * np.float32(wh)
    i = np.minimum(np.floor(r).astype(np.int32), wh - 1)
    if fast:
        pa = tm.prob_alias[i]
        prob = ((pa >> 18) & 0x3FFF).astype(np.float32) * np.float32(
            1.0 / 16383.0)
        alias = (pa & 0x3FFFF).astype(np.int32)
    else:
        prob, alias = tm.prob_table[i], tm.alias_table[i]
    pick = np.where(r - i.astype(np.float32) < prob, i, alias)
    lookup = (lambda i: (tt.prob_table[i], tt.alias_table[i])) if not fast \
        else (lambda i: (((tt.prob_alias[i] >> 18) & 0x3FFF).float()
                         * (1.0 / 16383.0), tt.prob_alias[i] & 0x3FFFF))
    got = te._alias_pick(tt, torch.from_numpy(rnd), lookup).numpy()
    assert (got == pick).mean() >= 0.9999

    tL, tpdf, tli = te.env_sample(tt, torch.from_numpy(rnd), fast)
    jL, jpdf, jli = je.env_sample(jt, jnp.asarray(rnd), fast)
    _close(_np3(tL), _np3(jL))
    _close(tpdf, jpdf)
    if fast:
        _close(_np3(tli), _np3(jli))
    else:
        tu, tv = te.direction_to_uv(tL)
        monkeypatch.setattr(je, "direction_to_uv", lambda d: (
            jnp.asarray(tu.numpy()), jnp.asarray(tv.numpy())))
        _close(_np3(tli), _np3(je.eval_env_map_dir(jt, jL)))
    assert (tpdf.numpy() > 0).all()


def test_decode_rgbe_matches_reference():
    """The RGBE decode of every texel of the file: bit-equal to the
    reference's host decoder (rgbe2float, comp * 2^(e-136) exactly), and
    within rtol 1e-5 of its device decode, whose exp2 on XLA's CPU backend
    is not exact (off by a few ulp for most exponents)."""
    jm, tm = _maps("file")
    tt = tm.device_tables("cpu")
    got = _np3(te._decode_rgbe(tt.packed))
    words = jm.packed.view(np.uint8).reshape(-1, 4)
    _eq(got, jrgbe._rgbe_to_float(words).T)
    _close(got, _np3(je._decode_rgbe(jnp.asarray(jm.packed))))


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------

def _with_env(setup, fast, area):
    """The luxball slice of a test setup with the teapot map on: the
    reference's (scene, params, config) and the port's."""
    import dataclasses
    (js, jp, jc), (ts, tp, tc) = setup[:2]
    jm, tm = _maps("file")
    js = dataclasses.replace(js, env=jm.device_tables())
    jp = jp._replace(env_map_strength=jnp.float32(STRENGTH))
    jc = jc.replace(use_env_map=True, use_area_light=area, fast_env=fast)
    ts = ts._replace(env=tm.device_tables("cpu"))
    tp = tp._replace(env_map_strength=torch.tensor(STRENGTH))
    tc = tc.replace(use_env_map=True, use_area_light=area, fast_env=fast)
    return (js, jp, jc), (ts, tp, tc)


@pytest.mark.parametrize("fast,area", [(True, True), (False, True),
                                       (True, False)],
                         ids=["fast", "alias", "env_only"])
def test_wavefront_slice_with_env_matches_reference(reference_kernels, fast,
                                                    area):
    """4 segments from one reset with the env map on: integer state and
    counters bit-equal, film weight exact, rgb rtol 1e-5 (atol 1e-6)."""
    setup = _wf_setup()
    wr = setup[2]
    (js, jp, jc), (ts, tp, tc) = _with_env(setup, fast, area)
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
    for seg in range(SEGMENTS):
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
        np.testing.assert_array_equal(a["pool"]["last_light_pick"],
                                      b["pool"]["last_light_pick"])
    assert int(jcnt.splatted) > 0 and int(jcnt.shadow) > 0
    pick = a["pool"]["last_light_pick"]
    assert set(np.unique(pick)) <= ({0.5, 1.0} if area else {1.0})
    if area:
        assert (pick == 0.5).any()
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fast", [False, True], ids=["alias", "fast"])
def test_render_sample_with_env_matches_reference(lux, reference_route,
                                                  fast):
    """One megastep sample at 32x16 (depth 5) with the env map and the area
    light, the film holding an earlier sample (as test_torch_mk.py's
    test_render_sample_matches_reference): seeds and RenderStats bit-equal
    (an env and an area shadow ray per NEE), film weight exact, rgb rtol
    1e-5 (atol 1e-6). On the bilinear route one sample alone differs by up
    to ~5e-5 relative on a few env-lit pixels: the lookup multiplies a
    direction's difference by about w / (2 pi), and after three bounces
    through the glass the port's directions differ from XLA's by ~10 ulp
    (as without the env map, where no lookup amplifies it)."""
    w, h = 32, 16
    (js, jp, jc), (ts, tp, tc) = _with_env(_mk_setup(lux, w, h, 5), fast,
                                           True)
    npx = w * h
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
    assert tst.shadow_rays > 0
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    np.testing.assert_allclose(np.stack([c.numpy() for c in tf.color]),
                               np.stack([np.asarray(c) for c in jf.color]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------

def _settings(cls):
    s = cls()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    return s


def test_renderer_load_scene_env_map(tmp_path, capsys):
    """load_scene(env_map=...) switches the env map on with the file's
    tables on the device, as the reference's renderer; settings.
    env_map_name does the same; a missing file prints the reference's
    WARNING and leaves the env map off. The CPU renders on the alias route
    (fast_env off, as the reference off a TPU) and gives a finite film."""
    r = Renderer(64, 36, settings=_settings(Settings),
                 data_dir=str(tmp_path / "port"), device="cpu")
    r.load_scene(LUXBALL, env_map=TEAPOT)
    jr = JRenderer(64, 36, settings=_settings(JSettings),
                   data_dir=str(tmp_path / "ref"))
    jr.load_scene(LUXBALL, env_map=TEAPOT, use_saved_state=False)
    for name in ("use_env_map", "use_area_light", "fast_env"):
        assert getattr(r.config, name) == getattr(jr.config, name), name
    assert r.config.use_env_map and not r.config.fast_env
    env = r.device_scene.env
    _eq(env.packed.numpy().view(np.uint32), jr.scene.envmap.packed)
    _eq(env.pdf_table.numpy(), jr.scene.envmap.pdf_table)
    assert float(r.params.env_map_strength) == 1.0
    r.init_wavefront(2048)
    r.render_wavefront(2)
    film = r.wavefront_film()
    for c in (*film.color, film.weight):
        assert torch.isfinite(c).all()
    assert r.wavefront_stats().shadow_rays > 0

    s = _settings(Settings)
    s.env_map_name = TEAPOT
    r2 = Renderer(32, 16, settings=s, data_dir=str(tmp_path / "port"),
                  device="cpu")
    r2.load_scene(LUXBALL)
    assert r2.config.use_env_map and r2.device_scene.env is not None
    capsys.readouterr()

    missing = str(tmp_path / "absent.hdr")
    r3 = Renderer(32, 16, data_dir=str(tmp_path / "port"), device="cpu")
    r3.load_scene(LUXBALL, env_map=missing)
    lines = capsys.readouterr().out.strip().splitlines()
    # the warning, then the reference's line of the BVH cache
    assert lines[-2] == f"WARNING: env map not found: {missing}"
    assert lines[-1].startswith("BVH cache hit: ")
    assert not r3.config.use_env_map and r3.device_scene.env is None
    s = _settings(Settings)
    s.use_env_map = True
    r3.settings = s
    r3.rebuild_config()                 # no map: the env map stays off
    assert not r3.config.use_env_map
