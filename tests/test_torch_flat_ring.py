"""The port's flat pixel ring against the JAX package, on the CPU.

The flat ring keeps the film in true pixel order, regenerates paths
through one global cursor (an exclusive prefix count over the pool) and
splats by a scatter-add into ``num_pixels + 1`` buckets; under the spp cap
two stable sorts rank each pixel's splatting lanes (the port: one sort
and a scatter back to lane order). ``wf_splat_every`` is accepted and
ignored: the port scatters every segment, where the reference batches K
segments' records into one scatter. The reference runs its trace and resolve kernels in interpret
mode (``reference_kernels``), on ``block_ring=False, backend="mxu"``.

Tolerances: integer state, cursors, counters, ranks, spp and film (and
feature) weights exactly; film and feature rgb rtol 1e-5 (atol 1e-6), the
trace kernels' ulp-level differences on the CPU (test_torch_wavefront.py).
The reference's batched scatter sums a pixel's records in another order
than the port's scatter a segment, so its film is held at the same rtol.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.settings import Settings as JSettings

from fluctus_tpu_torch.core import block_splat as tbs
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.core import pixel_ring as tpr
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

from test_torch_wavefront import (CAM, LIGHT, LUXBALL, H, W, _setup,
                                  reference_kernels)  # noqa: F401

# 2002 lanes: no power of two > 2 divides the pool
PATHS = 2002
RTOL, ATOL = 1e-5, 1e-6


def _numpy(st):
    """A reference WfState as wf_state_from_numpy takes it, the guide
    features included."""
    def v(x):
        return tuple(np.asarray(c) for c in x) if isinstance(x, tuple) \
            else np.asarray(x)
    out = dict(pool={k: v(x) for k, x in st.pool._asdict().items()
                     if x is not None},
               film=dict(color=v(st.film.color),
                         weight=np.asarray(st.film.weight)),
               spp=np.asarray(st.spp), curr_pixel=np.asarray(st.curr_pixel))
    if st.features is not None:
        out["features"] = {k: v(x) for k, x in st.features._asdict().items()}
    return out


def _flat(**kw):
    """The luxball configs of test_torch_wavefront on the flat ring."""
    (js, jp, jc), (ts, tp, tc), wr = _setup()
    return ((js, jp, jc.replace(block_ring=False, **kw)),
            (ts, tp, tc.replace(block_ring=False, **kw)), wr)


def _check_state(tst, jst, seg, film=True):
    """Integer state and cursor bit-equal, spp equal; with ``film`` the
    film weights exactly and rgb at RTOL/ATOL."""
    a, b = twf.wf_state_to_numpy(tst), _numpy(jst)
    for k in ("pixel_index", "seed", "path_len"):
        np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                      err_msg=f"{k}, segment {seg}")
    assert a["curr_pixel"].shape == () == b["curr_pixel"].shape
    np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
    np.testing.assert_array_equal(a["spp"], b["spp"])
    if film:
        np.testing.assert_array_equal(a["film"]["weight"],
                                      b["film"]["weight"])
        np.testing.assert_allclose(np.stack(a["film"]["color"]),
                                   np.stack(b["film"]["color"]), rtol=RTOL,
                                   atol=ATOL)
    return a, b


def test_free_segments_match_reference(reference_kernels):
    """4 free-running segments on a pool of 2002 lanes (which no group
    count divides) from one reset: integer state, the 0-d cursor and the
    counters bit-equal every segment, the film as stated above. No block
    kernel's plain version runs."""
    (js, jp, jc), (ts, tp, tc), wr = _flat()
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_numpy(jst), device="cpu")
    assert tst.curr_pixel.shape == () and tst.spp.shape == (W * H,)
    tbs.K4.plain_runs = tbs.K7.plain_runs = tbs.K8.plain_runs = 0
    for seg in range(4):
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        jst, jcnt = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, _ = _check_state(tst, jst, seg)
    assert int(jcnt.splatted) > 0 and a["film"]["weight"].sum() > 0
    assert (tbs.K4.plain_runs, tbs.K7.plain_runs, tbs.K8.plain_runs) == \
        (0, 0, 0)


def _reference_ranks(key):
    """The reference's exact-admission ranks (integrator_wf.py:462-470),
    its two lax.sorts and the cummax, on a key array."""
    n = key.shape[0]
    lane = jnp.arange(n, dtype=jnp.int32)
    skey, slane = jax.lax.sort((key, lane), num_keys=1)
    pos = jnp.arange(n, dtype=jnp.int32)
    newrun = jnp.concatenate([jnp.ones(1, bool), skey[1:] != skey[:-1]])
    runstart = jax.lax.cummax(jnp.where(newrun, pos, 0))
    _, rank = jax.lax.sort((slane, pos - runstart), num_keys=1)
    return np.asarray(rank)


@pytest.mark.parametrize("n,pixels", [(2002, 7), (4096, 300), (999, 1)])
def test_run_ranks_match_reference(n, pixels):
    """run_ranks against the reference's sorts on seeded keys with many
    ties (a third of the lanes parked at 0x7FFFFFFF, as non-splatting
    lanes are): bit-equal."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, pixels, n).astype(np.int32)
    key[rng.random(n) < 1 / 3] = 0x7FFFFFFF
    got = tpr.run_ranks(torch.from_numpy(key))
    np.testing.assert_array_equal(got.numpy(),
                                  _reference_ranks(jnp.asarray(key)))


def test_capped_segments_match_reference(reference_kernels):
    """6 capped segments (cap 2 from the params) at 32x16 with 2002 lanes,
    about four a pixel, so budgets bind from the second segment: spp,
    counters and integer state bit-equal every segment, film weights equal
    to the spp and to the reference's."""
    w, h, target = 32, 16, 2
    (js, jp, jc), (ts, tp, tc), wr = _flat(width=w, height=h, max_spp=1)
    jp = jp._replace(max_spp=jnp.int32(target))
    tp = tp._replace(max_spp=torch.tensor(target, dtype=torch.int32))
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_numpy(jst), device="cpu")
    capped = 0
    for seg in range(6):
        jst, jcnt = jwf.wf_segment(js, jp, jst, jc)
        tst, tcnt = twf.wf_segment(ts, tp, tst, tc)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, _ = _check_state(tst, jst, seg)
        capped += int((a["spp"] == target).sum())
    assert capped > 0 and a["spp"].max() == target
    np.testing.assert_array_equal(a["film"]["weight"], a["spp"])


def test_denoiser_flat_features(reference_kernels):
    """4 segments with the denoiser on the flat ring: the 8-channel guide
    features scattered as the reference's: weights exactly, albedo and
    normal sums at RTOL/ATOL; the pool's first-diffuse flags equal."""
    (js, jp, jc), (ts, tp, tc), wr = _flat(denoiser=True)
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_numpy(jst), device="cpu")
    for seg in range(4):
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        jst, _ = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, _ = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        a, b = _check_state(tst, jst, seg)
        np.testing.assert_array_equal(a["pool"]["first_diffuse_hit"],
                                      b["pool"]["first_diffuse_hit"])
    fa, fb = a["features"], b["features"]
    for k in ("albedo_w", "normal_w"):
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert fa["normal_w"].sum() > 0 and fa["albedo_w"].sum() > 0
    for k in ("albedo", "normal"):
        np.testing.assert_allclose(np.stack(fa[k]), np.stack(fb[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_deferred_splats_match_reference(reference_kernels):
    """The reference's splat batching against the port's scatter a
    segment: one segment, then 3 with the reference's ``defer_splat`` and
    its ``apply_splats`` of the 3 records, where the port runs its plain
    segments. Integer state, spp and counters bit-equal every segment; the
    films after the batch: weights exactly, rgb at RTOL/ATOL."""
    (js, jp, jc), (ts, tp, tc), wr = _flat()
    jst = jwf.wf_reset(jc, PATHS, world_radius=wr)
    tst = twf.wf_state_from_numpy(_numpy(jst), device="cpu")
    jrec = []
    for seg in range(4):
        defer = seg > 0
        raw, occ = jwf.wf_trace_phase(js, jst.pool, jp, jc)
        out = jwf.wf_shade_phase(js, jp, jst, jc, raw, occ,
                                 defer_splat=defer)
        assert len(out) == (3 if defer else 2)
        raw, occ = twf.wf_trace_phase(ts, tst.pool, tp, tc)
        tst, tcnt = twf.wf_shade_phase(ts, tp, tst, tc, raw, occ)
        jst = out[0]
        assert [int(c) for c in tcnt] == [int(c) for c in out[1]], seg
        if defer:
            jrec.append(out[2])
        _check_state(tst, jst, seg, film=not defer)
    assert sum(int((s < W * H).sum()) for s, _ in jrec) > 0
    jfilm = jwf.apply_splats(jst.film, jnp.stack([s for s, _ in jrec]),
                             jnp.stack([d for _, d in jrec]))
    np.testing.assert_array_equal(tst.film.weight.numpy(),
                                  np.asarray(jfilm.weight))
    np.testing.assert_allclose(
        np.stack([c.numpy() for c in tst.film.color]),
        np.stack([np.asarray(c) for c in jfilm.color]), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("n", [1, 1000, 2002, 3077, 4096])
def test_exclusive_rank_matches_reference(n):
    """The flat raygen's exclusive prefix count (an int32 cumsum) against
    the reference's triangular-matmul exclusive_rank on seeded masks,
    lengths that are and are not powers of two: ranks and total
    bit-equal."""
    rng = np.random.default_rng(n)
    for density in (0.0, 0.3, 1.0):
        mask = rng.random(n) < density
        rank, total = tpr.exclusive_rank(torch.from_numpy(mask))
        jrank, jtotal = jwf.exclusive_rank(jnp.asarray(mask))
        assert rank.dtype == torch.int32
        np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
        assert int(total) == int(jtotal) == int(mask.sum())


# ---------------------------------------------------------------------------
# Renderer level
# ---------------------------------------------------------------------------

def _settings(cls=Settings, **kw):
    s = cls()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    s.max_path_depth = 4
    s.wf_buffer_size = 1024
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _renderer(data_dir, width=16, height=8, **kw):
    """luxball at 16x8 (32 groups of 32 lanes with the 1024-lane pool)."""
    r = Renderer(width, height, settings=_settings(**kw),
                 data_dir=str(data_dir), device="cpu")
    r.load_scene(LUXBALL)
    return r


def test_pool_fallback_to_flat(tmp_path):
    """A pool the config's 32 groups do not divide (1000 lanes) renders on
    the flat ring through init_wavefront and render_single_wavefront (spp =
    weight = N on every pixel), while the config keeps the block ring; a
    wf_buffer_size that no power of two > 1 divides derives a flat
    config."""
    r = _renderer(tmp_path)
    assert r.config.block_ring and r.config.groups == 32
    r.init_wavefront(1000)
    assert not r._wf_cfg.block_ring and r.config.block_ring
    r.render_wavefront(3)
    st = r.wavefront_stats()
    film = r.wavefront_film()
    assert film.weight.shape == (16 * 8,)
    assert float(film.weight.sum()) == st.samples > 0
    assert all(torch.isfinite(c).all() for c in film.color)
    for n in (2, 4):
        film = r.render_single_wavefront(2, num_tasks=1000, accumulate=True)
        assert not r._wf_cfg.block_ring and r._wf_cfg.max_spp == 1
        assert (r._wf_state.spp == n).all() and (film.weight == n).all()
    r.render_single_wavefront(2, num_tasks=1024)
    assert r._wf_cfg.block_ring

    odd = _renderer(tmp_path, wf_buffer_size=1001)
    assert not odd.config.block_ring
    film = odd.render_single(2)
    assert (film.weight == 2).all() and (odd._wf_state.spp == 2).all()


def _free_film(r, segments, num_tasks=1024):
    """The film and counters of ``segments`` free-running segments from a
    fresh pool, rendered with sync=False: the film's weights sum to the
    counted samples."""
    r.init_wavefront(num_tasks)
    r.render_wavefront(segments, sync=False)
    stats, film = r.wavefront_stats(), r.wavefront_film()
    assert float(film.weight.sum()) == stats.samples > 0
    return film, stats


def _assert_films_equal(a, b):
    np.testing.assert_array_equal(a.weight.numpy(), b.weight.numpy())
    np.testing.assert_array_equal(np.stack([c.numpy() for c in a.color]),
                                  np.stack([c.numpy() for c in b.color]))


def test_splat_every_gives_the_unbatched_film(tmp_path):
    """wf_splat_every = 3 on the flat ring (7 segments, sync=False) and on
    the block ring renders K = 1's film, bit for bit, and its counters:
    the switch is accepted and ignored."""
    for flat in (True, False):
        films = [_free_film(_renderer(tmp_path, wf_block_ring=not flat,
                                      wf_splat_every=k), 7)
                 for k in (1, 3)]
        assert films[0][1] == films[1][1]
        _assert_films_equal(films[1][0], films[0][0])


def test_flat_checkpoint_round_trip_and_resume(tmp_path):
    """A flat-ring exact render of 2 spp, checkpointed, restored into a
    fresh flat Renderer and continued by 2 more: spp = weight = 4 on every
    pixel. The checkpoint's arrays load into the reference's Renderer (the
    flat ring on its CPU) as into ours, each into a fresh flat pool: film
    and spp equal. A free-running flat run (sync=False) is checkpointed
    with every counted sample, and restoring a checkpoint replaces its
    film."""
    r = _renderer(tmp_path, wf_block_ring=False)
    r.render_single(2)
    ck = r.save_checkpoint(str(tmp_path / "flat.npz"))
    z = np.load(ck)
    assert (z["spp"] == 2).all() and (z["weight"] == 2).all()

    r2 = _renderer(tmp_path, wf_block_ring=False)
    assert r2.load_checkpoint(ck)
    film = r2.render_single(2)
    assert not r2._wf_cfg.block_ring
    assert (film.weight == 4).all() and (r2._wf_state.spp == 4).all()

    jr = JRenderer(16, 8, settings=_settings(JSettings),
                   data_dir=str(tmp_path / "ref"))
    jr.load_scene(LUXBALL)
    jr.init_wavefront(1000)
    assert not jr._wf_cfg.block_ring
    assert jr.load_checkpoint(ck)
    r3 = _renderer(tmp_path, wf_block_ring=False)
    r3.init_wavefront(1000)
    assert r3.load_checkpoint(ck)
    np.testing.assert_array_equal(r3._wf_state.spp.numpy(),
                                  np.asarray(jr._wf_state.spp))
    np.testing.assert_array_equal(r3._wf_state.film.weight.numpy(),
                                  np.asarray(jr._wf_state.film.weight))
    np.testing.assert_array_equal(r3._wf_state.film.color.y.numpy(),
                                  np.asarray(jr._wf_state.film.color.y))

    f = _renderer(tmp_path, wf_block_ring=False)
    f.init_wavefront(1000)
    f.render_wavefront(6, sync=False)
    z = np.load(f.save_checkpoint(str(tmp_path / "free.npz")))
    assert z["weight"].sum() == f.wavefront_stats().samples > 0
    f.render_wavefront(2, sync=False)
    assert f.load_checkpoint(ck)
    assert (f.wavefront_film().weight == 2).all()


@pytest.mark.parametrize("var,value", [("FLT_BLOCK_RING", "0"),
                                       ("FLT_SPLAT_EVERY", "4")])
def test_env_overrides_are_honoured(tmp_path, monkeypatch, var, value):
    """FLT_BLOCK_RING=0 puts the derived config on the flat ring over
    Settings.wf_block_ring; FLT_SPLAT_EVERY=4 is accepted and ignored, as
    Settings.wf_splat_every is: a flat run (1000 lanes, which the 32 groups
    do not divide) renders the film and counters it renders without it,
    bit for bit."""
    monkeypatch.setenv(var, value)
    r = _renderer(tmp_path)
    film, stats = _free_film(r, 3, num_tasks=1000)
    assert not r._wf_cfg.block_ring
    assert r.config.block_ring == (var != "FLT_BLOCK_RING")
    monkeypatch.delenv(var)
    plain = _renderer(tmp_path)
    assert plain.config.block_ring
    pfilm, pstats = _free_film(plain, 3, num_tasks=1000)
    if var == "FLT_SPLAT_EVERY":
        assert stats == pstats
        _assert_films_equal(film, pfilm)
