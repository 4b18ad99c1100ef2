"""The port's exact-spp slice against the JAX package:

  K7 plain version    vs ``splat(..., remaining=..., interpret=True)`` (the
                      segment-sum reference) and ``pallas_interpret=True``
                      (the capped kernel body): weight channel and admitted
                      counts exact, rgb rtol 2^-16
  K7 design           a numpy model of csrc/block_splat_capped.cu's
                      counting sort, step for step, vs the plain version
                      on edge-case groups: bit-equal
  K8 plain version   vs ``fetch(..., interpret=True)``: exact
  K8 design           a numpy model of csrc/fetch.cu's lane mapping
                      (chunks per thread, the striding grid, the scalar
                      loop) vs the plain version: bit-equal
  wf_segment          6 capped segments on luxball from one reset, the cap
                      binding: integer state, spp and counters bit-equal,
                      film weight exact, rgb rtol 1e-5 (atol 1e-6)
  render_single_wavefront
                      spp == weight == N on every pixel, ``accumulate``
                      continues to 2N, ``render_wavefront`` re-inits
  save_hdr            the same bytes as the reference's writer

The reference runs its Pallas kernels in interpret mode, with its dispatch
routed to the rays-on-lanes trace, the B16 resolve, the segment-sum splat
and the reference fetch (a test-only monkeypatch)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import image_io as jimage_io
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

from fluctus_tpu_torch import kernel_build as kb
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import block_splat as tbs
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.core.trace import DeviceScene as TDeviceScene
from fluctus_tpu_torch.geom import (AreaLight as TAreaLight,
                                    Camera as TCamera,
                                    PostProcessParams as TPP,
                                    RenderConfig as TConfig,
                                    RenderParams as TParams)
from fluctus_tpu_torch.image_io import save_hdr
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")
CAM = dict(pos=(0.0, 1.6, 4.5), dir=(0.0, -0.12, -1.0), up=(0.0, 1.0, 0.0),
           right=(1.0, 0.0, 0.0), fov=60.0)
LIGHT = dict(pos=(0.0, 4.0, 0.0), N=(0.0, -1.0, 0.0), right=(1.0, 0.0, 0.0),
             up=(0.0, 0.0, 1.0), E=(50.0, 50.0, 50.0), size=(0.5, 0.5))


def _splat_inputs(seed):
    """Capped-splat inputs with many collisions: 4 groups of 64 lanes,
    Pk = 128, candidates on 6 pixels per group, budgets 0-4."""
    rng = np.random.default_rng(seed)
    g, s, pk, c = 4, 64, 128, 4
    local = rng.integers(0, 6, g * s).astype(np.int32)
    local[rng.random(g * s) < 0.3] = -1
    data = rng.random((c, g * s)).astype(np.float32)
    data[3] = 1.0                        # weight channel: real splats are 1
    data[:, local < 0] = 0.0
    film = rng.random((c, g * pk)).astype(np.float32)
    film[3] = rng.integers(0, 5, g * pk)
    remaining = rng.integers(0, 5, (1, g * pk)).astype(np.float32)
    return g, s, pk, local, data, film, remaining


@pytest.mark.parametrize("body", ["segment_sum", "pallas_interpret"])
def test_k7_splat_capped(body):
    """K7's plain version vs the reference's capped splat: the weight
    channel exact, each pixel's admitted count min(count, remaining)
    exactly, rgb rtol 2^-16 (the kernel body's two-pass bf16 products and
    the segment sum's order)."""
    g, s, pk, local, data, film, rem = _splat_inputs(4)
    kw = dict(interpret=True) if body == "segment_sum" else dict(
        pallas_interpret=True)
    ref = np.asarray(jbs.splat(jnp.asarray(local), jnp.asarray(data),
                               jnp.asarray(film), groups=g,
                               remaining=jnp.asarray(rem), **kw))
    tbs.K7.plain_runs = 0
    got = tbs.splat(torch.from_numpy(local), torch.from_numpy(data),
                    torch.from_numpy(film), groups=g,
                    remaining=torch.from_numpy(rem)).numpy()
    assert tbs.K7.plain_runs == 1
    np.testing.assert_array_equal(got[3], ref[3])
    count = np.zeros(g * pk)
    for lane in np.nonzero(local >= 0)[0]:
        count[(lane // s) * pk + local[lane]] += 1
    admitted = got[3] - film[3]
    np.testing.assert_array_equal(admitted, np.minimum(count, rem[0]))
    assert (count > rem[0]).any() and (admitted > 0).any()
    np.testing.assert_allclose(got[:3], ref[:3], rtol=2.0 ** -16, atol=0)


SPLAT_THREADS = 256  # splat_sort.cuh: lanes per pass, one per thread


def _splat_sort_model(local, data, film, groups, remaining=None):
    """csrc/splat_sort.cuh (K4, or K7 when ``remaining`` is given) step
    for step, in numpy: per group (1) the data staged, (2) each pixel's
    candidates counted, (3) an exclusive scan of the counts, (4) each
    lane's rank from __match_any_sync within its warp, the per-warp
    per-pixel counts of the lower warps and the running count of the
    earlier passes, (5) the stable scatter to offset + rank, (6) per pixel
    its candidates — all of them, or K7's admitted prefix, ranks r < count
    with f32(r) < remaining — summed in f32 from 0.0 in slot order, added
    to the film."""
    c, n = data.shape
    s = n // groups
    pk = film.shape[1] // groups
    out = film.copy()
    for g in range(groups):
        loc = local[g * s:(g + 1) * s]
        dat = data[:, g * s:(g + 1) * s]                         # (1)
        cand = (loc >= 0) & (loc < pk)
        off = np.zeros(pk + 1, np.int64)
        np.add.at(off, loc[cand] + 1, 1)                         # (2)
        off = np.cumsum(off)                                     # (3)
        run = np.zeros(pk, np.int64)
        slots = np.full(s, -1, np.int64)
        for l0 in range(0, s, SPLAT_THREADS):
            lanes = l0 + np.arange(SPLAT_THREADS)
            key = np.full(SPLAT_THREADS, -1, np.int64)
            live = lanes < s
            key[live] = np.where(cand[lanes[live]], loc[lanes[live]], -1)
            tbl = np.zeros((SPLAT_THREADS // 32, pk), np.int64)
            rank = np.zeros(SPLAT_THREADS, np.int64)
            first = np.zeros(SPLAT_THREADS, bool)
            width = np.zeros(SPLAT_THREADS, np.int64)
            for t in range(SPLAT_THREADS):                       # (4)
                w, ln = divmod(t, 32)
                warp = key[w * 32:(w + 1) * 32]
                same = warp == key[t]                            # match_any
                below = int(same[:ln].sum())
                rank[t], width[t] = below, int(same.sum())
                first[t] = key[t] >= 0 and below == 0
                if first[t]:
                    tbl[w, key[t]] = width[t]
            for t in np.nonzero(key >= 0)[0]:                    # (5)
                p, w = key[t], t // 32
                r = run[p] + rank[t] + tbl[:w, p].sum()
                slots[off[p] + r] = lanes[t]
            for t in np.nonzero(first)[0]:
                run[key[t]] += width[t]
        for p in range(pk):                                      # (6)
            o, cnt = off[p], off[p + 1] - off[p]
            k = cnt
            if remaining is not None:
                rem = np.float32(remaining[0, g * pk + p])
                k = 0
                while k < cnt and np.float32(k) < rem:
                    k += 1
            acc = np.zeros(c, np.float32)
            for r in range(k):
                acc = acc + dat[:, slots[o + r]]
            out[:, g * pk + p] = film[:, g * pk + p] + acc
    return out


def _k7_groups(layout, budget, seed=11):
    """Groups of 256 lanes (one pass) or 640 (three passes, the last
    partial), Pk = 512, from a numpy seed: every lane on one pixel, every
    lane on its own pixel, a third of the lanes with local = -1 and the
    rest on a few pixels, every lane empty, or random pixels; data normal
    with some -0.0, the budget on every pixel (NaN included)."""
    rng = np.random.default_rng(seed)
    g, pk, c = 3, 512, 4
    s = 640 if layout == "random_3_passes" else 256
    if layout == "one_pixel":
        local = np.tile(rng.integers(0, pk, g)[:, None], (1, s))
    elif layout == "own_pixel":
        local = np.stack([rng.permutation(pk)[:s] for _ in range(g)])
    elif layout == "empty_lanes":
        local = rng.integers(0, 5, (g, s))
        local[rng.random((g, s)) < 1 / 3] = -1
    elif layout == "all_empty":
        local = np.full((g, s), -1)
    else:
        local = rng.integers(0, 40, (g, s))
        local[rng.random((g, s)) < 0.1] = -1
    local = local.reshape(-1).astype(np.int32)
    data = rng.normal(size=(c, g * s)).astype(np.float32)
    data[rng.random((c, g * s)) < 0.05] = -0.0
    film = rng.normal(size=(c, g * pk)).astype(np.float32)
    remaining = np.full((1, g * pk), budget, np.float32)
    return g, local, data, film, remaining


@pytest.mark.parametrize("budget", [0.0, 1.0, 2.5, 255.0, 1e30, np.nan])
@pytest.mark.parametrize("layout", ["one_pixel", "own_pixel", "empty_lanes",
                                    "random_3_passes"])
def test_k7_counting_sort_matches_plain(layout, budget):
    """The redesigned K7 (a stable counting sort per group, O(s + pk)),
    modelled step for step, equals splat_capped_plain bit for bit."""
    g, local, data, film, rem = _k7_groups(layout, budget)
    ref = tbs.splat_capped_plain(torch.from_numpy(local),
                                 torch.from_numpy(data),
                                 torch.from_numpy(film), g,
                                 torch.from_numpy(rem)).numpy()
    got = _splat_sort_model(local, data, film, g, rem)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    admitted = (got != film).any(axis=0).sum()
    if budget >= 1.0:
        assert admitted > 0
    elif not budget > 0.0:
        assert admitted == 0


@pytest.mark.parametrize("layout", ["one_pixel", "own_pixel", "empty_lanes",
                                    "random_3_passes", "all_empty"])
def test_k4_counting_sort_matches_plain(layout):
    """The redesigned K4 (the counting sort K7 shares, every candidate
    admitted), modelled step for step, equals splat_plain bit for bit."""
    g, local, data, film, _ = _k7_groups(layout, 0.0)
    ref = tbs.splat_plain(torch.from_numpy(local), torch.from_numpy(data),
                          torch.from_numpy(film), g).numpy()
    got = _splat_sort_model(local, data, film, g)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    changed = (got != film).any(axis=0).sum()
    assert (changed == 0) == (layout == "all_empty")


def test_k8_fetch():
    """K8's plain version vs the reference fetch: exact."""
    rng = np.random.default_rng(5)
    g, s, pk = 4, 32, 128
    local = rng.integers(0, pk, g * s).astype(np.int32)
    table = rng.integers(0, 1 << 20, (1, g * pk)).astype(np.float32)
    ref = np.asarray(jbs.fetch(jnp.asarray(local), jnp.asarray(table),
                               groups=g, interpret=True))
    got = tbs.fetch(torch.from_numpy(local), torch.from_numpy(table),
                    groups=g).numpy()
    np.testing.assert_array_equal(got, ref)


def _fetch_model(local, table, groups, lanes, cap, threads=256,
                 aligned=True):
    """csrc/fetch.cu step for step, on numpy arrays: the launcher's choice
    of the chunked loop (s a multiple of ``lanes``, pointers aligned) and
    its grid (min(ceil(work / threads), cap) CTAs, ``cap`` standing for
    the resident CTAs of the card); then per thread, the chunked loop
    (chunk c = thread id, then + stride; its group c // (s // lanes); the
    next chunk's locals read before this chunk's table reads; an unsigned
    compare against pk) or the scalar loop (lane i = thread id, then +
    stride; its group i // s). Counts the writes of every lane."""
    n = local.size
    s = n // groups
    pk = table.shape[1] // groups
    out = np.full(n, np.nan, np.float32)
    writes = np.zeros(n, np.int32)
    vec = s % lanes == 0 and aligned
    work = n // lanes if vec else n
    stride = min(-(-work // threads), cap) * threads

    def read(l, row):
        ok = l.astype(np.uint32) < np.uint32(pk)
        return np.where(ok, table[0, row + np.where(ok, l, 0)],
                        np.float32(0.0))
    for t in range(stride):
        if not vec:
            for i in range(t, n, stride):
                out[i] = read(local[i:i + 1], (i // s) * pk)[0]
                writes[i] += 1
            continue
        c = t
        if c >= work:
            continue
        cpg = s // lanes
        l = local[c * lanes:(c + 1) * lanes]
        while True:
            nxt = c + stride
            ln = local[nxt * lanes:(nxt + 1) * lanes] if nxt < work else None
            out[c * lanes:(c + 1) * lanes] = read(l, (c // cpg) * pk)
            writes[c * lanes:(c + 1) * lanes] += 1
            if nxt >= work:
                break
            c, l = nxt, ln
    assert (writes == 1).all()
    return out, vec


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("groups,s,pk,cap,aligned", [
    (7, 256, 512, 1, True),     # 448 chunks of 4 over a stride of 256
    (16, 256, 512, 3, True),    # 1,024 chunks of 4 over 768 threads
    (7, 255, 512, 1, True),     # s odd: the scalar loop
    (300, 3, 128, 2, True),     # s = 3: chunks of 1 only
    (5, 256, 128, 1, False)])   # unaligned pointers: the scalar loop
def test_k8_lane_mapping_matches_plain(lanes, groups, s, pk, cap, aligned):
    """The redesigned K8's lane mapping (chunks of ``lanes`` lanes per
    thread, one wave of CTAs striding over them, the scalar loop for
    other shapes), modelled step for step, writes every lane once and
    equals fetch_plain bit for bit, locals -1 and pk included."""
    rng = np.random.default_rng(groups * s + lanes)
    n = groups * s
    local = rng.integers(-2, pk + 2, n).astype(np.int32)
    local[:4] = [-1, pk, 0, pk - 1]
    table = rng.normal(size=(1, groups * pk)).astype(np.float32)
    got, vec = _fetch_model(local, table, groups, lanes, cap,
                            aligned=aligned)
    ref = tbs.fetch_plain(torch.from_numpy(local), torch.from_numpy(table),
                          groups).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert vec == (s % lanes == 0 and aligned)
    assert (got[(local < 0) | (local >= pk)] == 0.0).all()


@pytest.fixture
def reference_kernels(monkeypatch):
    """Route the JAX package's kernel dispatch to its interpret-mode
    production kernels and its block splat/fetch to their references."""
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
    splat, fetch = jbs.splat, jbs.fetch
    monkeypatch.setattr(jmt, "_dispatch_trace", rol_dispatch)
    monkeypatch.setattr(jmt, "resolve_hits_mxu", resolve_v5)
    monkeypatch.setattr(jbs, "splat",
                        lambda *a, **k: splat(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jbs, "fetch",
                        lambda *a, **k: fetch(*a, **{**k, "interpret": True}))


def _jax_state_to_numpy(st):
    def v(x):
        return tuple(np.asarray(c) for c in x) if isinstance(x, tuple) \
            else np.asarray(x)
    pool = {k: v(x) for k, x in st.pool._asdict().items() if x is not None}
    return dict(pool=pool, film=dict(color=v(st.film.color),
                                     weight=np.asarray(st.film.weight)),
                spp=np.asarray(st.spp), curr_pixel=np.asarray(st.curr_pixel))


def test_exact_segments_match_reference(reference_kernels):
    """6 segments of the capped wavefront (max_spp gate on, cap value 2 from
    the params) at 32x16 with 2048 paths in 16 groups — four lanes per
    pixel, so budgets bind from the second segment — from one reset."""
    w, h, paths, groups, target = 32, 16, 2048, 16, 2
    s = JScene()
    s.load_model(LUXBALL)
    p, n, uv, mid = s.triangle_arrays()
    bvh = jbuild_bvh(p)
    host, st = jmt.MXUScene.build(p, bvh, normals=n, uvs=uv, mat_ids=mid,
                                  materials=s.materials, return_host=True)
    types = s.material_types
    wr = s.world_radius()
    js = JDeviceScene(
        tris=TrianglesDevice.from_arrays(p, n, uv, mid),
        bvh=BVHDevice.from_host(bvh), mats=materials_to_soa(s.materials),
        atlas=pack_atlas([]), env=None, material_types=types,
        mxu=jmt.MXUScene._from_host(host, st))
    jp = JParams(camera=JCamera.make(**CAM),
                 area_light=JAreaLight.make(**LIGHT),
                 env_map_strength=jnp.float32(1.0),
                 world_radius=jnp.float32(wr),
                 pp=JPP(jnp.float32(1.0), jnp.int32(2)),
                 max_spp=jnp.int32(target))
    jc = JConfig(width=w, height=h, max_bounces=10, use_env_map=False,
                 use_area_light=True, max_spp=1, material_types=types,
                 backend="mxu", block_ring=True, groups=groups)
    ts = TDeviceScene(mxu=tmt.tables_from_numpy(host, st, "cpu"),
                      material_types=types)
    tp = TParams(camera=TCamera.make(**CAM, device="cpu"),
                 area_light=TAreaLight.make(**LIGHT, device="cpu"),
                 world_radius=torch.tensor(wr, dtype=torch.float32),
                 pp=TPP(torch.tensor(1.0), 2),
                 max_spp=torch.tensor(target, dtype=torch.int32))
    tc = TConfig(width=w, height=h, max_bounces=10, max_spp=1,
                 material_types=types, groups=groups)
    jst = jwf.wf_reset(jc, paths, world_radius=wr)
    tst = twf.wf_state_from_numpy(_jax_state_to_numpy(jst), device="cpu")
    kb.reset_counts()
    capped = 0
    for seg in range(6):
        jst, jcnt = jwf.wf_segment(js, jp, jst, jc)
        tst, tcnt = twf.wf_segment(ts, tp, tst, tc)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _jax_state_to_numpy(jst)
        for k in ("pixel_index", "seed", "path_len"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k],
                                          err_msg=f"{k}, segment {seg}")
        np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
        np.testing.assert_array_equal(a["spp"], b["spp"])
        capped += int((a["spp"] == target).sum())
    assert (tbs.K7.plain_runs, tbs.K8.plain_runs, tbs.K4.plain_runs) == (
        6, 6, 0)
    live = a["spp"] < (1 << 29)
    assert capped > 0 and a["spp"][live].max() == target
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_array_equal(a["film"]["weight"][live], a["spp"][live])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


def test_render_single_wavefront_contract(tmp_path):
    """Renderer(device="cpu") at 16x8 with 1024 paths: render_single (the
    exact-spp wavefront) gives spp == weight == 2 on every pixel, a second
    call accumulates to 4 exactly, and render_wavefront afterwards re-inits
    with the cap off and splats (the reference's contract,
    tests/test_render_single_wf.py:41-62). The .hdr output is written."""
    s = Settings()
    s.camera.pos, s.camera.dir = CAM["pos"], CAM["dir"]
    a = s.area_light
    a.pos, a.N, a.right, a.up = (LIGHT["pos"], LIGHT["N"], LIGHT["right"],
                                 LIGHT["up"])
    a.E, a.size = LIGHT["E"], LIGHT["size"]
    s.wf_buffer_size = 1024
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path), device="cpu")
    r.load_scene(LUXBALL)
    for n in (2, 4):
        film = r.render_single(2)
        assert r._wf_cfg.max_spp == 1
        spp = twf.unpad_pixels(r._wf_state.spp, r.config)
        assert (spp == n).all() and (film.weight == n).all()
        assert r.stats.samples == n * 16 * 8
        assert r.current_film() is r.film
    assert np.isfinite(r.hdr_image()).all()
    path = tmp_path / "lux.hdr"
    r.save_image(str(path))
    assert path.read_bytes().startswith(b"#?RADIANCE\n")
    r.render_wavefront(2)
    assert r._wf_cfg.max_spp == 0 and not r._wf_exact_mode
    assert float(r.current_film().weight.sum()) > 0
    r.render_wavefront(1)                   # continues: no second re-init
    assert len(r._wf_counters) == 3


def test_save_hdr_matches_reference_writer(tmp_path):
    """save_hdr writes the reference writer's bytes (header, flat RGBE,
    zero pixels and the bright tail included)."""
    rng = np.random.default_rng(6)
    img = (rng.random((5, 7, 3)) ** 4 * 50).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 2] = (1e-33, 2.0, 1e4)
    save_hdr(str(tmp_path / "port.hdr"), img)
    jimage_io.save_hdr(str(tmp_path / "ref.hdr"), img)
    assert (tmp_path / "port.hdr").read_bytes() == \
        (tmp_path / "ref.hdr").read_bytes()
