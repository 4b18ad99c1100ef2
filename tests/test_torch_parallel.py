"""The port's sharding (fluctus_tpu_torch/parallel/) against the JAX
package and against its own local simulation, on the CPU.

- One shard's wavefront segments (``wf_segment(pixel_base=k*L)`` on shard
  k's slice of one reset) against the JAX package's, run as
  tests/test_wf_sharded.py runs them, on both packages' mxu_block_scene
  (block ring) and quad_scene (flat ring; the port's on its tables, the
  reference's through its BVH), free-running and under the spp cap, and
  quad_scene through the BVH in both packages on both rings (the
  ``_bvh`` rings), for every shard k; tolerances of
  test_torch_wavefront.py.
- 2 and 4 gloo processes (tests/torch_parallel_ranks.py): the sharded
  wavefront is bit-equal to the local simulation and its reduced counters
  equal the sums; the sharded megastep is bit-equal to the unsharded
  render_sample, on the tables and through the BVH (the counterpart of
  tests/test_mk_sharded.py:32-84); every step issues exactly one
  all_reduce, of 4 scalars.
- The sliced render_sample, host_mesh_layout, init_distributed,
  shard_wf_state's errors and the test scenes' tables.

The JAX package's Pallas kernels run in interpret mode (the
``reference_kernels`` fixture of test_torch_wavefront.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import testing as jtesting
from fluctus_tpu.core import integrator_wf as jwf
from fluctus_tpu.parallel import distributed as jdistributed

from fluctus_tpu_torch import testing as ttesting
from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.core import integrator_mk as tmk
from fluctus_tpu_torch.core import integrator_wf as twf
from fluctus_tpu_torch.parallel import distributed as tdistributed
from fluctus_tpu_torch.parallel import make_mesh

import torch_parallel_ranks as ranks
from test_torch_wavefront import _jax_state_to_numpy
from test_torch_wavefront import reference_kernels  # noqa: F401

WORLDS = (2, 4)
SHARDS = 4                 # the per-shard parity's mesh size
JOIN_TIMEOUT = 150         # seconds for a group's ranks to finish
_jax_segment = jax.jit(jwf.wf_segment,
                       static_argnames=("config", "first_iteration"))


def _jax_setup(ring):
    """The JAX package's counterpart of ranks.wf_setup(ring): its
    quad_scene traces through its BVH on every flat ring."""
    if ring.endswith("bvh"):
        scene = jtesting.quad_scene()
        params, config = jtesting.quad_setup(
            *ranks.FLAT_SIZE, max_bounces=2, use_area_light=True,
            block_ring=ring.startswith("block"), groups=ranks.BVH_GROUPS)
        tasks = ranks.FLAT_TASKS
    elif ring.startswith("block"):
        scene, params, config = jtesting.mxu_block_scene(
            num_tasks=ranks.BLOCK_TASKS)
        tasks = ranks.BLOCK_TASKS
    else:
        scene = jtesting.quad_scene()
        params, config = jtesting.quad_setup(*ranks.FLAT_SIZE,
                                             max_bounces=2,
                                             use_area_light=True)
        tasks = ranks.FLAT_TASKS
    if ring.endswith("capped"):
        config = config.replace(max_spp=1)
        params = params._replace(max_spp=jnp.int32(ranks.CAP_SPP))
    return scene, params, config, tasks


def _shard_numpy(st, k, d):
    """Shard k of d of a numpy state dict (_jax_state_to_numpy's)."""
    def cut(a):
        if isinstance(a, tuple):
            return tuple(cut(c) for c in a)
        m = a.shape[0] // d
        return a[k * m:(k + 1) * m]
    curr = st["curr_pixel"]
    return dict(pool={f: cut(a) for f, a in st["pool"].items()},
                film=dict(color=cut(st["film"]["color"]),
                          weight=cut(st["film"]["weight"])),
                spp=cut(st["spp"]),
                curr_pixel=cut(curr) if curr.ndim else np.zeros((), np.int32))


def _jax_state(st):
    """A JAX WfState from a numpy state dict."""
    v = lambda x: jwf.Vec3(*(jnp.asarray(c) for c in x)) \
        if isinstance(x, tuple) else jnp.asarray(x)
    pool = jwf.WfPool(**{f: v(a) for f, a in st["pool"].items()})
    film = jwf.Film(color=v(st["film"]["color"]),
                    weight=v(st["film"]["weight"]))
    return jwf.WfState(pool=pool, film=film, spp=v(st["spp"]),
                       curr_pixel=v(st["curr_pixel"]))


@pytest.mark.parametrize("k", range(SHARDS))
@pytest.mark.parametrize("ring", ranks.RINGS)
def test_shard_segments_match_reference(reference_kernels, ring, k):
    """Shard k of SHARDS: ranks.SEGMENTS segments of the port's wf_segment
    with pixel_base = k*L from the shard's slice of the JAX package's
    reset, against the JAX package's wf_segment with the same pixel_base.
    Counters, pixel_index, seed, path_len, the cursors, spp and film
    weight equal; rgb rtol 1e-5 (atol 1e-6)."""
    js, jp, jc, tasks = _jax_setup(ring)
    ts, tp, tc, _ = ranks.wf_setup(ring)
    st0 = _jax_state_to_numpy(jwf.wf_reset(
        jc, tasks, world_radius=float(jp.world_radius)))
    local = _shard_numpy(st0, k, SHARDS)
    base = k * (st0["film"]["weight"].shape[0] // SHARDS)
    jst = _jax_state(local)
    tst = twf.wf_state_from_numpy(local, device="cpu")
    for seg in range(ranks.SEGMENTS):
        jst, jcnt = _jax_segment(js, jp, jst, jc,
                                 pixel_base=jnp.int32(base))
        tst, tcnt = twf.wf_segment(ts, tp, tst, tc, pixel_base=base)
        assert [int(c) for c in tcnt] == [int(c) for c in jcnt], seg
        a, b = twf.wf_state_to_numpy(tst), _jax_state_to_numpy(jst)
        for f in ("pixel_index", "seed", "path_len"):
            np.testing.assert_array_equal(a["pool"][f], b["pool"][f],
                                          err_msg=f"{f}, segment {seg}")
        np.testing.assert_array_equal(a["curr_pixel"], b["curr_pixel"])
    pid = a["pool"]["pixel_index"]
    span = a["spp"].shape[0]
    assert ((pid >= base) & (pid < base + span)).all()
    assert int(b["film"]["weight"].sum()) > 0
    np.testing.assert_array_equal(a["spp"], b["spp"])
    np.testing.assert_array_equal(a["film"]["weight"], b["film"]["weight"])
    np.testing.assert_allclose(np.stack(a["film"]["color"]),
                               np.stack(b["film"]["color"]), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module", params=WORLDS)
def sharded(request, tmp_path_factory):
    """(world, each rank's results) of ranks.rank_body in a gloo group of
    ``world`` processes."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo{world}")
    return world, ranks.launch(ranks.rank_body, world, tmp, JOIN_TIMEOUT)


def _assert_local_simulation(state, ring, world):
    """A gathered wavefront state (film, spp, cursors) bit-equal to the
    same shards' segments run one after another in this process. Returns
    the local simulation."""
    color, weight = state[1]
    spp, curr = state[2:4]
    local = ranks.local_wf(ring, world)
    cat = lambda get: np.concatenate([get(st).numpy() for st, _ in local])
    for c in range(3):
        np.testing.assert_array_equal(color[c],
                                      cat(lambda st: st.film.color[c]))
    np.testing.assert_array_equal(weight, cat(lambda st: st.film.weight))
    assert weight.sum() > 0
    np.testing.assert_array_equal(spp, cat(lambda st: st.spp))
    if ring.startswith("flat"):         # one cursor per rank
        np.testing.assert_array_equal(
            curr, [int(st.curr_pixel) for st, _ in local])
    else:
        np.testing.assert_array_equal(curr, cat(lambda st: st.curr_pixel))
    return local


@pytest.mark.parametrize("ring", ranks.RINGS)
def test_wf_sharded_equals_local_simulation(sharded, ring):
    """The gathered film (rgb, weight), spp and cursors of the sharded
    segments bit-equal the same shards' segments run one after another in
    this process; the reduced counters of every segment equal the sums of
    the local ones."""
    world, res = sharded
    assert [r["shard"] for r in res] == list(range(world))
    assert all(r[ring]["state"] is None for r in res[1:])
    local = _assert_local_simulation(res[0][ring]["state"], ring, world)
    sums = np.sum([cnt for _, cnt in local], axis=0)
    for r in res:
        np.testing.assert_array_equal(r[ring]["counters"], sums)


def _unsharded_mk(route="tables"):
    """ranks.MK_STEPS samples of the unsharded render_sample of
    ranks.mk_setup(route): (film, seeds, the stats of each step)."""
    scene, params, config = ranks.mk_setup(route)
    n = config.num_pixels
    film, seed = tmk.Film.zeros(n, "cpu"), torch.arange(n, dtype=torch.int64)
    stats = []
    for _ in range(ranks.MK_STEPS):
        film, seed, st = tmk.render_sample(scene, params, film, seed, config)
        stats.append(list(st))
    return film, seed, stats


def _assert_unsharded(got, film, seed):
    """A gathered megastep film and seeds bit-equal to the unsharded."""
    (color, weight), got_seed = got
    for c in range(3):
        np.testing.assert_array_equal(color[c], film.color[c].numpy())
    np.testing.assert_array_equal(weight, film.weight.numpy())
    np.testing.assert_array_equal(got_seed, seed.numpy())


def test_mk_sharded_equals_unsharded(sharded):
    """ranks.MK_STEPS sharded megastep samples: the gathered film and seeds
    bit-equal the unsharded render_sample's, and every rank's reduced
    stats equal the unsharded stats of each step."""
    world, res = sharded
    film, seed, stats = _unsharded_mk()
    _assert_unsharded(res[0]["mk"]["film"], film, seed)
    for r in res:
        assert r["mk"]["stats"] == stats


def test_mk_sharded_bitstack_equals_unsharded(sharded):
    """The sharded megastep on quad_scene through its BVH (each ray's trace
    independent of every other ray's): the gathered film and seeds
    bit-equal the unsharded render_sample's, every rank's reduced stats
    the unsharded stats of each step."""
    world, res = sharded
    film, seed, stats = _unsharded_mk("bvh")
    assert film.weight.sum() > 0
    _assert_unsharded(res[0]["mk_bvh"]["film"], film, seed)
    for r in res:
        assert r["mk_bvh"]["stats"] == stats


def test_permuted_mesh(sharded):
    """On a mesh whose order is not rank order (ranks.permuted_mesh: [1, 0],
    or make_global_mesh's [0, 2, 1, 3] over alternating hosts), shard k
    is the rank at place k: it renders pixels [k*L, (k+1)*L), and the
    result is gathered on shard 0's rank, each part at its shard's place.
    The block ring's film, spp and cursors bit-equal the local
    simulation, the megastep's film and seeds the unsharded ones."""
    world, res = sharded
    order = [1, 0] if world == 2 else [0, 2, 1, 3]
    assert all(r["permuted"]["order"] == order for r in res)
    assert [res[o]["permuted"]["shard"] for o in order] == list(range(world))
    home = res[order[0]]["permuted"]
    assert all(r["permuted"]["block"] is None and r["permuted"]["mk"] is None
               for k, r in enumerate(res) if k != order[0])
    _assert_local_simulation(home["block"], "block", world)
    film, seed, _ = _unsharded_mk()
    _assert_unsharded(home["mk"], film, seed)


def test_one_scalar_all_reduce_per_step(sharded):
    """Every sharded step (each wavefront segment on every ring, each
    megastep sample) issues exactly one collective: an all_reduce of a
    4-scalar vector. No collective of the film's size."""
    world, res = sharded
    for r in res:
        steps = [c for ring in ranks.RINGS for c in r[ring]["calls"]]
        steps += r["mk"]["calls"] + r["mk_bvh"]["calls"]
        assert len(steps) == len(ranks.RINGS) * ranks.SEGMENTS \
            + 2 * ranks.MK_STEPS
        assert all(calls == [("all_reduce", 4)] for calls in steps), steps


def test_shard_wf_state_errors(sharded):
    """shard_wf_state's divisibility errors, in the reference's words
    (parallel/mesh.py:86-99): a pool, then a group count, that the mesh
    size does not divide."""
    world, res = sharded
    p = ranks.wf_setup("block")[2].groups * 128
    want = [f"pool ({3 * world + 1}) and pixels ({p}) must divide the "
            f"mesh size ({world})",
            f"groups ({2 * world + 1}) must divide the mesh size ({world})"]
    for r in res:
        assert r["errors"] == want


def test_global_mesh_on_one_host(sharded):
    """make_global_mesh over ranks of one host: every rank in rank order
    (host_mesh_layout's identity), as make_mesh()."""
    world, res = sharded
    for r in res:
        assert r["global_mesh"] == list(range(world))


def _check_sliced(d, route):
    """render_sample over d slices of ranks.mk_setup(route)'s film against
    one unsharded call (test_sliced_render_sample_concatenates)."""
    scene, params, config = ranks.mk_setup(route)
    n = config.num_pixels
    film0 = tmk.Film.zeros(n, "cpu")
    seed0 = torch.arange(n, dtype=torch.int64)
    whole, seed, stats = tmk.render_sample(scene, params, film0, seed0,
                                           config)
    parts = [tmk.render_sample(scene, params, ranks._cut(film0, k, d),
                               ranks._cut(seed0, k, d), config,
                               pixel_base=k * (n // d)) for k in range(d)]
    for c in range(3):
        assert torch.equal(torch.cat([f.color[c] for f, _, _ in parts]),
                           whole.color[c])
    assert torch.equal(torch.cat([f.weight for f, _, _ in parts]),
                       whole.weight)
    assert torch.equal(torch.cat([s for _, s, _ in parts]), seed)
    assert [sum(x) for x in zip(*(st for _, _, st in parts))] == list(stats)


@pytest.mark.parametrize("d", WORLDS)
def test_sliced_render_sample_concatenates(d):
    """render_sample over d slices [k*L, (k+1)*L) of the film, each with its
    seeds, concatenated: bit-equal to one unsharded call; the slices'
    stats sum to its stats."""
    _check_sliced(d, "tables")


@pytest.mark.parametrize("d", WORLDS)
def test_sliced_render_sample_bitstack(d):
    """test_sliced_render_sample_concatenates on quad_scene through its
    BVH."""
    _check_sliced(d, "bvh")


@pytest.mark.parametrize("ids", [[1, 0, 1, 0, 1, 0, 1, 0], [0, 0, 1, 1],
                                 [3, 3, 3], [2, 0, 1], [0, 0, 1]])
def test_host_mesh_layout(ids):
    """The port's host_mesh_layout gives the reference's permutation
    (test_mk_sharded.py:119-141's cases and more), or raises as it does on
    ragged hosts."""
    try:
        want = jdistributed.host_mesh_layout(ids)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            tdistributed.host_mesh_layout(ids)
        return
    got = tdistributed.host_mesh_layout(ids)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(np.asarray(ids)[got]) >= 0).all()


def test_init_distributed_noop_by_default():
    """Without FLT_MULTIHOST=1 both packages' init_distributed return False
    and no process group is created."""
    assert tdistributed.init_distributed() is False
    assert jdistributed.init_distributed() is False
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_block_scene_tables_equal_reference():
    """The port's mxu_block_scene tables equal the reference's, uploaded by
    tables_from_numpy; both scenes' configs render the same film."""
    js, _, jc = jtesting.mxu_block_scene()
    ts, _, tc = ttesting.mxu_block_scene(device="cpu")
    jm = js.mxu
    host = {k: (None if getattr(jm, k, None) is None
                else np.array(getattr(jm, k))) for k in tmt._HOST_KEYS}
    statics = {k: getattr(jm, k) for k in tmt._STATIC_KEYS}
    want = tmt.tables_from_numpy(host, statics, "cpu")
    for f in tmt.MXUSceneT._fields:
        a, b = getattr(ts.mxu, f), getattr(want, f)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f
    assert (tc.width, tc.height, tc.max_bounces, tc.groups, tc.block_ring,
            tc.material_types) == (jc.width, jc.height, jc.max_bounces,
                                   jc.groups, jc.block_ring,
                                   jc.material_types)


def test_egyptcat_scene_raises_without_assets(tmp_path):
    with pytest.raises(FileNotFoundError):
        ttesting.egyptcat_scene(str(tmp_path), device="cpu")
