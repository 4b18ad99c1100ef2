"""Rank bodies of tests/test_torch_parallel.py and their launcher: each
rank is a spawned process in a gloo group on the CPU. Imports torch and
the port only (no JAX), so a rank starts in a few seconds."""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEGMENTS = 5
MK_STEPS = 2
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "all_to_all", "all_to_all_single",
               "broadcast", "gather", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "scatter", "send", "recv")


def launch(body, world: int, tmp_path, timeout: float, *args) -> list:
    """Run ``body(rank, world, *args)`` in ``world`` spawned processes, one
    gloo group over a ``file://`` rendezvous under ``tmp_path``; returns
    each rank's result. A rank that raises fails the call (the others are
    stopped); one still running after ``timeout`` seconds is killed and
    fails it."""
    init = os.path.join(str(tmp_path), f"rendezvous_{world}")
    out = os.path.join(str(tmp_path), f"results_{world}")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(body, world, init, out, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, body, world, init, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        res = body(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class CollectiveLog:
    """Wraps every collective of torch.distributed while active and records
    (name, numel of its tensor) per call."""

    def __enter__(self):
        self.calls = []
        self.saved = {}
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def wrap(*a, _fn=fn, _name=name, **kw):
                t = a[0] if a else None
                self.calls.append((_name, t.numel() if isinstance(
                    t, torch.Tensor) else None))
                return _fn(*a, **kw)
            setattr(dist, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _np(tree):
    """A gathered state or film as nested lists of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if tree is None:
        return None
    return [_np(x) for x in tree]


RINGS = ("block", "flat", "block_capped", "flat_capped", "flat_bvh",
         "block_bvh")
CAP_SPP = 2
FLAT_SIZE, FLAT_TASKS = (32, 8), 384      # 1.5 paths a pixel: uneven spp
BLOCK_TASKS = 2048
BVH_GROUPS = 4                            # block_bvh: 96 lanes a group


def quad_tables_scene():
    """quad_scene on the cluster-table route: its tables built explicitly
    (the scene traces through its BVH otherwise)."""
    from fluctus_tpu_torch import testing
    return testing.quad_scene(device="cpu")._replace(
        mxu=testing._tables(*testing.quad_arrays(), "cpu"), tris=None,
        mats=None, bvh=None)


def wf_setup(ring: str):
    """The scene, params, config and pool size of a sharded wavefront run:
    mxu_block_scene on the block ring, quad_scene under its area light
    (so that pixels differ) on the flat one, on its tables; a ``_capped``
    ring renders under the spp cap (CAP_SPP). The ``_bvh`` rings render
    quad_scene through its BVH (no tables): ``flat_bvh`` as ``flat``,
    ``block_bvh`` on the block ring of BVH_GROUPS groups."""
    from fluctus_tpu_torch import testing
    if ring.endswith("bvh"):
        scene = testing.quad_scene(device="cpu")
        params, config = testing.quad_setup(
            *FLAT_SIZE, max_bounces=2, use_area_light=True, device="cpu",
            block_ring=ring.startswith("block"), groups=BVH_GROUPS)
        tasks = FLAT_TASKS
    elif ring.startswith("block"):
        scene, params, config = testing.mxu_block_scene(
            num_tasks=BLOCK_TASKS, device="cpu")
        tasks = BLOCK_TASKS
    else:
        scene = quad_tables_scene()
        params, config = testing.quad_setup(*FLAT_SIZE, max_bounces=2,
                                            use_area_light=True,
                                            device="cpu")
        tasks = FLAT_TASKS
    if ring.endswith("capped"):
        config = config.replace(max_spp=1)
        params = params._replace(max_spp=torch.tensor(CAP_SPP,
                                                      dtype=torch.int32))
    return scene, params, config, tasks


def mk_setup(route: str = "tables"):
    """The scene, params and config of the sharded megastep: on "tables"
    mxu_block_scene (multi-cluster, GGX, the env map) with the area light
    on; on "bvh" quad_scene through its BVH under its area light, at the
    flat rings' size."""
    from fluctus_tpu_torch import testing
    if route == "bvh":
        params, config = testing.quad_setup(*FLAT_SIZE, max_bounces=2,
                                            use_area_light=True,
                                            device="cpu")
        return testing.quad_scene(device="cpu"), params, config
    scene, params, config = testing.mxu_block_scene(device="cpu")
    return scene, params, config.replace(use_area_light=True)


def _mk_sharded(mesh, route):
    """MK_STEPS sharded megastep samples of mk_setup(route): the stats and
    collectives of each step, and the film and seeds gathered on shard 0."""
    from fluctus_tpu_torch.core.integrator_mk import Film
    from fluctus_tpu_torch.parallel import render_sharded
    from fluctus_tpu_torch.parallel.mesh import gather_film, shard_film
    scene, params, config = mk_setup(route)
    n = config.num_pixels
    film, seed = shard_film(Film.zeros(n, "cpu"),
                            torch.arange(n, dtype=torch.int64), mesh)
    stats, calls = [], []
    for _ in range(MK_STEPS):
        with CollectiveLog() as log:
            film, seed, st = render_sharded(scene, params, film, seed,
                                            config, mesh)
        stats.append(list(st))
        calls.append(log.calls)
    return dict(stats=stats, calls=calls,
                film=_np(gather_film(film, seed, mesh)))


def rank_body(rank, world):
    """One rank's part: SEGMENTS sharded wavefront segments on each ring
    and MK_STEPS sharded megastep samples on each route (mk_setup), the
    collectives of each step, the gathered results on rank 0, and
    shard_wf_state's errors."""
    from fluctus_tpu_torch.core.integrator_wf import wf_reset
    from fluctus_tpu_torch.parallel import make_mesh, replicate_scene
    from fluctus_tpu_torch.parallel.mesh import (gather_wf_state,
                                                 shard_wf_state,
                                                 wf_segment_sharded)
    from fluctus_tpu_torch.parallel.distributed import make_global_mesh
    mesh = make_mesh(device="cpu")
    out = dict(rank=rank, shard=mesh.get_coordinate()[0],
               global_mesh=make_global_mesh(device="cpu").mesh.tolist())
    for ring in RINGS:
        scene, params, config, tasks = wf_setup(ring)
        scene = replicate_scene(scene, mesh)
        st = shard_wf_state(wf_reset(config, tasks,
                                     world_radius=float(params.world_radius),
                                     device="cpu"), mesh)
        counters, calls = [], []
        for _ in range(SEGMENTS):
            with CollectiveLog() as log:
                st, cnt = wf_segment_sharded(scene, params, st, config, mesh)
            counters.append([int(c) for c in cnt])
            calls.append(log.calls)
        out[ring] = dict(counters=counters, calls=calls,
                         state=_np(gather_wf_state(st, mesh)))

    out["mk"] = _mk_sharded(mesh, "tables")
    out["mk_bvh"] = _mk_sharded(mesh, "bvh")

    # the divisibility checks: a pool, then a group count, that the mesh
    # size does not divide
    errors = []
    scene, params, config, tasks = wf_setup("block")
    good = wf_reset(config, tasks, device="cpu")
    bad_pool = good._replace(pool=good.pool._replace(
        seed=torch.zeros(world * 3 + 1, dtype=torch.int64)))
    bad_groups = good._replace(curr_pixel=torch.zeros(world * 2 + 1,
                                                      dtype=torch.int32))
    for bad in (bad_pool, bad_groups):
        try:
            shard_wf_state(bad, mesh)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    out["permuted"] = permuted_part(rank, world)
    return out


def permuted_mesh(rank: int, world: int):
    """A "px" mesh whose order is not rank order: on 2 ranks [1, 0]; on 4,
    make_global_mesh over two hosts that alternate by rank (host ids
    [0, 1, 0, 1]), which host_mesh_layout orders [0, 2, 1, 3]."""
    from unittest import mock
    from torch.distributed.device_mesh import DeviceMesh
    from fluctus_tpu_torch.parallel.distributed import make_global_mesh
    if world == 2:
        return DeviceMesh("cpu", torch.tensor([1, 0]),
                          mesh_dim_names=("px",))
    with mock.patch("socket.gethostname", return_value=f"host{rank % 2}"):
        return make_global_mesh(device="cpu")


def permuted_part(rank: int, world: int) -> dict:
    """The block ring's SEGMENTS segments and MK_STEPS megastep samples on
    permuted_mesh, gathered on shard 0 (None elsewhere): each rank renders
    the pixels of its place in the mesh."""
    from fluctus_tpu_torch.core.integrator_mk import Film
    from fluctus_tpu_torch.core.integrator_wf import wf_reset
    from fluctus_tpu_torch.parallel import render_sharded
    from fluctus_tpu_torch.parallel.mesh import (gather_film,
                                                 gather_wf_state, shard_film,
                                                 shard_wf_state,
                                                 wf_segment_sharded)
    mesh = permuted_mesh(rank, world)
    scene, params, config, tasks = wf_setup("block")
    st = shard_wf_state(wf_reset(config, tasks,
                                 world_radius=float(params.world_radius),
                                 device="cpu"), mesh)
    for _ in range(SEGMENTS):
        st, _ = wf_segment_sharded(scene, params, st, config, mesh)
    scene, params, config = mk_setup()
    n = config.num_pixels
    film, seed = shard_film(Film.zeros(n, "cpu"),
                            torch.arange(n, dtype=torch.int64), mesh)
    for _ in range(MK_STEPS):
        film, seed, _ = render_sharded(scene, params, film, seed, config,
                                       mesh)
    return dict(order=mesh.mesh.tolist(), shard=mesh.get_coordinate()[0],
                block=_np(gather_wf_state(st, mesh)),
                mk=_np(gather_film(film, seed, mesh)))


def _cut(tree, k: int, d: int):
    """Shard k of d of every tensor's leading dim in a NamedTuple tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        m = tree.shape[0] // d
        return tree[k * m:(k + 1) * m].contiguous()
    return type(tree)(*(_cut(x, k, d) for x in tree))


def local_wf(ring: str, world: int):
    """The sharded wavefront simulated in one process: each shard's slice
    of the same reset, its SEGMENTS segments run one shard after another
    through wf_segment with its pixel_base. Returns per shard (state,
    counters of each segment)."""
    from fluctus_tpu_torch.core.integrator_wf import wf_reset, wf_segment
    scene, params, config, tasks = wf_setup(ring)
    st0 = wf_reset(config, tasks, world_radius=float(params.world_radius),
                   device="cpu")
    local_pixels = st0.film.weight.shape[0] // world
    out = []
    for k in range(world):
        curr = (_cut(st0.curr_pixel, k, world) if st0.curr_pixel.ndim
                else torch.zeros((), dtype=torch.int32))
        st = st0._replace(pool=_cut(st0.pool, k, world),
                          film=_cut(st0.film, k, world),
                          spp=_cut(st0.spp, k, world), curr_pixel=curr)
        counters = []
        for _ in range(SEGMENTS):
            st, cnt = wf_segment(scene, params, st, config,
                                 pixel_base=k * local_pixels)
            counters.append([int(c) for c in cnt])
        out.append((st, counters))
    return out
