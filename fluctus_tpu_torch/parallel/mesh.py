"""Multi-GPU scaling: pixel and path sharding over a device mesh (the
reference package's parallel/mesh.py, on torch.distributed).

The reference is single-GPU (SURVEY §2.3); its scaling axis is paths in
flight. Here that axis is split over ranks: one process per rank, a 1-D
``DeviceMesh`` whose axis ("px") is the renderer's data parallelism. Each
rank holds the whole scene (it loads it itself with the deterministic
builders), renders its own slice of the film from its own slice of the
path pool, and keeps its own ring cursor(s). A step's only collective is
one ``all_reduce`` of a packed vector of its scalar counters; the film is
assembled on one rank by ``gather_film`` / ``gather_wf_state`` when the
caller wants it (JAX's sharded arrays are global, so the reference needs
no such call).

The shard index (the reference's ``lax.axis_index``) is the rank's
coordinate along the mesh axis, which follows the mesh's order (a
``make_global_mesh`` mesh need not list the ranks in rank order);
collectives go through ``mesh.get_group(axis)``, whose group ranks are in
rank order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import pixel_ring
from ..core.integrator_mk import Film, RenderStats, render_sample
from ..core.integrator_wf import WfCounters, WfState, wf_segment
from ..renderer import resolve_device


def make_mesh(n_devices: Optional[int] = None, axis: str = "px",
              device=None) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (all by
    default) of the initialized process group, on CUDA unless ``device``
    is the CPU; a ``device`` with an index (``"cuda:0"``) becomes this
    process's current device. Every rank of the group calls it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.init_distributed or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices ({n}) must lie in [1, {world}]")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, torch.arange(n), mesh_dim_names=(axis,))


def _shard_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (its mesh coordinate; the group
    rank of ``get_local_rank`` is in rank order whatever the mesh's
    order); raises on a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return coord[mesh.mesh_dim_names.index(axis)]


def _map(fn, tree):
    """``fn`` on every tensor of a tree of NamedTuples (Film, Vec3, WfPool,
    DeviceScene, ...); None and other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    return tree


def replicate_scene(scene, mesh: DeviceMesh):
    """The scene's tensors on this rank's device: every rank holds the whole
    scene, which it built itself (the reference's design: each host loads
    its scene locally, parallel/distributed.py:6-9): on CUDA this
    process's current card. A scene without tables carries its BVH and
    triangle arrays (``BVHDevice``, ``TrianglesDevice``); their int
    ``max_leaf`` stays as it is."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return _map(lambda a: a.to(dev), scene)


def _slice(tree, k: int, d: int):
    """Shard k of d of every tensor's leading dim, contiguous."""
    def cut(a):
        m = a.shape[0] // d
        return a[k * m:(k + 1) * m].contiguous()
    return _map(cut, tree)


def shard_film(film: Film, seed, mesh: DeviceMesh, axis: str = "px"):
    """This rank's slice of a whole film and its seeds: pixels
    ``[k*P/D, (k+1)*P/D)`` for shard k of D."""
    d = mesh.size()
    p = film.weight.shape[0]
    if p % d:
        raise ValueError(f"pixels ({p}) must divide the mesh size ({d})")
    k = _shard_index(mesh, axis)
    return _slice(film, k, d), _slice(seed, k, d)


def _all_reduce_scalars(values, group, device) -> torch.Tensor:
    """One all_reduce (sum) of a packed int64 vector of scalars."""
    v = torch.stack([torch.as_tensor(x, device=device).to(torch.int64)
                     for x in values])
    dist.all_reduce(v, group=group)
    return v


def render_sharded(scene, params, film: Film, seed, config,
                   mesh: DeviceMesh, axis: str = "px"):
    """One render_sample step over this rank's pixel slice (``film`` and
    ``seed`` from ``shard_film``; the scene replicated): ``pixel_base`` is
    the shard index times the slice length, and the RenderStats are summed
    over the mesh by one all_reduce of 4 scalars. Nothing of the film's
    size crosses ranks (the pixel axis is embarrassingly parallel;
    test_mk_sharded.py:115-146 holds the reference to the same). Through
    a scene's BVH (no tables) each ray's trace is independent of every
    other ray, so the film is bit-equal to the unsharded render_sample's
    (test_mk_sharded.py:32-84). Returns (film, seed, stats)."""
    if config.denoiser:
        raise ValueError("the sharded megastep renders no guide features "
                         "(as the reference's)")
    base = _shard_index(mesh, axis) * film.weight.shape[0]
    film, seed, stats = render_sample(scene, params, film, seed, config,
                                      pixel_base=base)
    total = _all_reduce_scalars(stats, mesh.get_group(axis), seed.device)
    return film, seed, RenderStats(*total.tolist())


def shard_wf_state(state: WfState, mesh: DeviceMesh,
                   axis: str = "px") -> WfState:
    """This rank's part of a wf_reset state: its slice of the pool, of the
    film, spp (and guide features), and its ring cursor(s).

    Shard k owns the pixel sub-ring [k*P/D, (k+1)*P/D) and a private slice
    of the path pool — the reference's single-GPU pixel ring
    (clcontext.cpp:917-927) per rank with disjoint pixel domains, so a
    segment needs no communication but the counters' all_reduce.

    Block-ring states (film/spp in the padded [G*Pk] layout, one cursor
    per group) give each rank G/D whole groups and their cursors; on the
    flat ring each rank starts its one cursor at 0."""
    d = mesh.size()
    n = state.pool.seed.shape[0]
    p = state.film.weight.shape[0]
    if n % d or p % d:
        raise ValueError(f"pool ({n}) and pixels ({p}) must divide the "
                         f"mesh size ({d})")
    k = _shard_index(mesh, axis)
    return WfState(pool=_slice(state.pool, k, d),
                   film=_slice(state.film, k, d),
                   spp=_slice(state.spp, k, d),
                   curr_pixel=pixel_ring.shard_cursors(state.curr_pixel, k,
                                                       d),
                   features=_slice(state.features, k, d))


def wf_segment_sharded(scene, params, state: WfState, config,
                       mesh: DeviceMesh, axis: str = "px"):
    """One wavefront segment on this rank's pool, pixel sub-ring and film
    slice (``shard_wf_state``); the counters summed over the mesh by one
    all_reduce of 4 scalars (the reference's queue-counter readback,
    reduced over ranks). Returns (state, counters)."""
    # pixel_base counts padded pixels on the block ring (each rank owns
    # G/D whole groups of Pk padded slots; integrator_wf derives the global
    # group offset as pixel_base // Pk) and true pixels on the flat ring:
    # both equal the local film length times the shard index
    base = _shard_index(mesh, axis) * state.film.weight.shape[0]
    new_state, counters = wf_segment(scene, params, state, config,
                                     pixel_base=base)
    total = _all_reduce_scalars(counters, mesh.get_group(axis),
                                state.spp.device)
    return new_state, WfCounters(*total.unbind())


def _gather(tree, mesh: DeviceMesh, axis: str):
    """Every tensor of ``tree`` from every shard, in shard order, on shard
    0 (concatenated along the leading dim; 0-d tensors stacked); None on
    the others. One gather per tensor; gloo gathers host copies. The
    gather's parts come in group-rank order, which is rank order, and are
    placed by each rank's mesh coordinate."""
    group = mesh.get_group(axis)
    order = mesh.mesh.tolist()          # global ranks in shard order
    mine = _shard_index(mesh, axis) == 0
    on_host = dist.get_backend(group) == "gloo"
    shard_of = [order.index(dist.get_global_rank(group, i))
                for i in range(len(order))]

    def one(a):
        src = a.detach().contiguous()
        if on_host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in order] if mine else None
        dist.gather(src, parts, dst=order[0], group=group)
        if not mine:
            return None
        parts = [p for _, p in sorted(zip(shard_of, parts),
                                      key=lambda x: x[0])]
        whole = torch.stack(parts) if src.ndim == 0 else torch.cat(parts)
        return whole.to(a.device)
    out = _map(one, tree)
    return out if mine else None


def gather_film(film: Film, seed, mesh: DeviceMesh, axis: str = "px"):
    """The whole film and seeds (render_sharded's) on shard 0: (film, seed)
    there, None on the other ranks."""
    film = _gather(film, mesh, axis)
    seed = _gather(seed, mesh, axis)
    return None if film is None else (film, seed)


def gather_wf_state(state: WfState, mesh: DeviceMesh,
                    axis: str = "px") -> Optional[WfState]:
    """The whole film, spp, ring cursors and guide features of a sharded
    wavefront on shard 0, in the unsharded layout (the block ring's
    cursors [G]; the flat ring's one per rank, [D]); the pool stays where
    it is (``pool`` None). None on the other ranks."""
    return _gather(state._replace(pool=None), mesh, axis)
