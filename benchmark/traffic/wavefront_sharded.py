"""Free-running wavefront sharded over the cards of one host, as a user's
``torchrun`` script renders with the port's public multi-card API: one
process a card, every rank loading the scene itself, ``wf_reset`` of the
global pool (the configuration's ``wfBufferSize``, a per-card setting in
fluctus, times the ranks), ``shard_wf_state`` of it, then
``wf_segment_sharded`` segment after segment: each rank its band of the
film's groups and its slice of the pool, and one ``all_reduce`` of the 4
counters a segment.

Set-up warms every rank for ``warm_segments`` segments. A barrier starts
the window; every rank then runs chunks of ``chunk_segments`` segments,
each ending in a device sync, until rank 0's clock passes ``seconds``
(rank 0 broadcasts its decision after each chunk, so that every rank
runs the same segments); a barrier ends it. ``msamples_s`` is the film
weight the window added on all ranks (one ``all_reduce``) over rank 0's
window seconds, and ``window["rays"]`` comes from the summed counters.
``count_gap`` is the window's summed ``splatted`` counter less that film
weight: 0 where the counters' exchange summed every rank's."""

from __future__ import annotations

import time

import torch


def film_weight(state) -> float:
    """The samples this rank's film slice holds, after a sync."""
    return float(state.film.weight.double().sum())


def run(s):
    import torch.distributed as dist

    from fluctus_tpu_torch import renderer as R
    from fluctus_tpu_torch.parallel.mesh import (make_mesh, shard_wf_state,
                                                 wf_segment_sharded)
    r, p = s.r, s.params
    mesh = make_mesh(device=s.device.type)
    cfg = r.config
    lanes = r.settings.wf_buffer_size * s.world
    # R.wf_reset: the renderer's, which the probe salts with the seed
    state = shard_wf_state(R.wf_reset(cfg, lanes,
                                      world_radius=r.world_radius,
                                      device=s.device), mesh)
    total = torch.zeros(4, dtype=torch.int64, device=s.device)

    def segments(k):
        nonlocal state
        for _ in range(k):
            state, c = wf_segment_sharded(r.device_scene, r.params, state,
                                          cfg, mesh)
            total.add_(torch.stack(list(c)))

    segments(p["warm_segments"])
    s.sync()
    dist.barrier()
    s.setup_done()
    w0 = film_weight(state)
    c0 = total.clone()
    seg0 = s.probe.segments
    stop = torch.zeros(1, dtype=torch.int32, device=s.device)
    dist.barrier()
    t0 = time.perf_counter()
    chunks = []
    while True:
        t = time.perf_counter()
        segments(p["chunk_segments"])
        s.sync()
        chunks.append(time.perf_counter() - t)
        if s.rank == 0:
            stop.fill_(int(time.perf_counter() - t0 >= s.seconds))
        dist.broadcast(stop, 0)
        if stop.item():
            break
    dist.barrier()
    elapsed = time.perf_counter() - t0
    added = torch.tensor([film_weight(state) - w0], dtype=torch.float64,
                         device=s.device)
    dist.all_reduce(added)
    samples = float(added.item())
    raygen, extension, shadow, splatted = (total - c0).tolist()
    segs = s.probe.segments - seg0
    chunks.sort()
    s.window = dict(seconds=elapsed, segments=segs,
                    rays=raygen + extension + shadow, samples=samples,
                    lanes=lanes, ranks=s.world,
                    count_gap=abs(splatted - samples),
                    chunk_s_quartiles=[round(chunks[len(chunks) * q // 4], 5)
                                       for q in (0, 1, 2, 3)]
                    + [round(chunks[-1], 5)])
    s.e2e["msamples_s"] = samples / elapsed / 1e6
    s.attempted, s.failed = segs, 0
    if s.trace:
        dist.barrier()
        s.trace_begin()
        segments(p["trace_segments"])
        s.trace_end()
    dist.barrier()


def numbers(s, ref, control=None):
    """This rank's numbers: its own last segment against the reference on
    its own lanes, ``film_bad`` over its slice's true pixels, and the
    window's ``count_gap`` (the same on every rank)."""
    from benchmark.bm.capture import Segment
    from benchmark.reference import checks
    seg = Segment(s.probe.last, ref.params(), rank=s.rank, world=s.world)
    out = s.segment_numbers(seg, ref, control)
    if control is None:
        out["film_bad"] = checks.film_bad(seg.film1[:, seg.true_slots()])
        out["count_gap"] = s.window["count_gap"]
    return out
