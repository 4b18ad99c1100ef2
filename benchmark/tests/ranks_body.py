"""The rank body of ``test_bm_ranks.py``: each rank a spawned process in
a gloo group on the CPU, running the harness's rank path at ``tiny.py``'s
size once for each scenario, with a fault planted where the scenario says.
Imports torch, the port and the benchmark only (no JAX)."""

from __future__ import annotations

import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NAME = "luxball_prod.wavefront.x4"
SEED = 3000000029
SECONDS = 0.05


def launch(world: int, tmp_path, scenarios, timeout: float) -> list:
    """Every scenario on ``world`` spawned ranks; returns each rank's
    {scenario: (result, check lines, setup line)}. A rank that raises, or
    ranks still running after ``timeout`` seconds, fail the call."""
    init = os.path.join(str(tmp_path), "rendezvous")
    out = os.path.join(str(tmp_path), "results")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, init, out, str(tmp_path),
                                           scenarios),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def plant(monkey, scenario: str, rank: int):
    """The scenario's fault: on rank 1 alone, except the counters'
    exchange, which every rank leaves out (one rank alone would wait for
    the others in its collective)."""
    from fluctus_tpu_torch.core import integrator_wf as W
    from fluctus_tpu_torch.parallel import mesh as M

    import test_bm_control
    if scenario == "exchange_left_out":
        monkey.setattr(M, "_all_reduce_scalars", lambda values, group, device:
                       torch.stack([torch.as_tensor(x, device=device)
                                    .to(torch.int64) for x in values]))
    if rank != 1:
        return
    if scenario == "pixel_base_off":
        f = W.wf_shade_phase

        def shade(scene, params, state, config, raw, occ, pixel_base=0):
            p = -(-config.num_pixels // config.groups)
            pk = -(-p // 128) * 128
            return f(scene, params, state, config, raw, occ,
                     pixel_base - pk)
        monkey.setattr(W, "wf_shade_phase", shade)
    elif scenario in ("state_unchanged", "half_batch", "splat_altered"):
        test_bm_control._faulty(monkey, scenario)


def _entry(rank, world, init, out, tmp, scenarios):
    import tiny
    from benchmark.bm import harness
    from benchmark.tools.readings import readings
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        b = harness.BENCH
        parts = dict(device="cpu", scale=tiny.SCALE, params=tiny.PARAMS)
        res = {}
        for sc in scenarios:
            monkey = pytest.MonkeyPatch()
            try:
                plant(monkey, sc, rank)
                cfg = tiny.config(b, os.path.join(tmp, f"scene{rank}"))
                # aimed lower, so that the top band, rank 1's, holds
                # geometry as well as sky
                cfg["camera"]["dir"] = [0.0, -0.6, -1.0]
                if sc == "control":
                    res[sc] = readings(NAME, [SEED], SECONDS,
                                       out=lambda line: None,
                                       cell=tiny.cell(b, NAME), cfg=cfg,
                                       **parts)
                else:
                    res[sc] = harness.run_cell(
                        NAME, SEED, SECONDS, sc == "traced",
                        cell=tiny.cell(b, NAME), cfg=cfg, **parts)[:3]
            finally:
                monkey.undo()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
