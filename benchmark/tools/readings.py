"""The readings that the check's limits are set from, on the card: for
each seed, one short run of the cell's traffic on one renderer (set up
once), then the check's numbers twice on the captured segment: the
program's (the sound reading) and the control's, the reference computed
in bfloat16 in the program's place (the configuration states float32).

    python benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--no-control]

Prints one JSON line per seed: {"seed", "program": {...}, "control": {...}}.
A cell on N > 1 cards runs as N ranks (``bm/ranks.py``), each reading its
own segment; rank 0 prints the worst of each number over the ranks, and
each rank's under "ranks". Not part of the benchmark's runs."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.bm import harness, ranks  # noqa: E402
from benchmark.bm.probe import Probe, salt32  # noqa: E402


def readings(name, seeds, seconds, control=True, device=None, scale=None,
             params=None, cell=None, cfg=None, out=print):
    """Per seed: the program's numbers and (with ``control``) the control's,
    from one renderer set up once. In a process group of several ranks
    every rank calls it, and rank 0 gets the rows."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    cell = cell or harness.load_json(harness.BENCH, "workloads",
                                     f"{name}.json")
    cell["params"].update(params or {})
    cfg = cfg or harness.load_json(harness.BENCH, "configs",
                                   f"{cell['config']}.json")
    traffic = harness.load_module("traffic", cell["traffic"])
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    harness.build_shared(cfg, dev, rank, world)
    r = harness.make_renderer(cfg, dev, scale)
    probe = Probe(seeds[0])
    probe.install(r)
    ref = None
    rows = []
    for seed in seeds:
        s = harness.Session(cell, cfg, name, seed, seconds, False, dev)
        s.t_start = time.perf_counter()
        s.rank, s.world = rank, world
        s.r, s.probe = r, probe
        probe.salt, probe.last = salt32(seed), None
        harness.apply_view(r.settings, cfg)     # a session moves it
        r.rebuild_config()
        s.tmp_dir = harness.tempfile.mkdtemp(prefix="bm_")
        traffic.run(s)
        if ref is None:
            ref = harness.reference_scene(s)
        row = dict(seed=seed, e2e=s.e2e,
                   program=traffic.numbers(s, ref))
        if control:
            row["control"] = traffic.numbers(s, ref, control=torch.bfloat16)
        if world > 1:
            got = ranks.gather(row)
            if rank:
                continue
            row["ranks"] = [g["program"] for g in got]
            for part in ("program", "control"):
                if part in row:
                    row[part] = harness.worst([g[part] for g in got],
                                              row[part])
        rows.append(row)
        out(json.dumps(row))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    a = ap.parse_args()
    seeds = [int(x) for x in a.seeds.split(",")]
    chips = next(w["chips"] for w in harness.load_json(
        harness.ROOT, "BENCHMARK.json")["workloads"]
        if w["name"] == a.workload)
    if chips > 1 and ranks.RANK_ENV not in os.environ:
        code, out, err = ranks.launch(
            [sys.executable, *sys.argv], chips, harness.RANKS_DEADLINE_S
            + len(seeds) * (a.seconds + 60), time.perf_counter())
        sys.stderr.write(err)
        sys.stdout.write(out)
        sys.exit(code)
    if chips > 1:
        from fluctus_tpu_torch.parallel.distributed import init_distributed
        init_distributed()
    readings(a.workload, seeds, a.seconds, control=not a.no_control,
             out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
