"""The benchmark's one command (``benchmark/run.py``): a cell by name,
found through its files, run on the program, measured and checked.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``workloads/<cell>.json`` (its configuration, traffic kind,
parameters and the check's limits); its configuration is
``configs/<config>.json``; its traffic kind is ``traffic/<kind>.py``
(``run(session)`` and ``numbers(session, ref, control)``); each per-layer
metric is ``metrics/<metric>.py`` (``read(session)``, None when it finds
nothing to read). ``BENCHMARK.json`` names the metrics of each cell and
their units. Adding a cell, a configuration, a traffic kind or a metric
is adding files.

A cell whose ``chips`` is N > 1 runs as N ranks of this command, one a
card (``bm/ranks.py``): each rank joins the program's process group
(``parallel.distributed.init_distributed``), renders and checks its own
share, and rank 0 prints the set-up and result lines."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

from . import ranks

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "fluctus_tpu"}
# how long ranks may run besides their two windows: within a first run's
# 1,200 s (which builds and compiles) at the longest window, 51 s
RANKS_DEADLINE_S = 1080


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by path (names
    may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bm_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that this cell reports."""
    on = lambda m: "workloads" not in m or cell in m["workloads"]
    return ([m for m in bench["end_to_end"] if on(m)],
            [m for m in bench["per_layer"] if on(m)])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card_line():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def scene_path(cfg: dict) -> str:
    """The configuration's scene file; a production scene is written once
    into the cache (a fixed directory of the checkout)."""
    sc = cfg["scene"]
    if sc["kind"] == "file":
        return os.path.join(BENCH, sc["file"])
    if sc["kind"] != "production":
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    out = os.path.join(CACHE, "scenes", "production_"
                       + "_".join(str(v) for v in sc["texture_sizes"])
                       + f"_s{sc['texture_seed']}")
    path = os.path.join(out, "production.sc.json")
    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(BENCH, "scenes"))
        try:
            import production
        finally:
            sys.path.pop(0)
        os.makedirs(os.path.join(CACHE, "scenes"), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.join(CACHE, "scenes"))
        production.write_production_scene(
            tmp, os.path.join(BENCH, sc["base_obj"]),
            tuple(sc["texture_sizes"]), seed=sc["texture_seed"])
        try:
            os.replace(tmp, out)
        except OSError:        # written meanwhile by another run
            pass
    return path


def apply_view(s, cfg: dict):
    """The configuration's camera into the Settings ``s``: position and
    direction, the right and up vectors derived as the renderer derives
    them."""
    c = s.camera
    c.pos = tuple(cfg["camera"]["pos"])
    c.dir = tuple(cfg["camera"]["dir"])
    c.fov = cfg["camera"]["fov"]
    s._calc_camera_rotation()
    s._calc_camera_matrix()


def make_renderer(cfg: dict, device, scale=None):
    """The program's Renderer at the configuration's settings; ``scale``
    (tests only) overrides width, height and pool."""
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    w, h, pool = cfg["width"], cfg["height"], cfg["wfBufferSize"]
    if scale:
        w, h, pool = scale
    s = Settings()
    s.wf_buffer_size = pool
    s.max_path_depth = cfg["maxPathDepth"]
    s.use_russian_roulette = cfg["useRussianRoulette"]
    s.sample_implicit = cfg["sampleImplicit"]
    s.sample_explicit = cfg["sampleExplicit"]
    s.use_area_light = cfg["useAreaLight"]
    s.use_env_map = cfg["useEnvMap"]
    s.tonemap = cfg["tonemap"]
    s.wf_block_ring = cfg["wfBlockRing"]
    apply_view(s, cfg)
    a, la = s.area_light, cfg["areaLight"]
    a.pos, a.N, a.right, a.up = (tuple(la[k]) for k in ("pos", "N", "right",
                                                        "up"))
    a.E, a.size = tuple(la["E"]), tuple(la["size"])
    os.makedirs(CACHE, exist_ok=True)
    r = Renderer(w, h, settings=s, device=device,
                 data_dir=os.path.join(CACHE, "data"))
    env = os.path.join(BENCH, cfg["env_map"]) if cfg.get("env_map") else None
    r.load_scene(scene_path(cfg), env_map=env, use_saved_state=False)
    return r


class Session:
    """What a traffic kind and a metric reader see of one run."""

    def __init__(self, cell, cfg, name, seed, seconds, trace, device):
        self.cell, self.cfg, self.name = cell, cfg, name
        self.params = cell["params"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.rank, self.world = 0, 1
        self.trace_file = os.path.join(CACHE, "trace", "trace.json")
        self.e2e, self.window = {}, {}
        self.attempted = self.failed = 0
        self.summary = None
        self.setup_s = None
        self.t_start = None
        self._window = None

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def trace_begin(self):
        from torch.profiler import record_function

        from . import profile
        self.sync()
        self.probe.spans = True
        profile.start(self.device.type == "cuda")
        self._window = record_function("bm::window")
        self._window.__enter__()

    def trace_end(self):
        from . import profile
        self.sync()
        self._window.__exit__(None, None, None)
        self.probe.spans = False
        self.summary = profile.stop_and_read(self.trace_file)

    def segment_numbers(self, seg, ref, control):
        from benchmark.reference import checks
        c = self.cfg
        cfg = SimpleNamespace(width=self.r.width, height=self.r.height,
                              max_bounces=c["maxPathDepth"],
                              sample_impl=c["sampleImplicit"],
                              sample_expl=c["sampleExplicit"])
        # each rank draws its own lanes, from the seed and its rank
        return checks.segment_numbers(seg, ref, cfg,
                                      self.cell["check"]["lanes"],
                                      self.seed * self.world + self.rank,
                                      control=control)


def reference_scene(s):
    from benchmark.reference.scene_ref import RefScene
    c = s.cfg
    env = os.path.join(BENCH, c["env_map"]) if c.get("env_map") else None
    light = c["areaLight"] if c["useAreaLight"] else None
    return RefScene(scene_path(c), env, c["camera"], light, s.device,
                    fast_env=s.device.type == "cuda")


def build_shared(cfg, dev, rank=0, world=1):
    """Rank 0 builds the kernels (on a card) and, in a group of several
    ranks, writes the configuration's scene; the other ranks wait for it
    and then load what it built."""
    import torch.distributed as dist
    from fluctus_tpu_torch import kernel_build
    if rank == 0:
        if dev.type == "cuda":
            kernel_build.build_all()
        if world > 1:
            scene_path(cfg)
    if world > 1:
        dist.barrier()
        if dev.type == "cuda" and rank:
            kernel_build.build_all()


def run_cell(name, seed, seconds, trace, device=None, scale=None,
             t_start=None, bench_json=None, params=None, cell=None,
             cfg=None):
    """One run of cell ``name``; returns (result dict, check lines, setup
    line, forbidden modules loaded). ``device`` "cpu", ``scale`` (width,
    height, pool) and ``params`` (over the cell's traffic parameters)
    serve the CPU tests, which skip the look for a chip; they may also
    hand the cell and configuration dicts in place of their files.

    In an initialized process group of N > 1 ranks every rank calls it:
    rank 0 builds the kernels and writes the scene, the others load them;
    each renders its share and checks its own last segment; rank 0's
    result holds the worst of each checked number over the ranks, and the
    others' result is None."""
    import torch
    import torch.distributed as dist
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench_json or load_json(ROOT, "BENCHMARK.json")
    cell = cell or load_json(BENCH, "workloads", f"{name}.json")
    cell["params"].update(params or {})
    cfg = cfg or load_json(BENCH, "configs", f"{cell['config']}.json")
    traffic = load_module("traffic", cell["traffic"])
    e2e_defs, layer_defs = cell_metrics(bench, name)
    dev = torch.device(device or "cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    s = Session(cell, cfg, name, seed, seconds, trace, dev)
    s.t_start = t_start
    if world > 1:
        s.rank, s.world = rank, world
        s.trace_file = os.path.join(CACHE, "trace", f"trace.rank{rank}.json")
    setup = dict(imports_s=time.perf_counter() - t_start)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        torch.cuda.init()
        setup["cuda_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_shared(cfg, dev, rank, world)
    if dev.type == "cuda":
        setup["kernels_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s.r = make_renderer(cfg, dev, scale)
    setup["scene_s"] = time.perf_counter() - t0
    setup["load_seconds"] = dict(s.r.load_seconds)
    setup["cache_hit"] = dict(s.r.cache_hit)
    from .probe import Probe
    s.probe = Probe(seed)
    s.probe.install(s.r)
    s.tmp_dir = tempfile.mkdtemp(prefix="bm_")
    t_warm = time.perf_counter()
    traffic.run(s)
    setup["warm_s"] = s.setup_s - (t_warm - t_start) if s.setup_s else None
    setup["setup_s"] = s.setup_s
    setup["window"] = s.window
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        setup["card"] = card_line()
        kind = torch.cuda.get_device_name(dev)
    else:
        peak = 0
        kind = "cpu"
    t = s.summary
    busy = [t.busy_s, t.window_s] if t else None
    count = 1
    if world > 1:
        # the device report: every rank's card and peak; of a traced run
        # its busy and window seconds and device time by operation
        per = ranks.gather(dict(
            device=ranks.device_id(dev), kind=kind, peak=peak, busy=busy,
            device_ops=t.device_ops if t else None))
        s.rank_traces = [x.pop("device_ops") for x in per]
        setup["ranks"] = per
        setup["device_ids"] = ids = [x["device"] for x in per]
        count = len(set(ids))
        peak = max(x["peak"] for x in per)
        busy = ([sum(x["busy"][i] for x in per) for i in (0, 1)]
                if all(x["busy"] for x in per) else None)
        s.rank_busy = [x["busy"][0] for x in per] if busy else None
    setup["memory_peak_bytes"] = peak

    metrics = {}
    if rank == 0 and trace:
        for m in layer_defs:
            v = load_module("metrics", m["name"]).read(s)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    elif rank == 0:
        for m in e2e_defs:
            v = (s.setup_s if m["name"] == "setup_s"
                 else s.e2e.get(m["name"]))
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])

    # the check: after the window, with the peak read; each rank its own
    limits = cell["check"]["limits"]
    numbers, problems = {}, list(s.probe.missing)
    if s.probe.last is None:
        problems.append("no segment was captured")
    else:
        t0 = time.perf_counter()
        ref = reference_scene(s)
        try:
            numbers = traffic.numbers(s, ref)
        except (KeyError, ValueError, RuntimeError) as e:
            problems.append(f"the check failed: {type(e).__name__}: {e}")
        setup["check_s"] = time.perf_counter() - t0
    shutil.rmtree(s.tmp_dir, ignore_errors=True)
    if world > 1:
        got = ranks.gather(dict(numbers=numbers, problems=problems))
        if rank:
            return None, [], setup, forbidden_modules()
        setup["rank_checks"] = [g["numbers"] for g in got]
        numbers = worst([g["numbers"] for g in got], limits)
        problems = [f"rank {k}: {p}" for k, g in enumerate(got)
                    for p in g["problems"]]
    missing = [] if trace else [m["name"] for m in e2e_defs
                                if m["name"] not in metrics]
    if missing:
        problems.append(f"metrics not measured: {missing}")
    lines = []
    ok = not problems
    for k, lim in limits.items():
        v = numbers.get(k)
        good = v is not None and v <= lim
        ok &= good
        lines.append(f"check {k} = {v!r} limit {lim!r} "
                     f"{'ok' if good else 'FAIL'}")
    lines += [f"problem: {p}" for p in problems]
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=kind, count=count, memory_peak_bytes=peak)
    result = dict(correct=bool(ok), attempted=s.attempted, failed=s.failed,
                  metrics=metrics, device=device_info)
    if trace and s.summary is not None and busy is not None:
        setup["trace_read_s"] = s.summary.read_s
        device_info["busy_s"], device_info["window_s"] = busy
        result["breakdown"] = s.summary.breakdown()
    result["checks"] = {k: dict(value=numbers.get(k), limit=lim)
                        for k, lim in limits.items()}
    return result, lines, setup, forbidden_modules()


def worst(rows, limits):
    """The worst value of each checked number over the ranks' ``rows``
    (the largest; None where a rank has none)."""
    out = {}
    for k in limits:
        vals = [r.get(k) for r in rows]
        out[k] = None if None in vals else max(vals)
    return out


def main(argv, t_start):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    a = ap.parse_args(argv)
    cache = os.path.join(CACHE, "compile")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    chips = next((w["chips"] for w in load_json(ROOT, "BENCHMARK.json")
                  ["workloads"] if w["name"] == a.workload), 1)
    is_rank = ranks.RANK_ENV in os.environ
    if chips > 1 and not is_rank:
        # the ranks import the program and look for the cards themselves; a
        # deadline past the first run's build and compile, never a hang
        code, out, err = ranks.launch(
            [sys.executable, os.path.join(BENCH, "run.py"), *argv], chips,
            RANKS_DEADLINE_S + 2 * a.seconds, t_start)
        found = forbidden_modules()
        if found:
            code, out = 3, ""
            err += f"forbidden modules loaded: {found}\n"
        sys.stderr.write(err)
        sys.stderr.flush()
        sys.stdout.write(out)
        sys.stdout.flush()
        return code
    try:
        import fluctus_tpu_torch  # noqa: F401  (the program under test)
        import torch
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if is_rank:
        from fluctus_tpu_torch.parallel.distributed import init_distributed
        init_distributed()
        t_start = float(os.environ[ranks.RANK_ENV])
    result, lines, setup, found = run_cell(a.workload, a.seed, a.seconds,
                                           bool(a.trace), t_start=t_start)
    if is_rank:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    if result is None:          # a rank other than 0
        return 0
    if chips > 1:
        try:
            ranks.distinct_devices(setup["device_ids"], chips)
        except ValueError as e:
            print(f"the device report fails: {e}; no result",
                  file=sys.stderr)
            return 4
    print(json.dumps(dict(setup=setup)), flush=True)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
