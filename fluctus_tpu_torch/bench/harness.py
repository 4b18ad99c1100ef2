"""Benchmark harness (the reference package's bench/harness.py; the
original renderer's Tracer::runBenchmark / runBenchmarkFromFile,
tracer.cpp:391-873).

``.bm.json`` schema (the reference's): a top-level ``settings`` object
(any settings.json keys), a ``scenes`` list (strings, or objects with
``file`` and a per-scene ``settings`` override), ``outputFolder`` and
``skipPP``. Per scene the harness renders until ``maxRenderTime`` seconds
or ``maxSpp`` samples, on the wavefront when ``useWavefront`` is set and
by exact-spp steps otherwise, logs the counters every 0.5 s into a CSV
with the reference's schema ``scene;time;primary;extension;shadow;total;
samples`` (tracer.cpp:428), and writes <name>.png, <name>.hdr,
results.csv and results.txt.

This is the user's harness, not a benchmark of the repository: it reports
what one run on the caller's device measured.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..renderer import Renderer
from ..settings import Settings

CSV_HEADER = "scene;time;primary;extension;shadow;total;samples"

FIXED_SCENES = [
    "assets/egyptcat/egyptcat.obj",
    "assets/conference/conference.obj",
    "assets/country_kitchen/Country-Kitchen.obj",
]

# same-scale instanced compositions standing in for scenes whose geometry
# is not shipped, so the 330k/500k-triangle tiers are still exercised
FIXED_FALLBACKS = {
    "assets/conference/conference.obj":
        "data/bigscene/big_egyptcat_5x4.sc.json",        # ~320k tris
    "assets/country_kitchen/Country-Kitchen.obj":
        "data/bigscene/big_egyptcat_6x5.sc.json",        # ~481k tris
}


class BenchmarkResult:
    def __init__(self, scene, averages, csv_rows):
        self.scene = scene
        self.averages = averages  # dict: primary/extension/shadow/samples/total
        self.csv_rows = csv_rows


def _timed_loop(snapshot, step, stop, scene_name, max_time,
                log_interval):
    """The timing and logging loop (tracer.cpp:676-691): run ``step``
    until ``stop()`` or ``max_time``, logging the counters' deltas as CSV
    rows every ``log_interval`` seconds. Returns (elapsed, totals,
    csv_rows)."""
    csv_rows = []
    t_start = time.time()
    t_last_log = t_start
    last_stats = (0, 0, 0, 0)
    while True:
        now = time.time()
        if max_time > 0 and now - t_start >= max_time:
            break
        step()
        if stop():
            break
        now = time.time()
        if now - t_last_log > log_interval:
            cur = snapshot()
            d = [c - l for c, l in zip(cur, last_stats)]
            sc = 1e6 * (now - t_last_log)
            csv_rows.append((scene_name, now - t_start, d[0] / sc,
                             d[1] / sc, d[2] / sc,
                             (d[0] + d[1] + d[2]) / sc, d[3] / sc))
            last_stats = cur
            t_last_log = now
    elapsed = time.time() - t_start
    return elapsed, snapshot(), csv_rows


def _averages(tot, elapsed, spp):
    scale = 1e6 * max(elapsed, 1e-9)
    return dict(
        primary=tot[0] / scale, extension=tot[1] / scale,
        shadow=tot[2] / scale, samples=tot[3] / scale,
        total=(tot[0] + tot[1] + tot[2]) / scale, spp=spp,
        elapsed=elapsed)


def _render_timed_wavefront(renderer: Renderer, max_time: float,
                            max_spp: int, scene_name: str,
                            log_interval: float = 0.5, chunk: int = 8):
    """The wavefront loop with periodic stat logging (Tracer::update,
    tracer.cpp:250-294), ``chunk`` segments a step. With ``max_spp`` the
    config's spp cap is on and the loop stops when every pixel has it:
    one read of the least spp per step (padded slots are parked at 2^29,
    so the least is over the true pixels)."""
    renderer.init_wavefront()

    def snapshot():
        st = renderer.wavefront_stats()
        return (int(st.primary_rays), int(st.extension_rays),
                int(st.shadow_rays), int(st.samples))

    def stop():
        return max_spp > 0 and \
            int(renderer._wf_state.spp.min()) >= max_spp

    elapsed, tot, csv_rows = _timed_loop(
        snapshot, lambda: renderer.render_wavefront(chunk, sync=True),
        stop, scene_name, max_time, log_interval)
    renderer.film = renderer.wavefront_film()
    renderer.stats = renderer.stats + renderer.wavefront_stats()
    npix = max(1, renderer.config.num_pixels)
    return _averages(tot, elapsed, tot[3] // npix), csv_rows


def _render_scene_timed(renderer: Renderer, settings: Settings,
                        max_time: float, max_spp: int, scene_name: str,
                        log_interval: float = 0.5):
    """Route by ``useWavefront`` (settings.cpp, honored in
    Tracer::update): the wavefront is the throughput path, otherwise the
    spp-stepped renderSingle loop."""
    if settings.use_wavefront:
        return _render_timed_wavefront(renderer, max_time, max_spp,
                                       scene_name, log_interval)
    return _render_timed(renderer, max_time, max_spp, scene_name,
                         log_interval)


def _render_timed(renderer: Renderer, max_time: float, max_spp: int,
                  scene_name: str, log_interval: float = 0.5):
    """The renderSingle loop, one spp a step, with periodic stat
    logging."""
    state = dict(spp=0)

    def snapshot():
        st = renderer.stats
        return (int(st.primary_rays), int(st.extension_rays),
                int(st.shadow_rays), int(st.samples))

    def step():
        renderer.render_single(spp=1)
        state["spp"] += 1

    elapsed, tot, csv_rows = _timed_loop(
        snapshot, step,
        lambda: max_spp > 0 and state["spp"] >= max_spp,
        scene_name, max_time, log_interval)
    return _averages(tot, elapsed, state["spp"]), csv_rows


def _warm_up(r: Renderer, s: Settings):
    """Two segments (or one spp, then a reset) before the timed loop."""
    if s.use_wavefront:
        r.init_wavefront()
        r.render_wavefront(2)
    else:
        r.render_single(spp=1)
        r.reset()


def _scene_files_exist(path: str) -> bool:
    """Whether ``path`` and, for a ``.sc.json``, every model it lists
    exist."""
    if not os.path.exists(path):
        return False
    if not path.endswith(".sc.json"):
        return True
    folder = os.path.dirname(path)
    with open(path) as f:
        entries = json.load(f)
    return all(os.path.exists(os.path.join(folder, e["file"]))
               for e in entries)


def run_benchmark(scenes=None, width=1024, height=1024, seconds=30.0,
                  settings: Optional[Settings] = None, asset_root=".",
                  device=None):
    """The fixed protocol (tracer.cpp:391-565): 1024x1024, 30 s a scene,
    on ``device`` (the Renderer's default: CUDA). A missing scene takes
    its stand-in when every file of the stand-in exists (ROADMAP C9: the
    reference takes a stand-in whose models are missing and raises), and
    is skipped otherwise."""
    results = []
    for scene_file in (scenes or FIXED_SCENES):
        path = os.path.join(asset_root, scene_file)
        if not os.path.exists(path) and scene_file in FIXED_FALLBACKS:
            fb = FIXED_FALLBACKS[scene_file]
            fb_path = os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))), fb)
            if _scene_files_exist(fb_path):
                print(f"{scene_file} missing -> stand-in {fb}")
                scene_file, path = fb, fb_path
        if not os.path.exists(path):
            print(f"skipping missing scene {path}")
            continue
        s = settings or Settings()
        r = Renderer(width, height, settings=s, device=device)
        r.load_scene(path)
        _warm_up(r, s)
        averages, rows = _render_scene_timed(r, s, seconds, 0, scene_file)
        print(f"{scene_file}: {averages['primary']:.1f}M primary, "
              f"{averages['extension']:.2f}M extension, "
              f"{averages['shadow']:.2f}M shadow, "
              f"{averages['samples']:.2f}M samples, "
              f"total: {averages['total']:.2f}M rays/s")
        results.append(BenchmarkResult(scene_file, averages, rows))
    return results


def run_benchmark_file(path: str, device=None):
    """A benchmark from a ``.bm.json`` file (tracer.cpp:567-873), on
    ``device`` (the Renderer's default: CUDA); its renderers keep their
    caches under ``data`` in the working directory, as the CLI's."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        spec = json.load(f)

    out_folder = os.path.join(base, spec.get("outputFolder", "benchmark_out"))
    os.makedirs(out_folder, exist_ok=True)

    csv_lines = [CSV_HEADER]
    txt_lines = []
    results = []

    for entry in spec.get("scenes", []):
        if isinstance(entry, str):
            entry = {"file": entry}
        s = Settings()
        s.import_json(spec.get("settings", {}))
        s.import_json(entry.get("settings", {}))

        scene_path = entry["file"]
        if not os.path.isabs(scene_path):
            scene_path = os.path.join(base, scene_path)
        if not os.path.exists(scene_path):
            print(f"skipping missing scene {scene_path}")
            continue
        name = os.path.splitext(os.path.basename(scene_path))[0]

        r = Renderer(s.window_width, s.window_height, settings=s,
                     device=device)
        env = s.env_map_name
        if env and not os.path.isabs(env):
            cand = os.path.join(base, env)
            env = cand if os.path.exists(cand) else env
        r.load_scene(scene_path, env_map=env if env and os.path.exists(env)
                     else None)
        _warm_up(r, s)

        averages, rows = _render_scene_timed(r, s, s.max_render_time,
                                             s.max_spp, name)
        for row in rows:
            csv_lines.append(";".join(str(x) for x in row))
        line = (f"{name}: {averages['primary']:.1f}M primary, "
                f"{averages['extension']:.2f}M extension, "
                f"{averages['shadow']:.2f}M shadow, "
                f"{averages['samples']:.2f}M samples, "
                f"total: {averages['total']:.2f}M rays/s "
                f"({averages['spp']} spp in {averages['elapsed']:.1f}s)")
        print(line)
        txt_lines.append(line)

        if not spec.get("skipPP", False):
            r.save_image(os.path.join(out_folder, name + ".png"))
        r.save_image(os.path.join(out_folder, name + ".hdr"))
        results.append(BenchmarkResult(name, averages, rows))

    with open(os.path.join(out_folder, "results.csv"), "w") as f:
        f.write("\n".join(csv_lines) + "\n")
    with open(os.path.join(out_folder, "results.txt"), "w") as f:
        f.write("\n".join(txt_lines) + "\n")
    return results
