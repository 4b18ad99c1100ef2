"""The port's benchmark harness (fluctus_tpu_torch.bench) against the JAX
package's on the CPU: a .bm.json of two luxball scenes at 32x16 with a
2048-path pool and depth 2, one on the wavefront (useWavefront, maxSpp 2)
and one by exact-spp steps (maxSpp 2), maxRenderTime 0 so both runs stop
at the same sample count.

  files        results.csv (its header byte-equal to the reference's),
               results.txt, <name>.png and <name>.hdr for each scene, in
               both packages
  results      the same scenes, averages keys and spp; the counters
               (rays and samples) equal to the reference's with its TPU
               route injected (test_torch_interactive.reference_route)
  films        each scene's film bit-equal to the port's own
               render_wavefront / render_single of the same settings
  fixed        run_benchmark at 16x16 for 1 s; FIXED_SCENES and
               FIXED_FALLBACKS equal to the reference's; with the assets
               absent the port skips all three scenes, where the
               reference takes a stand-in whose models are missing and
               raises (ROADMAP C9)
"""

import json
import os
import shutil

import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.bench import harness as jharness

from fluctus_tpu_torch.bench import harness
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

from test_torch_interactive import LUXBALL, reference_route  # noqa: F401
from test_torch_wavefront import reference_kernels  # noqa: F401

SPEC = {"settings": {"windowWidth": 32, "windowHeight": 16,
                     "wfBufferSize": 2048, "maxPathDepth": 2,
                     "maxRenderTime": 0, "maxSpp": 2,
                     "camera": {"pos": [0.0, 1.6, 4.5],
                                "dir": [0.0, -0.12, -1.0]},
                     "areaLight": {"pos": [0.0, 4.0, 0.0],
                                   "N": [0.0, -1.0, 0.0], "E": [50.0]}},
        "scenes": [{"file": "luxball.obj",
                    "settings": {"useWavefront": True}},
                   "exact/luxball_exact.obj"],
        "outputFolder": "out"}
KEYS = {"primary", "extension", "shadow", "samples", "total", "spp",
        "elapsed"}


def write_spec(folder):
    """The .bm.json and its two scene files (luxball under two names)."""
    os.makedirs(os.path.join(folder, "exact"))
    src = os.path.dirname(LUXBALL)
    shutil.copy(LUXBALL, os.path.join(folder, "luxball.obj"))
    shutil.copy(LUXBALL, os.path.join(folder, "exact", "luxball_exact.obj"))
    for d in (folder, os.path.join(folder, "exact")):
        shutil.copy(os.path.join(src, "luxball.mtl"), d)
    path = os.path.join(folder, "lux.bm.json")
    with open(path, "w") as f:
        json.dump(SPEC, f)
    return path


def recording(monkeypatch, module, cls, **kw):
    """Swap ``module.Renderer`` for a subclass of ``cls`` that keeps every
    instance (with ``kw`` added to its arguments). Returns the list."""
    made = []

    class Kept(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, **kw})
            made.append(self)
    monkeypatch.setattr(module, "Renderer", Kept)
    return made


def _direct(folder, scene, wavefront, segments):
    s = Settings()
    s.import_json(SPEC["settings"])
    r = Renderer(32, 16, settings=s, device="cpu",
                 data_dir=os.path.join(folder, "direct"))
    r.load_scene(os.path.join(folder, scene))
    if wavefront:
        r.init_wavefront()
        r.render_wavefront(segments)
        return r.wavefront_film()
    r.render_single(1)
    return r.render_single(1)


def test_bm_json_matches_reference(tmp_path, monkeypatch, reference_route):
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    made = recording(monkeypatch, harness, Renderer, device="cpu")
    jmade = recording(monkeypatch, jharness, jharness.Renderer)
    monkeypatch.chdir(tmp_path)          # the harness's data/ caches
    ours = harness.run_benchmark_file(write_spec(str(ours_dir)))
    theirs = jharness.run_benchmark_file(write_spec(str(ref_dir)))

    assert [x.scene for x in ours] == [x.scene for x in theirs] == \
        ["luxball", "luxball_exact"]
    for a, b in zip(ours, theirs):
        assert set(a.averages) == set(b.averages) == KEYS
        assert a.averages["spp"] == b.averages["spp"] == 2, a.scene
        assert a.averages["total"] > 0
    files = sorted(os.listdir(ours_dir / "out"))
    assert files == sorted(os.listdir(ref_dir / "out")) == [
        "luxball.hdr", "luxball.png", "luxball_exact.hdr",
        "luxball_exact.png", "results.csv", "results.txt"]
    head = (ours_dir / "out" / "results.csv").read_bytes().split(b"\n")[0]
    assert head == (ref_dir / "out" / "results.csv").read_bytes() \
        .split(b"\n")[0] == b"scene;time;primary;extension;shadow;total;samples"
    txt = (ours_dir / "out" / "results.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in txt] == ["luxball", "luxball_exact"]
    assert "(2 spp in " in txt[1]

    # the counters: the timed wavefront loop's, render_single's
    (wf, exact), (jwf, jexact) = made, jmade
    assert list(wf.wavefront_stats()) == [int(x)
                                          for x in jwf.wavefront_stats()]
    assert list(exact.stats) == [int(x) for x in jexact.stats]

    # the films: the port's own renders of the same settings
    segments = wf._wf_segments
    assert segments % 8 == 0 and bool((wf.film.weight >= 2).all())
    direct = _direct(str(ours_dir), "luxball.obj", True, segments)
    for a, b in zip((wf.film.weight, *wf.film.color),
                    (direct.weight, *direct.color)):
        assert torch.equal(a, b)
    assert bool((exact.film.weight == 2).all())
    direct = _direct(str(ours_dir), "exact/luxball_exact.obj", False, 0)
    for a, b in zip((exact.film.weight, *exact.film.color),
                    (direct.weight, *direct.color)):
        assert torch.equal(a, b)


def test_fixed_lists_match_reference():
    assert harness.FIXED_SCENES == jharness.FIXED_SCENES
    assert harness.FIXED_FALLBACKS == jharness.FIXED_FALLBACKS
    assert harness.CSV_HEADER == \
        "scene;time;primary;extension;shadow;total;samples"


def test_fixed_protocol_without_assets(tmp_path, monkeypatch, capsys):
    """The fixed scenes are absent here, and so are the models of the two
    stand-ins: the port skips the three scenes and returns no result; the
    reference takes the first stand-in and raises on its missing model
    (C9)."""
    monkeypatch.chdir(tmp_path)
    assert harness.run_benchmark(device="cpu") == []
    out = capsys.readouterr().out.splitlines()
    assert out == [f"skipping missing scene ./{f}"
                   for f in harness.FIXED_SCENES]
    with pytest.raises(FileNotFoundError):
        jharness.run_benchmark()
    assert "missing -> stand-in" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("wavefront", [False, True], ids=["exact", "wf"])
def test_fixed_protocol_runs(tmp_path, monkeypatch, capsys, wavefront):
    """run_benchmark on luxball at 16x16 for 1 s on either route: one
    result with every averages key, a timed run of about a second, the
    reference's summary line."""
    monkeypatch.chdir(tmp_path)
    s = Settings()
    s.import_json(SPEC["settings"])
    s.use_wavefront = wavefront
    res = harness.run_benchmark(scenes=[LUXBALL], width=16, height=16,
                                seconds=1.0, settings=s, device="cpu")
    assert len(res) == 1 and res[0].scene == LUXBALL
    av = res[0].averages
    assert set(av) == KEYS and av["total"] > 0 and av["spp"] >= 1
    assert 1.0 <= av["elapsed"] < 30
    out = capsys.readouterr().out
    assert f"{LUXBALL}: " in out and "M rays/s" in out
