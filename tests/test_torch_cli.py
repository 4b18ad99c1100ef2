"""The port's CLI (python -m fluctus_tpu_torch) in process on the CPU
(FLT_FORCE_CPU=1), on luxball at 32x16 with a settings.json of a small
pool and depth, in a temporary working directory:

  -s                 an exact-spp render: the .png and .hdr written (the
                     .hdr is the image Renderer.render_single gives), the
                     checkpoint and the render state saved under data/
  --wavefront        a second run loads that state ("Loaded render
                     state"), resumes the checkpoint, writes its preview
                     frames every --preview-every segments and the image;
                     the maxSpp stop
  options            the reference CLI's option names and defaults
  not ported         --benchmark, .bm.json inputs, --serve and
                     --interactive exit with status 2 and a message,
                     writing nothing
"""

import json
import os
import re

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import __main__ as jcli

from fluctus_tpu_torch import __main__ as cli
from fluctus_tpu_torch import state_io
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.scene import Scene
from fluctus_tpu_torch.settings import Settings

LUXBALL = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "data", "luxball", "luxball.obj"))
RELEASE = {"wfBufferSize": 2048, "maxPathDepth": 3,
           "camera": {"pos": [0.0, 1.6, 4.5], "dir": [0.0, -0.12, -1.0]},
           "areaLight": {"pos": [0.0, 4.0, 0.0], "N": [0.0, -1.0, 0.0],
                         "E": [50.0]}}


@pytest.fixture
def job(tmp_path, monkeypatch):
    """A working directory with settings.json, FLT_FORCE_CPU=1 set."""
    monkeypatch.setenv("FLT_FORCE_CPU", "1")
    monkeypatch.chdir(tmp_path)

    def write(release):
        (tmp_path / "settings.json").write_text(json.dumps(
            {"release": release, "debug": {}}))
    write(RELEASE)
    return tmp_path, write


def test_spp_then_wavefront_resume(job, capsys):
    d, _ = job
    assert cli.main([LUXBALL, "-x", "32", "-y", "16", "-s", "2",
                     "--save-state", "--checkpoint", "ck.npz",
                     "-o", "out.png"]) == 0
    out = capsys.readouterr().out
    h = Scene()
    h.load_model(LUXBALL)
    state = state_io.state_path("data", h.hash)
    assert f"saved state: {state}" in out and "wrote out.png" in out
    assert "checkpoint: ck.npz" in out and "Rendered: 2/2" in out
    assert re.search(r": 2 spp in [\d.]+s -> [\d.]+ MRays/s", out)
    assert {"out.png", "out.hdr", "ck.npz", "data"} <= set(os.listdir(d))
    assert (d / "out.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the .hdr is the API's image of the same job
    r = Renderer(32, 16, settings=Settings.load("settings.json"),
                 data_dir=str(d / "api"), device="cpu")
    r.load_scene(LUXBALL)
    r.render_single(2)
    r.save_image(str(d / "want.hdr"))
    assert (d / "out.hdr").read_bytes() == (d / "want.hdr").read_bytes()
    # the state file: the settings the job ran with
    loaded = Settings()
    assert state_io.load_state(state, loaded) == (1.0, 1.0)
    assert loaded.max_path_depth == 3
    assert loaded.area_light.E == (50.0, 50.0, 50.0)

    assert cli.main([LUXBALL, "-x", "32", "-y", "16", "--wavefront", "5",
                     "--preview-every", "2", "--tasks", "2048",
                     "--checkpoint", "ck.npz", "-o", "wf.png"]) == 0
    out = capsys.readouterr().out
    assert f"Loaded render state: {state}" in out
    assert "resumed checkpoint: ck.npz" in out
    assert re.search(r"\[2/5\] .* MRays/s  avg spp [\d.]+  -> wf_f0001.png",
                     out)
    assert re.search(r": 5 segments in [\d.]+s -> [\d.]+ MRays/s", out)
    frames = sorted(f for f in os.listdir(d) if f.startswith("wf_f"))
    assert frames == ["wf_f0001.png", "wf_f0002.png"]
    assert {"wf.png", "wf.hdr"} <= set(os.listdir(d))
    # the resumed film holds the checkpoint's samples and more
    w = np.load("ck.npz")["weight"]
    assert w.min() >= 2 and w.sum() > 2 * 32 * 16


def test_max_spp_stop(job, capsys):
    _, write = job
    write({**RELEASE, "maxSpp": 1})
    assert cli.main([LUXBALL, "-x", "32", "-y", "16", "--wavefront", "40",
                     "--preview-every", "4", "--tasks", "2048",
                     "-o", "wf.png"]) == 0
    out = capsys.readouterr().out
    assert "maxSpp (1) reached" in out
    m = re.search(r": 40 segments", out)
    assert m is not None       # the summary names the requested count


def _options(help_text):
    return sorted(set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", help_text)))


def test_options_match_reference(capsys):
    """The reference CLI's options, each with its default."""
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["--help"])
    ours, theirs = capsys.readouterr().out.split("usage: fluctus_tpu ")
    assert _options(ours) == _options(theirs)
    a = cli._parser().parse_args([])
    assert (a.width, a.height, a.spp, a.wavefront, a.tasks, a.settings) == \
        (1024, 768, 0, 0, 1 << 20, "settings.json")


@pytest.mark.parametrize("args", [["--benchmark"], ["x.bm.json"],
                                  ["--serve", "8080", LUXBALL],
                                  ["--interactive", LUXBALL]])
def test_unported_options_exit_nonzero(job, capsys, args):
    d, _ = job
    assert cli.main(args) == 2
    err = capsys.readouterr().err
    assert "is not ported" in err
    assert sorted(os.listdir(d)) == ["settings.json"]
