"""The port's browser viewer (fluctus_tpu_torch.viewer) on the CPU: the
HTTP round trip of tests/test_viewer.py on luxball at 16x16 (a port found
free at test time), the widget state and the page's widgets against the
JAX package's, and `q` ending the session."""

import json
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch
from PIL import Image

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import viewer as jviewer
from fluctus_tpu.settings import Settings as JSettings

from fluctus_tpu_torch import viewer
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

from test_torch_interactive import LUXBALL

WIDGETS = ("integrator", "depth", "rr", "maxspp", "scale", "fov", "speed",
           "aperture", "tonemap", "exposure", "denoise", "blend",
           "envstrength", "al_size", "al_int", "al_color")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _edited(cls):
    s = cls()
    s.max_path_depth, s.use_russian_roulette, s.max_spp = 7, True, 12
    s.render_scale, s.tonemap, s.denoiser_blend = 0.5, 3, 0.3
    s.use_denoiser = True
    s.camera.fov, s.camera.camera_speed = 45.0, 2.5
    s.camera.aperture_size = 0.002
    s.area_light.size, s.area_light.E = (1.5, 1.5), (40.0, 20.0, 10.0)
    return s


@pytest.mark.parametrize("edited", [False, True], ids=["defaults", "edited"])
def test_widget_state_matches_reference(edited):
    """_widget_state of the same settings, exposure, env map strength and
    preview integrator: equal dicts, every widget id a key."""
    def holder(cls):
        return types.SimpleNamespace(
            settings=_edited(cls) if edited else cls(),
            exposure=1.7 if edited else 1.0,
            env_map_strength=2.5 if edited else 1.0,
            preview_integrator="mk" if edited else "wf")
    ours = viewer._widget_state(holder(Settings))
    assert ours == jviewer._widget_state(holder(JSettings))
    assert set(ours) == set(WIDGETS)
    if edited:
        assert ours["al_color"] == "#ff8040" and ours["al_int"] == 40.0


def test_page_carries_the_reference_widgets():
    """The page's element ids and the commands its widgets send are the
    reference page's."""
    ids = lambda page: sorted(re.findall(r'id="(\w+)"', page))
    cmds = lambda page: sorted(re.findall(r"cmd\('([^']*)'", page))
    ours, theirs = viewer._PAGE.format(log=""), jviewer._PAGE.format(log="")
    assert ids(ours) == ids(theirs)
    assert set(WIDGETS) <= set(ids(ours))
    assert cmds(ours) == cmds(theirs)


def test_viewer_http_roundtrip(tmp_path):
    """GET / (every widget), POST spp 1, w, depth 5, exposure 1.7, poll
    /state.json until both edits show, GET /frame.png, then q: the thread
    ends and serve returns 5."""
    s = Settings()
    s.camera.pos, s.camera.dir = (0.0, 1.6, 4.5), (0.0, -0.12, -1.0)
    s.max_path_depth = 2
    s.wf_buffer_size = 2048
    r = Renderer(16, 16, settings=s, data_dir=str(tmp_path / "data"),
                 device="cpu")
    r.load_scene(LUXBALL)
    out = str(tmp_path / "frame.png")
    ready = threading.Event()
    port = free_port()
    result = {}

    def run():
        result["n"] = viewer.serve(r, port=port, out_path=out,
                                   ready_event=ready)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(30)
    base = f"http://127.0.0.1:{port}"
    page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
    assert "fluctus_tpu_torch" in page
    for wid in WIDGETS:
        assert f'id="{wid}"' in page, f"missing widget {wid}"
    with pytest.raises(urllib.error.HTTPError):       # no frame yet: 404
        urllib.request.urlopen(base + "/frame.png", timeout=10)

    def post(cmd):
        data = urllib.parse.urlencode({"c": cmd}).encode()
        urllib.request.urlopen(base + "/cmd", data=data, timeout=120)

    post("spp 1")
    post("w")
    post("depth 5")
    post("exposure 1.7")
    deadline = time.time() + 150
    st = {}
    while time.time() < deadline:
        st = json.loads(urllib.request.urlopen(
            base + "/state.json", timeout=30).read())
        if st.get("depth") == 5 and abs(st.get("exposure", 0) - 1.7) < 1e-9:
            break
        time.sleep(0.2)
    assert st == viewer._widget_state(r)
    assert st["depth"] == 5 and st["integrator"] == "wf"
    frame = urllib.request.urlopen(base + "/frame.png", timeout=10)
    assert frame.headers["Content-Type"] == "image/png"
    with Image.open(frame) as im:
        assert im.size == (16, 16)

    # the q POST's redirect-follow GET races the server's shutdown
    try:
        post("q")
    except (urllib.error.URLError, OSError):
        pass
    t.join(180)
    assert not t.is_alive()
    assert result["n"] == 5
    assert r.settings.camera.pos[2] < 4.5        # the w ran
    with pytest.raises(OSError):                   # the server is closed
        urllib.request.urlopen(base + "/", timeout=5)
