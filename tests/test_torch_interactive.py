"""The port's REPL (fluctus_tpu_torch.interactive) against the JAX
package's on the CPU: luxball at 32x16 with a 2048-path pool, depth 2,
the teapot env map loaded, one script through both run_interactive.

The reference's Renderer takes its TPU route (the MXU tables and the
block-ring config that it derives on a TPU, patched into
_upload_device_scene and _derive_config, so scene loads, material edits
and resizes keep it), its kernels in interpret mode.

  (a) session    camera moves, look, speed, fov, more, tonemap, exposure,
                 rr, maxspp, depth, aperture, the three arealight edits,
                 sampling and light: the returned count, every Settings
                 field, the config's switches, the counters and the film
                 weights exact; rgb rtol 1e-5 (atol 1e-6); the frame's
                 pixels within 1 LSB; the mats lines byte-equal
  (b) integrator mk / more 2 / integrator wf, held the same way
  (c) a mat edit, scene 2 (the 2x2 grid from settings.shortcuts), pick,
      scale, denoise 1 and blend 0.25: Settings, focal distance, film
      size and the files equal to the reference's; the grid's film (the
      reference's route to its supercluster trace is not injected) is
      bit-equal to the port's own direct render of the same settings, and
      the denoised frame to the port's save_denoised
  (d) C7 and C8, two faults of the reference repaired in the port: with
      preview 1 the port's frame is the preview film's image (the
      reference's is the accumulation's); load restores the state file's
      env map strength and exposure (the reference keeps the live ones)
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import interactive as jinteractive
from fluctus_tpu.accel import mxu_trace as jmt
from fluctus_tpu.core import block_splat as jbs
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.settings import Settings as JSettings

from fluctus_tpu_torch import interactive
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

from test_torch_wavefront import reference_kernels  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LUXBALL = os.path.join(ROOT, "data", "luxball", "luxball.obj")
GRID = os.path.join(ROOT, "fluctus_tpu_torch", "scenes",
                    "luxball_grid_2x2.sc.json")
ENV = os.path.join(ROOT, "gallery", "teapot_wavefront.hdr")
W, H, PATHS = 32, 16, 2048
SWITCHES = ("width", "height", "max_bounces", "use_env_map",
            "use_area_light", "sample_impl", "sample_expl", "use_roulette",
            "max_spp", "denoiser", "block_ring", "groups")


def read_png(path):
    """The [H, W, 3] uint8 pixels of a PNG (PIL: the reference's writer
    filters its rows, the port's does not)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def settings(cls):
    s = cls()
    s.camera.pos, s.camera.dir = (0.0, 1.6, 4.5), (0.0, -0.12, -1.0)
    s.camera.camera_speed = 0.5
    a = s.area_light
    a.pos, a.N, a.right, a.up = (0, 4, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E = (50.0, 50.0, 50.0)
    s.max_path_depth = 2
    s.wf_buffer_size = PATHS
    s.shortcuts = {2: GRID}
    return s


@pytest.fixture
def reference_route(monkeypatch, reference_kernels):  # noqa: F811
    """The reference's TPU route on the CPU (see the module docstring):
    its dispatch, as on the TPU, takes the supercluster trace past
    SC_THRESHOLD clusters and the flat one below, both in interpret
    mode."""
    def dispatch(o4, d4, tmax_col, scene, any_hit, ray_tile, interpret):
        if scene.n_clusters > jmt.SC_THRESHOLD:
            return jmt._trace_rol_sc(
                o4, d4, tmax_col, scene.t12, scene.cluster_box,
                scene.sc_box, (scene.n_superclusters, scene.cluster_size),
                any_hit, jmt.ROL_TILE, True)
        return jmt._trace_rol(o4, d4, tmax_col, scene.t12, scene.cluster_box,
                              (scene.n_clusters, scene.cluster_size), any_hit,
                              jmt.ROL_TILE, True)
    monkeypatch.setattr(jmt, "_dispatch_trace", dispatch)
    fetch = jbs.fetch
    monkeypatch.setattr(jbs, "fetch",
                        lambda *a, **k: fetch(*a, **{**k, "interpret": True}))
    derive, upload = JRenderer._derive_config, JRenderer._upload_device_scene

    def derive_tpu(self, use_env):
        derive(self, use_env)
        c = self.config
        self.config = c.replace(backend="mxu", unroll_bounces=True,
                                block_ring=c.groups > 1
                                and self.settings.wf_block_ring)

    def upload_tpu(self, use_env):
        upload(self, use_env)
        p, n, uv, mid = self.scene.triangle_arrays()
        host, st = jmt.MXUScene.build(
            p, self._bvh_host, normals=n, uvs=uv, mat_ids=mid,
            materials=self.scene.materials,
            atlas=self.scene.device_textures(), return_host=True)
        self.device_scene = dataclasses.replace(
            self.device_scene, mxu=jmt.MXUScene._from_host(host, st))
    monkeypatch.setattr(JRenderer, "_derive_config", derive_tpu)
    monkeypatch.setattr(JRenderer, "_upload_device_scene", upload_tpu)


def renderers(tmp_path, scene=LUXBALL, env=ENV):
    """The port's and the reference's Renderer on ``scene``, each with a
    data_dir of its own."""
    r = Renderer(W, H, settings=settings(Settings),
                 data_dir=str(tmp_path / "port"), device="cpu")
    r.load_scene(scene, env_map=env)
    jr = JRenderer(W, H, settings=settings(JSettings),
                   data_dir=str(tmp_path / "ref"))
    jr.load_scene(scene, env_map=env)
    return r, jr


def session(run, renderer, script, out):
    """``run`` (either package's run_interactive) over ``script`` with its
    echo captured. Returns (count, echo lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        n = run(renderer, out_path=out, input_stream=io.StringIO(script),
                echo=True)
    return n, buf.getvalue().splitlines()


def both(r, jr, tmp_path, script, tag):
    """The script through both packages. Returns (count, echo lines, frame
    path) for the port, then for the reference."""
    ours = session(interactive.run_interactive, r, script,
                   str(tmp_path / f"{tag}_port.png"))
    theirs = session(jinteractive.run_interactive, jr, script,
                     str(tmp_path / f"{tag}_ref.png"))
    return (ours + (str(tmp_path / f"{tag}_port.png"),),
            theirs + (str(tmp_path / f"{tag}_ref.png"),))


def repl_lines(echo, frame):
    """The REPL's own echo lines (two-space indent), the frame's path
    replaced and the state file's path dropped (each package has its
    data_dir)."""
    return [ln.replace(frame, "<frame>") for ln in echo
            if ln.startswith("  ") and not ln.startswith("  saved: ")]


def check_echo(ours, theirs):
    (n, echo, frame), (jn, jecho, jframe) = ours, theirs
    assert n == jn
    lines = repl_lines(echo, frame)
    assert lines == repl_lines(jecho, jframe)
    assert not [ln for ln in lines if "error" in ln or "?" in ln]
    return lines


def check_state(r, jr):
    """Settings, config switches and counters exact."""
    assert dataclasses.asdict(r.settings) == dataclasses.asdict(jr.settings)
    assert (r.exposure, r.env_map_strength) == (jr.exposure,
                                                jr.env_map_strength)
    for k in SWITCHES:
        assert getattr(r.config, k) == getattr(jr.config, k), k
    assert list(r.wavefront_stats()) == [int(x)
                                         for x in jr.wavefront_stats()]


def check_film(film, jfilm):
    """Weights exact, rgb rtol 1e-5 (atol 1e-6)."""
    np.testing.assert_array_equal(film.weight.numpy(),
                                  np.asarray(jfilm.weight))
    np.testing.assert_allclose(
        np.stack([c.numpy() for c in film.color]),
        np.stack([np.asarray(c) for c in jfilm.color]), rtol=1e-5,
        atol=1e-6)


def check_frames(a, b):
    """Two PNG frames of one size, pixels within 1 LSB."""
    pa, pb = read_png(a).astype(int), read_png(b).astype(int)
    assert pa.shape == pb.shape
    assert np.abs(pa - pb).max() <= 1


SCRIPT_A = """spp 2
w
look 10 5
speed 0.25
s
fov 50
more 2
tonemap 2
exposure 1.5
rr 1
maxspp 3
depth 3
aperture 0.01
arealight size 0.8
arealight int 40
arealight color 1 0.5 0.25
sampling
light
mats
q
"""


def test_session_matches_reference(tmp_path, reference_route):
    r, jr = renderers(tmp_path)
    ours, theirs = both(r, jr, tmp_path, SCRIPT_A, "a")
    lines = check_echo(ours, theirs)
    assert ours[0] == 20
    assert sum(ln.startswith("  [") for ln in lines) == \
        len(r.scene.materials) > 0
    assert r.settings.camera.camera_speed == 0.25
    assert r.settings.area_light.E == (40.0, 20.0, 10.0)
    assert not r.settings.sample_implicit and r.settings.use_env_map
    assert r.config.use_roulette and r.config.max_spp == 3
    check_state(r, jr)
    check_film(r.film, jr.film)
    check_frames(ours[2], theirs[2])


def test_integrator_switch_matches_reference(tmp_path, reference_route):
    """integrator mk renders exact spp (render_single), more 2 adds two,
    integrator wf returns to free-running segments."""
    r, jr = renderers(tmp_path)
    ours, theirs = both(r, jr, tmp_path, "spp 2\nintegrator mk\nmore 2\nq\n",
                        "mk")
    check_echo(ours, theirs)
    assert ours[0] == 4
    assert r.preview_integrator == jr.preview_integrator == "mk"
    assert not r.settings.use_wavefront
    assert bool((r.film.weight == 4).all())
    check_state(r, jr)
    assert list(r.stats) == [int(x) for x in jr.stats]
    check_film(r.film, jr.film)
    check_frames(ours[2], theirs[2])

    ours, theirs = both(r, jr, tmp_path, "integrator wf\nq\n", "wf")
    check_echo(ours, theirs)
    assert r.preview_integrator == jr.preview_integrator == "wf"
    assert r.settings.use_wavefront
    check_state(r, jr)
    check_film(r.film, jr.film)
    check_frames(ours[2], theirs[2])


SCRIPT_C = """spp 2
mat 0 kd 0.8 0.2 0.2
scene 2
pick 0.5 0.5
scale 0.5
denoise 1
blend 0.25
q
"""


def test_scene_switch_and_denoiser_match_reference(tmp_path,
                                                   reference_route):
    r, jr = renderers(tmp_path)
    ours, theirs = both(r, jr, tmp_path, SCRIPT_C, "c")
    lines = check_echo(ours, theirs)
    assert ours[0] == 8
    assert f"  scene: {GRID} (22568 tris)" in lines
    assert (r.width, r.height) == (W // 2, H // 2)
    assert r.config.denoiser and r.features is not None
    assert r.device_scene.mxu.n_clusters > 96     # the grid's K5 route
    check_state(r, jr)
    check_film(r.film, jr.film)
    check_frames(ours[2], theirs[2])     # the denoised frame
    # the frame is save_denoised's image at blend 0.25
    r.save_denoised(str(tmp_path / "den.png"))
    assert (tmp_path / "den.png").read_bytes() == \
        open(ours[2], "rb").read()


def test_c7_preview_frame(tmp_path, reference_route):
    """preview 1, then light (the env map on: two segments of area light
    alone leave every finished path black): the port writes the preview
    film's image, whose spp its echo reports; the reference writes the
    accumulation's."""
    r, jr = renderers(tmp_path)
    ours, theirs = both(r, jr, tmp_path, "spp 2\npreview 1\nlight\nq\n",
                        "c7")
    check_echo(ours, theirs)
    acc = r.wavefront_film()
    assert bool((r.film.weight >= acc.weight).all())
    assert bool((r.film.weight > acc.weight).any())
    check_film(r.film, jr.film)                   # the preview films agree
    frame = open(ours[2], "rb").read()
    r.save_image(str(tmp_path / "film.png"), film=r.film)
    r.save_image(str(tmp_path / "acc.png"))
    assert frame == (tmp_path / "film.png").read_bytes()
    assert frame != (tmp_path / "acc.png").read_bytes()
    # the reference's frame is its accumulation's image
    jr.save_image(str(tmp_path / "jacc.png"))
    assert open(theirs[2], "rb").read() == \
        (tmp_path / "jacc.png").read_bytes()
    check_frames(theirs[2], str(tmp_path / "acc.png"))


def test_c8_load_restores_strength_and_exposure(tmp_path, reference_route):
    """save with env map strength 3 and exposure 2, change both, load: the
    port restores both from the state file, the reference keeps 1 and
    1."""
    from fluctus_tpu_torch import state_io
    r, jr = renderers(tmp_path)
    script = ("spp 1\nenvstrength 3\nexposure 2\nsave\nenvstrength 1\n"
              "exposure 1\nload\nq\n")
    ours, theirs = both(r, jr, tmp_path, script, "c8")
    assert ours[0] == theirs[0] == 8
    path = state_io.state_path(r.data_dir, r.scene.hash)
    assert state_io.load_state(path, Settings()) == (3.0, 2.0)
    assert (r.env_map_strength, r.exposure) == (3.0, 2.0)
    assert float(r.params.env_map_strength) == 3.0
    assert float(r.params.pp.exposure) == 2.0
    assert (jr.env_map_strength, jr.exposure) == (1.0, 1.0)
    assert dataclasses.asdict(r.settings) == dataclasses.asdict(jr.settings)
