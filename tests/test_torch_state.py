"""The port's saved render state (state_io.py) and the Renderer's use of
it against the JAX package, on the CPU:

  load_state      both packages on the repository's
                  data/states/state_10690531631905968616.dat: every field
                  and the returned (env map strength, exposure) equal
  save_state      the port's bytes equal the reference's on the same
                  Settings (defaults, and every state field moved); a file
                  written by either reads back in the other field for
                  field
  load_scene      a saved state under luxball's hash in a temporary
                  data_dir: the port's RenderParams and config flags equal
                  the reference's (the reference's renderer.py:82-90,
                  including its use_env_map deciding the env map), with
                  the "Loaded render state" line; use_saved_state=False
                  ignores it; Renderer.save_state writes the reference's
                  bytes where load_scene looks
  render_scale    the film of Renderer(w, h) is w * scale x h * scale, as
                  the reference's; resize and reload_materials re-derive
                  the config and restart the accumulation
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import state_io as jstate
from fluctus_tpu.renderer import Renderer as JRenderer
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.settings import Settings as JSettings

from fluctus_tpu_torch import state_io as tstate
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

ROOT = os.path.join(os.path.dirname(__file__), "..")
STATE = os.path.join(ROOT, "data", "states", "state_10690531631905968616.dat")
LUXBALL = os.path.join(ROOT, "data", "luxball", "luxball.obj")


def _moved(s):
    """Every field a state file holds, away from its default."""
    c, a = s.camera, s.area_light
    c.camera_rotation = (12.5, -7.25)
    c.camera_speed = 2.5
    c.fov = 47.0
    c.focal_dist = 3.1
    c.aperture_size = 0.02
    c.dir = (0.0, -0.12, -1.0)
    c.pos = (0.0, 1.6, 4.5)
    c.right = (0.99, 0.0, 0.1)
    c.up = (0.0, 1.0, 0.0)
    a.N, a.pos = (0.0, -1.0, 0.0), (0.0, 4.0, 0.0)
    a.right, a.up = (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
    a.E, a.size = (50.0, 40.0, 30.0), (0.5, 0.25)
    s.max_path_depth = 6
    s.use_area_light = True
    s.use_env_map = False
    s.sample_explicit = False
    s.sample_implicit = True
    s.use_russian_roulette = True
    s.tonemap = 1
    return s


def _state_fields(s):
    d = dataclasses.asdict(s)
    keep = ("camera", "area_light", "max_path_depth", "use_area_light",
            "use_env_map", "sample_explicit", "sample_implicit",
            "use_russian_roulette", "tonemap")
    return {k: d[k] for k in keep}


def test_load_state_matches_reference():
    ours, ref = Settings(), JSettings()
    assert tstate.load_state(STATE, ours) == jstate.load_state(STATE, ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.use_env_map and not Settings().use_env_map


@pytest.mark.parametrize("moved", [False, True])
def test_save_state_bytes_and_cross_load(tmp_path, moved):
    ours = _moved(Settings()) if moved else Settings()
    ref = _moved(JSettings()) if moved else JSettings()
    strength, exposure = (2.5, 0.75) if moved else (1.0, 1.0)
    tstate.save_state(str(tmp_path / "port" / "s.dat"), ours, strength,
                      exposure)
    jstate.save_state(str(tmp_path / "ref" / "s.dat"), ref, strength,
                      exposure)
    port = (tmp_path / "port" / "s.dat").read_bytes()
    assert port == (tmp_path / "ref" / "s.dat").read_bytes()
    assert len(port) == 176
    a, b = JSettings(), Settings()
    assert jstate.load_state(str(tmp_path / "port" / "s.dat"), a) == \
        tstate.load_state(str(tmp_path / "ref" / "s.dat"), b) == \
        (strength, exposure)
    assert _state_fields(a) == _state_fields(b)
    # float32 fields read back rounded, the rest exactly
    got = _state_fields(b)
    assert got["camera"]["fov"] == ours.camera.fov
    assert got["area_light"]["E"] == ours.area_light.E
    assert got["camera"]["right"] == tuple(
        float(np.float32(x)) for x in ours.camera.right)
    assert {k: v for k, v in got.items()
            if k not in ("camera", "area_light")} == \
        {k: v for k, v in _state_fields(ours).items()
         if k not in ("camera", "area_light")}
    assert tstate.state_path("d", "42") == jstate.state_path("d", "42")


def _flat(tree, prefix=""):
    """A NamedTuple of tensors or arrays as {path: numpy array}."""
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _loaded(data_dir, state_src, js, ts, **kw):
    """Port and reference renderers on luxball at 32x16 with ``state_src``
    saved under luxball's hash in their own data_dir."""
    scene = JScene()
    scene.load_model(LUXBALL)
    out = []
    for pkg, settings, cls in (("port", ts, Renderer),
                               ("ref", js, JRenderer)):
        d = os.path.join(data_dir, pkg)
        if state_src:
            os.makedirs(os.path.join(d, "states"))
            shutil.copy(state_src, jstate.state_path(d, scene.hash))
        extra = dict(device="cpu") if pkg == "port" else {}
        r = cls(32, 16, settings=settings, data_dir=d, **extra)
        r.load_scene(LUXBALL, **kw)
        out.append(r)
    return out


@pytest.mark.parametrize("which", ["repository", "moved"])
def test_load_scene_applies_saved_state(tmp_path, capsys, which):
    """C3: with a saved state under the scene's hash, the port's
    load_scene renders with it as the reference's does: the same
    RenderParams (camera, light, env map strength, exposure, tonemap)
    and config flags, the state's use_env_map deciding the env map."""
    src = STATE
    if which == "moved":
        src = str(tmp_path / "moved.dat")
        jstate.save_state(src, _moved(JSettings()), 2.5, 0.75)
    r, jr = _loaded(str(tmp_path), src, JSettings(), Settings())
    out = capsys.readouterr().out
    assert out.count("Loaded render state: ") == 2
    ours, theirs = _flat(r.params), _flat(jr.params)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    for k in ("max_bounces", "use_env_map", "use_area_light", "sample_impl",
              "sample_expl", "use_roulette"):
        assert getattr(r.config, k) == getattr(jr.config, k), k
    if which == "moved":
        assert r.config.max_bounces == 6 and r.config.use_roulette
        assert not r.config.sample_expl
        assert float(r.params.env_map_strength) == 2.5
        assert float(r.params.pp.exposure) == 0.75
        assert r.params.pp.tm_operator == 1
        assert r.settings.camera.fov == 47.0
    else:
        # the file's use_env_map is on, but luxball has no env map
        assert r.settings.use_env_map and not r.config.use_env_map


def test_use_saved_state_false_ignores_it(tmp_path, capsys):
    src = str(tmp_path / "moved.dat")
    jstate.save_state(src, _moved(JSettings()), 2.5, 0.75)
    r, jr = _loaded(str(tmp_path), src, JSettings(), Settings(),
                    use_saved_state=False)
    assert "Loaded render state" not in capsys.readouterr().out
    assert r.config.max_bounces == Settings().max_path_depth
    assert float(r.params.env_map_strength) == 1.0
    assert r.settings.camera.fov == Settings().camera.fov


def test_renderer_save_state_round_trip(tmp_path, capsys):
    """Renderer.save_state writes the reference's bytes under the scene's
    hash; a new Renderer's load_scene then restores it."""
    s, js = _moved(Settings()), _moved(JSettings())
    r, jr = _loaded(str(tmp_path), None, js, s)
    r.env_map_strength = jr.env_map_strength = 3.0
    path, jpath = r.save_state(), jr.save_state()
    assert path == tstate.state_path(str(tmp_path / "port"), r.scene.hash)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    capsys.readouterr()
    r2 = Renderer(32, 16, data_dir=str(tmp_path / "port"), device="cpu")
    r2.load_scene(LUXBALL)
    assert capsys.readouterr().out.startswith(f"Loaded render state: {path}")
    back = JSettings()
    jstate.load_state(jpath, back)
    assert _state_fields(r2.settings) == _state_fields(back)
    assert float(r2.params.env_map_strength) == 3.0
    assert r2.config.max_bounces == 6 and r2.config.use_roulette


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_render_scale_resize_reload(tmp_path, scale):
    """Renderer(w, h) films w * render_scale x h * render_scale (the
    reference's renderer.py:44-45); resize() re-derives the pixel-bound
    config as the reference's does and restarts the accumulation;
    reload_materials re-uploads edited materials (their tables rebuilt
    under a new cache key) and restarts it too."""
    s, js = Settings(), JSettings()
    s.render_scale = js.render_scale = scale
    s.wf_buffer_size = js.wf_buffer_size = 1024
    s.use_denoiser = True
    r = Renderer(32, 16, settings=s, data_dir=str(tmp_path / "port"),
                 device="cpu")
    jr = JRenderer(32, 16, settings=js, data_dir=str(tmp_path / "ref"))
    assert (r.width, r.height) == (jr.width, jr.height) == \
        (int(32 * scale), int(16 * scale))
    r.load_scene(LUXBALL)
    jr.load_scene(LUXBALL)
    assert (r.config.width, r.config.height) == (jr.config.width,
                                                 jr.config.height)
    assert r.film.weight.shape[0] == jr.film.weight.shape[0]
    assert r.features.normal_w.shape[0] == r.config.num_pixels
    r.init_wavefront(1024)
    r.render_wavefront(2)
    r.resize(24, 12)
    jr.resize(24, 12)
    assert (r.width, r.height, r.config.num_pixels) == \
        (jr.width, jr.height, jr.config.num_pixels) == (24, 12, 288)
    assert r.config.groups == jr.config.groups
    assert r._wf_state is None and float(r.film.weight.sum()) == 0
    np.testing.assert_allclose(float(r.params.camera.fov_scale),
                               float(jr.params.camera.fov_scale), rtol=1e-6)
    r.render_single(1)
    assert float(r.film.weight.min()) == 1.0
    tables = os.listdir(tmp_path / "port" / "mxu_tables")
    before = r.device_scene.mxu.b16r.clone()
    r.scene.materials[2].Kd = (0.9, 0.1, 0.1)   # the ball's core
    r.reload_materials()
    assert len(os.listdir(tmp_path / "port" / "mxu_tables")) == \
        len(tables) + 1
    assert not torch.equal(before, r.device_scene.mxu.b16r)
    assert float(r.film.weight.sum()) == 0 and r.features is not None
    assert r.config.material_types == r.scene.material_types
