"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its renderer needs CUDA unless asked for the CPU, and its kernel
wrappers take the plain version for CPU tensors only."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "fluctus_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fluctus_tpu_torch
for m in pkgutil.walk_packages(fluctus_tpu_torch.__path__,
                               "fluctus_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                    "fluctus_tpu"))
print(len([m for m in sys.modules if m.startswith("fluctus_tpu_torch")]))
print("bad:" + ",".join(bad))
"""


def test_import_leaves_out_jax():
    """Importing the package and every submodule, in a fresh interpreter
    (this process already holds JAX), loads no jax, jaxlib, ml_dtypes or
    fluctus_tpu module."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, check=True,
                         timeout=300)
    count, bad = out.stdout.strip().splitlines()
    assert int(count) >= 20
    assert bad == "bad:"


def test_source_scan():
    """No source of the port (nor chip_smoke.py) names the JAX package or
    imports JAX."""
    pat = re.compile(r"fluctus_tpu\.|from fluctus_tpu\b|import fluctus_tpu\b"
                     r"|import jax|from jax|import ml_dtypes")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            for no, line in enumerate(fh, 1):
                assert not pat.search(line), f"{f}:{no}: {line.strip()}"


def _names_ring(node):
    return any(isinstance(n, ast.Attribute) and n.attr == "block_ring"
               or isinstance(n, ast.Name) and n.id == "block_ring"
               for n in ast.walk(node))


def _ring_conditions(src):
    """Line numbers of the conditions in ``src`` that test ``block_ring``:
    an ``if``, a ternary, a ``while``, an ``assert``, a comprehension's
    filter or an ``and``/``or`` operand."""
    lines = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)):
            tests = [node.test]
        elif isinstance(node, ast.comprehension):
            tests = node.ifs
        elif isinstance(node, ast.BoolOp):
            tests = node.values
        else:
            continue
        lines.update(t.lineno for t in tests if _names_ring(t))
    return lines


def test_only_pixel_ring_branches_on_the_ring():
    """The pixel ring's decision has one owner: no module of the port but
    core/pixel_ring.py has a condition on ``block_ring``. Setting the
    field, by keyword or ``replace``, is allowed; the scan does find the
    owner's own conditions."""
    owner = os.path.join("core", "pixel_ring.py")
    found, owned = [], set()
    for rel, src in _sources(PKG):
        lines = _ring_conditions(src)
        if rel == owner:
            owned = lines
        else:
            found += [f"{rel}:{no}" for no in sorted(lines)]
    assert owned
    assert not found, found


_KNOB = re.compile(r"env(?:_bool|_int)?\(\s*[\"']([A-Z0-9_]+)[\"']")


def _sources(root):
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(d, n)) as fh:
                    yield os.path.relpath(os.path.join(d, n), root), fh.read()


def test_no_knob_the_reference_lacks():
    """Every FLT_* override the port reads is one the JAX package reads; the
    port reads no other environment variable but the CUDA toolkit's
    location; and its Settings, CameraSettings and AreaLightSettings have
    exactly the JAX package's fields, with the same defaults. So K10's
    route is reached through the tables' content alone."""
    import dataclasses
    import inspect
    from fluctus_tpu import settings as jsettings
    from fluctus_tpu_torch import kernel_build
    from fluctus_tpu_torch import settings as tsettings
    ref = set()
    for _, text in _sources(os.path.join(ROOT, "fluctus_tpu")):
        ref |= set(_KNOB.findall(text))
    ours = set()
    readers = set()
    for path, text in _sources(PKG):
        ours |= set(_KNOB.findall(text))
        if "os.environ" in text or "getenv(" in text:
            readers.add(path)
    assert {"SORT_RAYS", "ROL", "FORCE_MK", "SEED_SALT"} <= ours
    assert ours <= ref, ours - ref
    # outside flags.py only nvcc_path reads the environment: the CUDA
    # toolkit's location (CUDA_HOME, CUDA_PATH), not a switch
    assert readers == {"flags.py", "kernel_build.py"}, readers
    src = inspect.getsource(kernel_build)
    fn = inspect.getsource(kernel_build.nvcc_path)
    assert "os.environ" not in src.replace(fn, "")
    assert set(re.findall(r'"([A-Z_]+)"', fn)) == {"CUDA_HOME", "CUDA_PATH"}

    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}
    for ours_cls, ref_cls in ((tsettings.Settings, jsettings.Settings),
                              (tsettings.CameraSettings,
                               jsettings.CameraSettings),
                              (tsettings.AreaLightSettings,
                               jsettings.AreaLightSettings)):
        mine, theirs = fields(ours_cls), fields(ref_cls)
        assert set(mine) == set(theirs), (ours_cls.__name__,
                                          set(mine) ^ set(theirs))
        for name, default in mine.items():
            if not dataclasses.is_dataclass(default):
                assert default == theirs[name], name


def test_renderer_requires_cuda(monkeypatch, tmp_path):
    """Without CUDA the renderer raises unless the caller asks for the
    CPU; there is no silent fallback."""
    from fluctus_tpu_torch.renderer import Renderer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(16, 16, data_dir=d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(16, 16, data_dir=d, device="cuda")
    assert Renderer(16, 16, data_dir=d, device="cpu").device.type == "cpu"


def test_wrappers_route_by_device():
    """CPU tensors run the plain version (counted as such, no launch);
    tensors on any other non-CUDA device are refused."""
    from fluctus_tpu_torch import kernel_build as kb
    from fluctus_tpu_torch.core import block_splat as bs
    kb.reset_counts()
    local = torch.tensor([0, -1, 1, 0], dtype=torch.int32)
    data = torch.ones((4, 4))
    film = torch.zeros((4, 2 * 128))
    out = bs.splat(local, data, film, groups=2)
    assert out[3, 0] == 1.0 and out[3, 1] == 0.0 and out[3, 128] == 1.0
    assert bs.K4.plain_runs == 1 and bs.K4.launches == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        bs.splat(local.to("meta"), data.to("meta"), film.to("meta"),
                 groups=2)
    from fluctus_tpu_torch.accel import mxu_trace as mt
    col = torch.tensor([0, -1], dtype=torch.int32)
    rays = torch.zeros((2, 4))
    b16r = torch.zeros((1, 128), dtype=torch.bfloat16)
    t16r = torch.zeros((1, 16))
    assert mt.resolve_v5s(col, rays, rays, b16r, t16r).shape == (40, 2)
    assert mt.K6.plain_runs == 1 and mt.K6.launches == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        mt.resolve_v5s(*(t.to("meta") for t in (col, rays, rays, b16r,
                                                 t16r)))
    assert set(kb.KERNELS) == {"tile_order", "trace_rol", "resolve_v5",
                               "block_splat", "trace_rol_sc", "resolve_v5s",
                               "block_splat_capped", "fetch", "trace_ros",
                               "resolve_v1", "bvh_bitstack",
                               "surface_shade"}
    rem = torch.zeros((1, 2 * 128))
    assert bs.splat(local, data, film, groups=2, remaining=rem).sum() == 0
    assert bs.fetch(local, film[3:], groups=2).shape == (4,)
    assert (bs.K7.plain_runs, bs.K8.plain_runs, bs.K4.plain_runs) == (1, 1, 1)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        bs.fetch(local.to("meta"), film[3:].to("meta"), groups=2)


def test_helpers_require_a_device():
    """The constructors of render state take the device as a required
    keyword: leaving it out is a TypeError, never a CPU default."""
    from fluctus_tpu_torch.core import integrator_wf as wf
    from fluctus_tpu_torch.geom import AreaLight, Camera, RenderConfig
    from fluctus_tpu_torch.scene import Scene
    from fluctus_tpu_torch.scene.material import (default_material,
                                                  materials_to_soa)
    cfg = RenderConfig(width=16, height=8, groups=4)
    calls = [
        lambda **k: wf.wf_reset(cfg, 64, **k),
        lambda **k: wf.wf_state_from_numpy(wf.wf_state_to_numpy(
            wf.wf_reset(cfg, 64, device="cpu")), **k),
        lambda **k: Camera.make((0, 0, 0), (0, 0, -1), (0, 1, 0), (1, 0, 0),
                                **k),
        lambda **k: AreaLight.make((0, 1, 0), (0, -1, 0), (1, 0, 0),
                                   (0, 0, 1), (1, 1, 1), (1, 1), **k),
        lambda **k: materials_to_soa([default_material()], **k),
        lambda **k: Scene().device_materials(**k),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="device"):
            call()
        call(device="cpu")


# ---------------------------------------------------------------------------
# Settings: the reference's fields, every render-changing switch rendered,
# and the params' life cycle
# ---------------------------------------------------------------------------

# a small scene: a floor of two triangles and one above it
_TINY_OBJ = """v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v -0.5 0.5 -0.5
v 0.5 0.5 -0.5
v 0 1 0
f 1 2 3
f 1 3 4
f 5 6 7
"""


def _tiny_scene(d):
    path = os.path.join(str(d), "tiny.obj")
    with open(path, "w") as f:
        f.write(_TINY_OBJ)
    return path


@pytest.fixture(scope="module")
def tiny_renderer(tmp_path_factory):
    from fluctus_tpu_torch.renderer import Renderer
    d = tmp_path_factory.mktemp("tiny")
    r = Renderer(32, 16, data_dir=str(d), device="cpu")
    r.load_scene(_tiny_scene(d))
    return r


# the render-changing switches, each set away from its default (the env
# map, Russian roulette and the sampling toggles, the denoiser and the
# render scale, the flat pixel ring), and two the reference reads and the
# port ignores (splat batching, and the cut of a segment into programs:
# each renders the same film): none is refused
_ACCEPTED = [("use_env_map", True), ("env_map_name", "sky.hdr"),
             ("use_area_light", False), ("use_russian_roulette", True),
             ("sample_implicit", False), ("sample_explicit", False),
             ("use_denoiser", True), ("denoiser_blend", 0.5),
             ("render_scale", 0.5), ("wf_block_ring", False),
             ("wf_splat_every", 4), ("wf_fused_shade", False)]
# the RenderConfig field each sampling switch (and the denoiser) sets
_CONFIG_FIELD = {"use_russian_roulette": "use_roulette",
                 "sample_implicit": "sample_impl",
                 "sample_explicit": "sample_expl",
                 "use_denoiser": "denoiser"}


def _light_flags(cfg):
    return (cfg.use_env_map, cfg.use_area_light, cfg.sample_impl,
            cfg.sample_expl, cfg.use_roulette)


@pytest.mark.parametrize("name,value", _ACCEPTED)
def test_load_scene_accepts_ported_switch(tmp_path, capsys, name, value):
    """load_scene takes every switch and sets the config's env map, area
    light and sampling flags as the reference's renderer does (a named map
    that is absent leaves the env map off with the reference's WARNING);
    wf_block_ring off puts the config on the flat pixel ring, where the
    port otherwise runs the block ring (the reference runs the flat ring
    off its TPU)."""
    from fluctus_tpu.renderer import Renderer as JRenderer
    from fluctus_tpu.settings import Settings as JSettings
    from fluctus_tpu_torch import settings as tsettings
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    assert not hasattr(tsettings, "UNPORTED")
    s, js = Settings(), JSettings()
    setattr(s, name, value)
    setattr(js, name, value)
    scene = _tiny_scene(tmp_path)
    r = Renderer(32, 16, settings=s, data_dir=str(tmp_path / "port"),
                 device="cpu")
    r.load_scene(scene)
    ours = capsys.readouterr().out
    jr = JRenderer(32, 16, settings=js, data_dir=str(tmp_path / "ref"))
    jr.load_scene(scene, use_saved_state=False)
    theirs = capsys.readouterr().out
    assert _light_flags(r.config) == _light_flags(jr.config)
    assert (r.width, r.height, r.config.denoiser) == \
        (jr.width, jr.height, jr.config.denoiser)
    assert (r.width, r.height) == ((16, 8) if name == "render_scale"
                                   else (32, 16))
    assert r.config.use_area_light == (name != "use_area_light")
    if name in _CONFIG_FIELD:
        assert getattr(r.config, _CONFIG_FIELD[name]) == value
    assert r.config.block_ring == (name != "wf_block_ring")
    assert not jr.config.block_ring
    assert not r.config.use_env_map and r.device_scene.env is None
    warn = "WARNING: env map not found: sky.hdr"
    assert (warn in ours) == (warn in theirs) == (name == "env_map_name")


@pytest.mark.parametrize("name,value", _ACCEPTED)
def test_rebuild_config_accepts_ported_switch(tiny_renderer, name, value):
    """rebuild_config takes the same switches and re-derives the env map,
    area-light and sampling flags from them, as the reference's
    rebuild_config; as the reference's, it leaves the pixel ring as
    load_scene chose it."""
    from fluctus_tpu_torch.settings import Settings
    r = tiny_renderer
    setattr(r.settings, name, value)
    try:
        r.rebuild_config()
        assert r.config.use_area_light == (name != "use_area_light")
        assert not r.config.use_env_map     # the scene has no env map
        assert r.config.block_ring
        if name in _CONFIG_FIELD:
            assert getattr(r.config, _CONFIG_FIELD[name]) == value
    finally:
        setattr(r.settings, name, getattr(Settings(), name))
        r.rebuild_config()
    assert _light_flags(r.config) == (False, True, True, True, False)


def test_envmap_modules_stand_alone():
    """The env map's modules (envmap.py, rgbe.py) load, in a fresh
    interpreter, no jax, jaxlib, ml_dtypes or fluctus_tpu module."""
    code = ("import sys; import fluctus_tpu_torch.envmap, "
            "fluctus_tpu_torch.rgbe; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'fluctus_tpu')))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


def test_material_modules_stand_alone():
    """The texture and GGX modules (scene/texture.py, texture_fetch.py,
    bsdf/ggx.py) load, in a fresh interpreter, no jax, jaxlib, ml_dtypes
    or fluctus_tpu module."""
    code = ("import sys; import fluctus_tpu_torch.scene.texture, "
            "fluctus_tpu_torch.texture_fetch, fluctus_tpu_torch.bsdf.ggx; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'fluctus_tpu')))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


_JSON = [
    {},
    {"platformName": "p", "deviceName": "d", "envMap": "sky.hdr",
     "renderScale": 0.5, "windowWidth": 800, "windowHeight": 600,
     "splitMode": "sbvh", "clUseBitstack": True, "clUseSoA": False,
     "wfBufferSize": 1 << 16, "useWavefront": True, "wfBlockRing": False,
     "wfPhases": False, "wfFusedShade": False, "wfSplatEvery": 3,
     "useRussianRoulette": True, "useSeparateQueues": True,
     "maxPathDepth": 4, "maxSpp": 16, "maxRenderTime": 30,
     "sampleImplicit": False, "sampleExplicit": False, "useEnvMap": True,
     "useAreaLight": False, "tonemap": 1,
     "shortcuts": {"1": "a.obj", "x": "ignored", "2": "b.obj"},
     "defaultScene": 2,
     "camera": {"pos": [1.0, 2.0, 3.0], "dir": [0.3, -0.2, -1.0],
                "fov": 45.0, "apertureSize": 0.1, "focalDist": 2.5,
                "cameraSpeed": 3.0},
     "areaLight": {"pos": [0.0, 3.0, 0.0], "N": [0.0, -1.0, 0.0],
                   "E": [20.0], "size": [0.25]}},
    {"camera": {"pos": [0.0, 1.0, 5.0], "lookAt": [1.0, 0.0, 0.0],
                "cameraRotation": [30.0, -10.0]},
     "areaLight": {"N": [1.0, 1.0, 0.0], "E": [1.0, 2.0, 3.0],
                   "size": [0.5, 0.75]}},
]


@pytest.mark.parametrize("case", range(len(_JSON)))
def test_settings_import_json_matches_reference(tmp_path, case):
    """Settings.import_json on a dict, and Settings.load of a settings.json
    with release and debug sections, give the JAX package's fields."""
    import dataclasses
    import json
    from fluctus_tpu import settings as jsettings
    from fluctus_tpu_torch import settings as tsettings
    ours, ref = tsettings.Settings(), jsettings.Settings()
    ours.import_json(_JSON[case])
    ref.import_json(_JSON[case])
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    path = tmp_path / "settings.json"
    path.write_text(json.dumps({"release": _JSON[case],
                                "debug": {"maxPathDepth": 2}}))
    for debug in (False, True):
        assert dataclasses.asdict(tsettings.Settings.load(str(path), debug)) \
            == dataclasses.asdict(jsettings.Settings.load(str(path), debug))


def test_init_wavefront_keeps_params(tmp_path):
    """A camera and light edit after load_scene: init_wavefront leaves the
    params as they were, as the reference's does; rebuild_config picks the
    edit up (and max_path_depth / max_spp into the config), giving the
    reference's camera and light."""
    import numpy as np
    from fluctus_tpu.renderer import Renderer as JRenderer
    from fluctus_tpu.settings import Settings as JSettings
    from fluctus_tpu_torch.renderer import Renderer
    from fluctus_tpu_torch.settings import Settings
    scene = _tiny_scene(tmp_path)
    ours = Renderer(32, 16, settings=Settings(),
                    data_dir=str(tmp_path / "a"), device="cpu")
    ref = JRenderer(32, 16, settings=JSettings(),
                    data_dir=str(tmp_path / "b"))

    def flat(params):
        c, a = params.camera, params.area_light
        return np.array([float(x) for v in (c.pos, c.dir, a.pos, a.E)
                         for x in v] + [float(c.fov)], np.float32)
    for r in (ours, ref):
        r.load_scene(scene)
        before = flat(r.params)
        s = r.settings
        s.camera.pos, s.camera.dir, s.camera.fov = ((0.5, 2.0, 4.0),
                                                    (0.0, -0.5, -1.0), 40.0)
        s.area_light.pos, s.area_light.E = (0.0, 3.0, 1.0), (7.0, 8.0, 9.0)
        s.max_path_depth, s.max_spp = 3, 5
        r.init_wavefront(512)
        np.testing.assert_array_equal(flat(r.params), before)
        r.rebuild_config()
        assert (r.config.max_bounces, r.config.max_spp) == (3, 5)
        assert not np.array_equal(flat(r.params), before)
    np.testing.assert_array_equal(flat(ours.params), flat(ref.params))


def test_job_modules_stand_alone():
    """The modules of a user's render job (the CLI, state_io, progress and
    core/denoise.py) and of its interactive session and harness
    (interactive, viewer, bench, profiling) load, in a fresh interpreter,
    no jax, jaxlib, ml_dtypes or fluctus_tpu module."""
    code = ("import sys; import fluctus_tpu_torch.__main__, "
            "fluctus_tpu_torch.state_io, fluctus_tpu_torch.progress, "
            "fluctus_tpu_torch.core.denoise, fluctus_tpu_torch.interactive, "
            "fluctus_tpu_torch.viewer, fluctus_tpu_torch.bench, "
            "fluctus_tpu_torch.bench.harness, fluctus_tpu_torch.profiling; "
            "print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'ml_dtypes', 'fluctus_tpu')))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "[]"


def test_cli_requires_cuda(monkeypatch, tmp_path):
    """The CLI without CUDA and without FLT_FORCE_CPU raises (the
    Renderer's refusal) before it loads the scene or writes anything;
    there is no route to the CPU but that switch."""
    from fluctus_tpu_torch.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FLT_FORCE_CPU", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([_tiny_scene(tmp_path), "-x", "32", "-y", "16", "-s", "1",
              "-o", "out.png"])
    assert sorted(os.listdir(tmp_path)) == ["tiny.obj"]
