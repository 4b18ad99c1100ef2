"""The port's PBRT loader and its parse cache against the JAX package's, on
``.pbrt`` files the tests write:

  Scene.load_model     the reference test's scene (tests/test_pbrt.py) and
                       one with a plymesh under Translate/Rotate/Scale, an
                       Include, ObjectBegin/ObjectInstance, a
                       Texture "imagemap" (a PNG written here), every
                       material class, remaproughness false, Transform /
                       ConcatTransform, the statements the loaders skip
                       and files that are missing: positions, normals,
                       uvs and material ids bit-equal, materials equal
                       field by field, the textures, camera_override and
                       hash equal (exact)
  the parse cache      the .flc.npz written by either package and read by
                       the other (exact); another source hash or version
                       misses; a folder that cannot be written skips it
  Renderer.load_scene  the file's camera, then a saved render state over
                       it, in both orders of events
  a wavefront run      4 segments of a PBRT scene against the reference's
                       (test_torch_texture.check_wavefront's tolerances)

Each package parses its own copy of a file, in a folder of its own, so
that neither reads the parse cache the other wrote unless a test asks.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bxdf_types as jbx
from fluctus_tpu.scene import Scene as JScene
from fluctus_tpu.scene import pbrt_loader as jpbrt_loader

from fluctus_tpu_torch import state_io
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.scene import Scene
from fluctus_tpu_torch.scene import pbrt_cache, pbrt_loader
from fluctus_tpu_torch.settings import Settings

from test_torch_ply import write_ply
from test_torch_texture import check_wavefront, scene_setup
from test_torch_wavefront import reference_kernels  # noqa: F401

HERE = os.path.dirname(__file__)
LUXBALL = os.path.join(HERE, "..", "data", "luxball", "luxball.obj")

# the reference's tests/test_pbrt.py scene
BASIC = """
LookAt 0 2 8   0 1 0   0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [64] "integer yresolution" [64]

WorldBegin

MakeNamedMaterial "redmatte" "string type" "matte" "rgb Kd" [0.8 0.1 0.1]

AttributeBegin
  Material "glass" "float index" [1.6]
  Translate 0 1 0
  Shape "trianglemesh"
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd

AttributeBegin
  NamedMaterial "redmatte"
  Scale 5 1 5
  Shape "trianglemesh"
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
    "normal N" [0 1 0  0 1 0  0 1 0  0 1 0]
    "float uv" [0 0  1 0  1 1  0 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd

AttributeBegin
  Material "metal" "float roughness" [0.05]
  Shape "trianglemesh"
    "point P" [-1 2 -1  1 2 -1  0 3 0]
    "integer indices" [0 1 2]
AttributeEnd

WorldEnd
"""

# every material class, the statements the loaders skip, and the
# reference's quirks (an ObjectBegin body emitted where it is defined,
# ObjectInstance skipped, a missing Include and plymesh skipped)
RICH = """# a comment line
LookAt 1 3 9  0 0.5 0  0 1 0   # the camera
Camera "perspective" "float fov" [ 38.5 ]
Sampler "halton" "integer pixelsamples" [16]
Integrator "path" "integer maxdepth" [5]
PixelFilter "box"
Accelerator "bvh"
Film "image" "string filename" ["out.exr"]
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [.1 .1 .1]
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.2 0.2]
Texture "checks" "spectrum" "imagemap" "string filename" ["tex/checks.png"]
Texture "missing" "spectrum" "imagemap" "string filename" ["none.png"]
Texture "noise" "float" "fbm" "float octaves" [4]
MakeNamedMaterial "shiny" "string type" "plastic"
  "rgb Kd" [0.2 0.3 0.4] "rgb Ks" [0.5 0.5 0.5] "float roughness" [0.02]
  "bool remaproughness" "false"
MakeNamedMaterial "checked" "string type" "matte" "texture Kd" "checks"
AttributeBegin
  NamedMaterial "checked"
  Translate 0 -0.5 0
  Rotate 30 0 1 0
  Scale 2 1 3
  Shape "plymesh" "string filename" "mesh.ply"
AttributeEnd
AttributeBegin
  Material "substrate" "rgb Kd" [0.6 0.2 0.1] "float uroughness" [0.1]
    "float vroughness" [0.3]
  Transform [1 0 0 0  0 1 0 0  0 0 1 0  0.5 0.25 -1 1]
  Shape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0 1 1 0]
    "integer indices" [0 1 2 2 1 3] "float st" [0 0 1 0 0 1 1 1]
AttributeEnd
AttributeBegin
  Material "uber" "float index" [1.33] "rgb Ks" [0.1 0.2 0.3]
    "float roughness" [0.4] "bool remaproughness" "false"
  ConcatTransform [0 1 0 0  -1 0 0 0  0 0 1 0  2 0 0 1]
  ReverseOrientation
  Shape "trianglemesh" "point P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "mirror" "rgb Kr" [0.8 0.8 0.7]
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0 4 0
  Shape "trianglemesh" "point P" [0 0 0 1 0 0 0 0 1] "integer indices" [0 1 2]
    "normal N" [0 -1 0 0 -1 0 0 -1 0]
AttributeEnd
AttributeBegin
  Material "glass" "rgb Kt" [0.9 0.95 1.0] "float index" [0]
  MediumInterface "fog" ""
  Shape "trianglemesh" "point P" [-1 0 -1 -1 1 -1 -1 0 0] "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
  Material "metal" "rgb eta" [0.2 0.92 1.1] "rgb k" [3.9 2.45 2.14]
    "float uroughness" [0.05] "float vroughness" [0.15]
  Scale 0.5 0.5 0.5
  Shape "trianglemesh" "point P" [0 0 2 1 0 2 0 1 2] "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
  Material "fourier" "string bsdffile" "x.bsdf"
  Shape "trianglemesh" "point P" [3 0 0 4 0 0 3 1 0] "integer indices" [0 1 2]
AttributeEnd
ObjectBegin "tri"
  Material "matte" "rgb Kd" [0.1 0.9 0.1]
  Shape "trianglemesh" "point P" [0 0 -3 1 0 -3 0 1 -3] "integer indices" [0 1 2]
ObjectEnd
AttributeBegin
  Translate 5 0 0
  ObjectInstance "tri"
AttributeEnd
TransformBegin
  Identity
  Scale 2 2 2
  Include "sub.pbrt"
TransformEnd
Include "absent.pbrt"
Shape "plymesh" "string filename" "absent.ply"
Shape "curve" "point P" [0 0 0 1 1 1 2 2 2 3 3 3]
WorldEnd
"""

SUB = """Material "plastic" "texture Kd" "checks" "float roughness" [0.3]
Rotate -45 1 0 0
Shape "trianglemesh" "point P" [0 0 0 0 0 1 1 0 0] "integer indices" [0 1 2]
LookAt 0 0 5  0 0 0  0 1 0
"""


def _write_rich(d):
    """RICH and its sub-file, the PLY (a seeded grid with vertex normals)
    and the texture, in folder ``d``."""
    from PIL import Image
    os.makedirs(os.path.join(d, "tex"), exist_ok=True)
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8)).save(
        os.path.join(d, "tex", "checks.png"))
    xs, ys = np.meshgrid(np.arange(4), np.arange(3), indexing="xy")
    verts = np.stack([xs.ravel(), rng.normal(0, 0.2, 12), ys.ravel()],
                     1).astype(np.float32)
    nrm = rng.normal(size=(12, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = [[y * 4 + x, y * 4 + x + 1, (y + 1) * 4 + x + 1, (y + 1) * 4 + x]
             for y in range(2) for x in range(3)]
    write_ply(os.path.join(d, "mesh.ply"), verts, faces, normals=nrm)
    with open(os.path.join(d, "sub.pbrt"), "w") as f:
        f.write(SUB)
    with open(os.path.join(d, "rich.pbrt"), "w") as f:
        f.write(RICH)
    return os.path.join(d, "rich.pbrt")


def _write_basic(d):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "basic.pbrt")
    with open(path, "w") as f:
        f.write(BASIC)
    return path


WRITERS = {"basic": _write_basic, "rich": _write_rich}


def _pair(tmp_path, name):
    """The file written twice, into a folder per package."""
    return (WRITERS[name](str(tmp_path / "port")),
            WRITERS[name](str(tmp_path / "ref")))


def _assert_scenes_equal(ours, ref):
    """Arrays bit-equal, materials field by field, textures, camera and
    hash equal."""
    for x, y in zip(ours.triangle_arrays(), ref.triangle_arrays()):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    assert len(ours.materials) == len(ref.materials)
    for a, b in zip(ours.materials, ref.materials):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.material_types == ref.material_types
    assert [t.name for t in ours.textures] == [t.name for t in ref.textures]
    for a, b in zip(ours.textures, ref.textures):
        np.testing.assert_array_equal(a.data, b.data)
    co, cr = ours.camera_override, ref.camera_override
    assert (co is None) == (cr is None)
    if co is not None:
        for k in ("pos", "dir", "up", "right", "fov"):
            assert getattr(co, k) == getattr(cr, k), k
    assert ours.hash == ref.hash != ""


@pytest.mark.parametrize("name", ["basic", "rich"])
def test_load_matches_reference(tmp_path, name):
    ours_path, ref_path = _pair(tmp_path, name)
    ours, ref = Scene(), JScene()
    ours.load_model(ours_path)
    ref.load_model(ref_path)
    _assert_scenes_equal(ours, ref)
    if name == "rich":
        types = {m.type for m in ours.materials}
        assert {jbx.BXDF_DIFFUSE, jbx.BXDF_GLOSSY, jbx.BXDF_IDEAL_DIELECTRIC,
                jbx.BXDF_IDEAL_REFLECTION,
                jbx.BXDF_GGX_ROUGH_REFLECTION} <= types
        assert [t.name for t in ours.textures] == ["tex/checks.png"]
        assert ours.pbrt_textures == {"checks": 0, "missing": -1,
                                      "noise": -1}
        # the file's camera is set when its parse ends, after the
        # Include's LookAt set one
        assert ours.camera_override.pos == (1.0, 3.0, 9.0)
    for s in (ours, ref):
        assert os.path.exists(pbrt_cache.cache_path(
            ours_path if s is ours else ref_path))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_parse_cache_shared(tmp_path, monkeypatch, writer):
    """The .flc.npz one package writes, both read without parsing (their
    loaders patched to fail) to the same scene (exact); that scene is the
    parse, its material parameters and camera rounded to float32 as the
    cache stores them. A hit rewrites nothing."""
    path = _write_rich(str(tmp_path))
    parsed = Scene() if writer == "port" else JScene()
    parsed.load_model(path)
    with open(pbrt_cache.cache_path(path), "rb") as f:
        written = f.read()

    def no_parse(*a, **k):
        raise AssertionError("parsed despite a fresh cache")
    monkeypatch.setattr(pbrt_loader, "load_pbrt", no_parse)
    monkeypatch.setattr(jpbrt_loader, "load_pbrt", no_parse)
    ours, ref = Scene(), JScene()
    ours.load_model(path)
    ref.load_model(path)
    monkeypatch.undo()
    _assert_scenes_equal(ours, ref)
    for x, y in zip(ours.triangle_arrays(), parsed.triangle_arrays()):
        np.testing.assert_array_equal(x, y)
    f32 = lambda m: {k: (np.float32(v).tolist() if isinstance(v, float)
                         else np.asarray(v, np.float32).tolist()
                         if isinstance(v, tuple) else v)
                     for k, v in dataclasses.asdict(m).items()}
    assert [f32(m) for m in ours.materials] == \
        [f32(m) for m in parsed.materials]
    assert ours.hash == parsed.hash
    for k in ("pos", "dir", "up", "right", "fov"):
        np.testing.assert_array_equal(
            np.float32(getattr(ours.camera_override, k)),
            np.float32(getattr(parsed.camera_override, k)))
    with open(pbrt_cache.cache_path(path), "rb") as f:
        assert f.read() == written


def test_parse_cache_misses_and_read_only(tmp_path, monkeypatch, capsys):
    """Another source hash (an edited file) or another CACHE_VERSION
    misses and re-parses; a folder that cannot be written skips the cache
    with a printed line and still loads."""
    path = _write_basic(str(tmp_path))
    s = Scene()
    s.load_model(path)
    assert s.camera_override.fov == 45.0
    with open(path, "w") as f:
        f.write(BASIC.replace("[45]", "[30]"))
    s = Scene()
    s.load_model(path)
    assert s.camera_override.fov == 30.0
    assert not pbrt_cache.load_cache(path, "another hash", Scene())
    monkeypatch.setattr(pbrt_cache, "CACHE_VERSION", 2)
    assert not pbrt_cache.load_cache(path, s.hash, Scene())
    monkeypatch.undo()
    assert pbrt_cache.load_cache(path, s.hash, Scene())

    ro = tmp_path / "ro"
    path = _write_basic(str(ro))

    def refuse(*a, **k):
        raise PermissionError(13, "Permission denied", str(ro))
    monkeypatch.setattr(pbrt_cache.np, "savez_compressed", refuse)
    s = Scene()
    s.load_model(path)
    assert "pbrt cache write skipped" in capsys.readouterr().out
    assert s.num_triangles == 5
    assert os.listdir(ro) == ["basic.pbrt"]


def _settings():
    s = Settings()
    s.camera.pos, s.camera.dir = (0.0, 1.6, 4.5), (0.0, -0.12, -1.0)
    return s


def test_load_scene_camera_then_saved_state(tmp_path):
    """load_scene applies the file's camera to settings.camera (with the
    rotation recomputed), and a saved render state read after it wins:
    without a state the file's camera renders, with one the state's."""
    path = _write_basic(str(tmp_path))
    ref = JScene()
    ref.load_model(_write_basic(str(tmp_path / "ref")))
    r = Renderer(32, 18, settings=_settings(), data_dir=str(tmp_path),
                 device="cpu")
    r.load_scene(path)
    c = r.settings.camera
    co = ref.camera_override
    want = Settings()       # the reference's renderer.py:72-80 by hand
    w = want.camera
    w.pos, w.dir, w.up, w.right, w.fov = (co.pos, co.dir, co.up, co.right,
                                          co.fov)
    want._calc_camera_rotation()
    assert dataclasses.asdict(c) == dataclasses.asdict(w)
    assert c.pos == co.pos and c.fov == 45.0

    # a saved state for the scene: its camera wins over the file's
    saved = _settings()
    saved.camera.pos, saved.camera.fov = (7.0, 1.0, -2.0), 71.0
    state_io.save_state(state_io.state_path(str(tmp_path), r.scene.hash),
                        saved, 1.0, 1.0)
    r2 = Renderer(32, 18, settings=_settings(), data_dir=str(tmp_path),
                  device="cpu")
    r2.load_scene(path)
    assert r2.settings.camera.pos == (7.0, 1.0, -2.0)
    assert r2.settings.camera.fov == 71.0
    # without the saved state, the file's camera again
    r3 = Renderer(32, 18, settings=_settings(), data_dir=str(tmp_path),
                  device="cpu")
    r3.load_scene(path, use_saved_state=False)
    assert r3.settings.camera.pos == co.pos
    r3.init_wavefront(512)
    r3.render_wavefront(2)
    film = r3.wavefront_film()
    assert torch.isfinite(film.weight).all() and film.weight.sum() > 0


def test_pbrt_wavefront_matches_reference(tmp_path, reference_kernels):
    """4 segments of a PBRT scene: luxball as a plymesh under a
    transform, beside the glass, matte and metal of the basic scene, at
    32x16 with 512 paths, depth 10 (check_wavefront)."""
    from chip_smoke import write_ply as write_scene_ply

    def write(d):
        os.makedirs(d)
        write_scene_ply(os.path.join(d, "luxball.ply"), LUXBALL)
        path = os.path.join(d, "lux.pbrt")
        with open(path, "w") as f:
            f.write(BASIC.replace(
                "WorldEnd", 'AttributeBegin\n Material "matte" "rgb Kd" '
                '[.5 .6 .7]\n Translate 0 0.1 0\n Rotate 10 0 1 0\n'
                ' Shape "plymesh" "string filename" "luxball.ply"\n'
                'AttributeEnd\nWorldEnd'))
        return path
    ours, ref = Scene(), JScene()
    ours.load_model(write(str(tmp_path / "port")))
    path = write(str(tmp_path / "ref"))
    ref.load_model(path)
    _assert_scenes_equal(ours, ref)
    assert ours.num_triangles == 5 + 5642
    check_wavefront(scene_setup(path, 32, 16, 10), 512, 4)
