"""The port's PLY loader against the JAX package's, on files the tests
write: triangles and quads, with and without vertex normals, a foreign
element between the vertices and the faces, and a pentagon that must
raise. Scene arrays (positions, normals, uvs, material ids) and
``Scene.hash`` must equal the reference's exactly; a Renderer on the CPU
loads a PLY (cold, then warm from its caches) and renders it."""

import os

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.scene import Scene as JScene

from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.scene import ModelTransform, Scene
from fluctus_tpu_torch.settings import Settings


def write_ply(path, verts, faces, normals=None, foreign=0, comment=True):
    """An ASCII PLY of ``verts`` [V, 3], ``faces`` (lists of vertex ids)
    and optional ``normals`` [V, 3]; ``foreign`` lines of an element
    ``edge`` sit between the vertices and the faces."""
    lines = ["ply", "format ascii 1.0"]
    if comment:
        lines.append("comment written by a test")
    lines += [f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        lines += ["property float nx", "property float ny",
                  "property float nz"]
    if foreign:
        lines += [f"element edge {foreign}", "property int vertex1",
                  "property int vertex2"]
    lines += [f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    for i, v in enumerate(verts):
        row = list(v) + (list(normals[i]) if normals is not None else [])
        lines.append(" ".join(repr(float(x)) for x in row))
    lines += [f"{i} {i + 1}" for i in range(foreign)]
    lines += [" ".join(str(x) for x in [len(f), *f]) for f in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _mesh(seed, quads):
    """A seeded grid of 4x3 cells: quads, or each quad as two triangles
    (one of them wound the other way, so the flat normals differ)."""
    rng = np.random.default_rng(seed)
    nx, ny = 5, 4
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      rng.normal(0, 0.3, nx * ny)], 1).astype(np.float32)
    faces = []
    for y in range(ny - 1):
        for x in range(nx - 1):
            a, b = y * nx + x, y * nx + x + 1
            c, d = b + nx, a + nx
            faces += [[a, b, c, d]] if quads else [[a, b, c], [a, d, c]]
    normals = rng.normal(size=(nx * ny, 3)).astype(np.float32)
    return verts, faces, normals


def _arrays(scene):
    return scene.triangle_arrays()


CASES = {"tris": dict(quads=False, normals=False),
         "tris_normals": dict(quads=False, normals=True),
         "quads": dict(quads=True, normals=False),
         "quads_normals_foreign": dict(quads=True, normals=True, foreign=3)}


@pytest.mark.parametrize("case", list(CASES))
def test_ply_matches_reference(tmp_path, case):
    """The port's scene arrays and hash equal the reference's load of the
    same file, bit for bit; quads split i0i1i2 / i2i3i0; flat normals when
    the file has none."""
    c = CASES[case]
    verts, faces, normals = _mesh(len(case), c["quads"])
    path = write_ply(tmp_path / f"{case}.ply", verts, faces,
                     normals if c["normals"] else None, c.get("foreign", 0))
    ours, ref = Scene(), JScene()
    ours.load_model(path)
    ref.load_model(path)
    a, b = _arrays(ours), _arrays(ref)
    for x, y, name in zip(a, b, ("positions", "normals", "uvs", "mat_ids")):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert ours.hash == ref.hash != ""
    assert ours.num_triangles == 24
    if c["quads"]:
        q = faces[1]
        np.testing.assert_array_equal(a[0][2], verts[[q[0], q[1], q[2]]])
        np.testing.assert_array_equal(a[0][3], verts[[q[2], q[3], q[0]]])
    if not c["normals"]:
        n = a[1]
        np.testing.assert_allclose(np.linalg.norm(n, axis=2), 1.0,
                                   rtol=1e-6)
        assert (n[:, 0] == n[:, 1]).all() and (n[:, 0] == n[:, 2]).all()


def test_ply_transform_matches_reference(tmp_path):
    """Through a .sc.json entry's transform (scale and translation), as
    the reference applies it; a transformed load sets no hash."""
    from fluctus_tpu.scene.scene import ModelTransform as JTransform
    verts, faces, _ = _mesh(3, True)
    path = write_ply(tmp_path / "t.ply", verts, faces)
    ours, ref = Scene(), JScene()
    ours.load_model(path, ModelTransform(2.5, (1.0, -2.0, 0.5)))
    ref.load_model(path, JTransform(2.5, (1.0, -2.0, 0.5)))
    for x, y in zip(_arrays(ours), _arrays(ref)):
        np.testing.assert_array_equal(x, y)
    assert ours.hash == ref.hash == ""


def test_ply_refuses_other_polygons(tmp_path):
    """A pentagon raises ValueError in both packages; an empty .pbrt world
    loads with no triangles in both, and another extension is unknown
    (ValueError, the reference's error)."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1.3, 1, 0], [0.5, 1.6, 0],
                      [-0.3, 1, 0]], np.float32)
    path = write_ply(tmp_path / "penta.ply", verts, [[0, 1, 2, 3, 4]])
    for scene in (Scene(), JScene()):
        with pytest.raises(ValueError, match="polygon size 5"):
            scene.load_model(path)
    pbrt = tmp_path / "s.pbrt"
    pbrt.write_text("WorldBegin\nWorldEnd\n")
    for scene in (Scene(), JScene()):
        scene.load_model(str(pbrt))
        assert scene.num_triangles == 0 and len(scene.materials) == 1
    other = tmp_path / "s.stl"
    other.write_text("solid\n")
    for scene in (Scene(), JScene()):
        with pytest.raises(ValueError, match="unknown scene format"):
            scene.load_model(str(other))


def test_renderer_loads_and_renders_ply(tmp_path):
    """Renderer(device="cpu") on a PLY floor with a box above it: a cold
    load writes the BVH and table caches, a second load hits both; 2 exact
    spp give weight 2 on every pixel and a finite image."""
    verts = np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3],
                      [-1, 0.5, -1], [1, 0.5, -1], [1, 0.5, 1],
                      [-1, 0.5, 1], [-1, 1.5, -1], [1, 1.5, -1],
                      [1, 1.5, 1], [-1, 1.5, 1]], np.float32)
    faces = [[0, 3, 2, 1], [8, 11, 10, 9], [4, 5, 9, 8], [5, 6, 10, 9],
             [6, 7, 11, 10], [7, 4, 8, 11]]
    path = write_ply(tmp_path / "box.ply", verts, faces)
    s = Settings()
    s.camera.pos, s.camera.dir = (0.0, 2.0, 6.0), (0.0, -0.3, -1.0)
    a = s.area_light
    a.pos, a.N, a.right, a.up = (0, 4, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)
    a.E, a.size = (50.0, 50.0, 50.0), (0.5, 0.5)
    s.max_path_depth, s.wf_buffer_size = 4, 1024
    data = str(tmp_path / "data")
    hits = []
    for _ in range(2):
        r = Renderer(16, 8, settings=s, data_dir=data, device="cpu")
        r.load_scene(path)
        hits.append(r.cache_hit)
    assert hits == [dict(bvh=False, tables=False), dict(bvh=True, tables=True)]
    assert r.scene.num_triangles == 12
    assert sorted(os.listdir(data)) == ["hierarchies", "mxu_tables"]
    film = r.render_single(2)
    assert (film.weight == 2).all()
    img = r.ldr_image()
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0
