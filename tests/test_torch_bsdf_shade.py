"""A wavefront segment's BSDF work in one call (fluctus_tpu_torch/bsdf/
dispatch.py: ``bsdf_shade``), on the CPU.

Inputs are made with numpy from a seed: random unit normals, incoming
directions on the normal's far side, NEE directions over the whole
sphere, materials with and without Ks (the glossy lobe then derives it
from Ni, and Ni from Ks where Ni is 0), alphas from 0.01 to 1 and
indices of refraction from 1 to 2.4, seeds over all 32 bits. The scene
masks are those of the two benchmark scenes (the production luxball's
five lobes, the grid's diffuse and ideal dielectric) and every lobe.

- ``bsdf_shade`` equals the three masked calls it replaces and their
  epilogue, bit for bit, lane for lane, seeds included.
- The edge lanes: no lobe (terminated or missed lanes, a type the scene
  mask leaves out), emissive, singular, total internal reflection and a
  grazing mirror direction.
- ``wf_logic_phase`` on a small production scene gives the state it gave
  with the three calls.

The card runs the same work per lane inside csrc/surface_shade.cu
(through csrc/bsdf_device.cuh); test_torch_surface_shade.py holds that
kernel's source to the plain version, whose BSDF this is, on every lobe
under these masks and on these edge lanes."""

import os
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch import bxdf_types as bx
from fluctus_tpu_torch.bsdf import dispatch as D
from fluctus_tpu_torch.core import integrator_wf as W
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings
from fluctus_tpu_torch.vec import Vec3, dot, is_zero
from fluctus_tpu_torch.vec import where as vwhere

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import write_production_scene  # noqa: E402

PROD = (bx.BXDF_DIFFUSE | bx.BXDF_GLOSSY | bx.BXDF_GGX_ROUGH_REFLECTION
        | bx.BXDF_GGX_ROUGH_DIELECTRIC | bx.BXDF_IDEAL_DIELECTRIC)
GRID = bx.BXDF_DIFFUSE | bx.BXDF_IDEAL_DIELECTRIC
ALL = 0
for _t in bx.ALL_TYPES:
    ALL |= _t
MASKS = {"luxball_prod": PROD, "grid8x8": GRID, "all": ALL}
TYPES = {bx.type_name(t): t for t in bx.ALL_TYPES}
NO_LOBE = (0, 1, 1 << 9, -1)      # no lobe's bit: terminated, missed lanes
M = 512


def _unit(rng, m):
    v = rng.normal(size=(3, m))
    return v / np.linalg.norm(v, axis=0)


def _f(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _v(a):
    return Vec3(_f(a[0]), _f(a[1]), _f(a[2]))


def inputs(seed, m=M, types=None, backface=None,
           ni_choices=(0.0, 1.0, 1.33, 1.5, 2.4)):
    """Seeded inputs of bsdf_shade: (n, sp, backface, dir_in, dir_nee,
    seed, T, P). ``types`` an int or an [m] array (default: every type and
    the no-lobe values, mixed); ``backface`` a bool (default: mixed); Ni
    drawn from ``ni_choices``."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, m)
    d = _unit(rng, m)
    d = np.where(np.sum(d * n, axis=0) > 0, -d, d)        # toward n's face
    ks = rng.random((3, m))
    ks[:, rng.random(m) < 0.25] = 0.0        # glossy derives Ks from Ni
    ni = rng.choice(ni_choices, size=m)
    if types is None:
        types = rng.choice(list(TYPES.values()) + list(NO_LOBE), size=m)
    if backface is None:
        backface = rng.random(m) < 0.5
    sp = D.ShadingParams(
        Kd=_v(rng.random((3, m))), Ks=_v(ks), Ke=_v(rng.random((3, m)) * 4),
        Kt=_v(np.zeros((3, m))), alpha=_f(0.01 + rng.random(m)),
        Ni=_f(ni), d=_f(np.ones(m)),
        type=torch.from_numpy(np.broadcast_to(
            np.asarray(types, dtype=np.int32), (m,)).copy()),
        map_N=torch.full((m,), -1, dtype=torch.int32),
        map_Kd=torch.full((m,), -1, dtype=torch.int32),
        map_Ks=torch.full((m,), -1, dtype=torch.int32))
    back = torch.from_numpy(np.broadcast_to(np.asarray(backface),
                                            (m,)).copy())
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, size=m,
                                          dtype=np.int64))
    return (_v(n), sp, back, _v(d), _v(_unit(rng, m)), seeds,
            _v(rng.random((3, m)) + 0.01), _v(rng.normal(size=(3, m)) * 3))


def parent(n, sp, backface, dir_in, dir_nee, seed, T, P, types):
    """The three calls and the epilogue that bsdf_shade replaced in
    wf_logic_phase, as they stood there."""
    nee_bsdf = D.bxdf_eval(n, sp, backface, dir_in, dir_nee, types)
    nee_pdf = torch.clamp_min(D.bxdf_pdf(n, sp, backface, dir_in, dir_nee,
                                         types), 0.0)
    d_new, pdf_w, f, seed = D.bxdf_sample(n, sp, backface, dir_in, seed,
                                          types)
    m = seed.shape[0]
    bad = (pdf_w == 0.0) | is_zero(f)
    new_T = vwhere(bad, Vec3.zeros(m, seed.device),
                   T * f * (dot(n, d_new) / torch.where(bad, 1.0, pdf_w)))
    cont_orig = P + d_new * 1e-4
    return D.Shaded(nee_bsdf, nee_pdf, d_new, pdf_w, seed, new_T, cont_orig)


def _flat(out):
    """The outputs as a list of [m] tensors (Vec3s spread)."""
    res = []
    for v in out:
        res.extend(v if isinstance(v, Vec3) else (v,))
    return res


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b):
    for k, (x, y) in enumerate(zip(_flat(a), _flat(b))):
        assert torch.equal(_bits(x), _bits(y)), f"output {k} differs"


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("back", [False, True], ids=["front", "back"])
@pytest.mark.parametrize("name", list(TYPES))
def test_plain_equals_the_three_calls(name, back, mask):
    """bsdf_shade against bxdf_eval, bxdf_pdf and bxdf_sample with their
    epilogue: bit for bit, seeds included, with the sample's three
    draws."""
    args = inputs(11, types=TYPES[name], backface=back)
    want = parent(*args, MASKS[mask])
    assert_same(D.bsdf_shade(*args, MASKS[mask]), want)
    s = args[5]
    for _ in range(3):
        s = W.burtle_hash(s)
    assert torch.equal(want.seed, s)


def _lanes(m, **fields):
    """inputs(5, m) with the named fields replaced: n, dir_in, dir_nee
    (3-tuples, one direction for every lane), types, backface, Ni."""
    n, sp, back, d, dn, seed, T, P = inputs(5, m=m)
    full = lambda v: _v(np.tile(np.asarray(v, np.float32)[:, None], (1, m)))
    n = full(fields["n"]) if "n" in fields else n
    d = full(fields["dir_in"]) if "dir_in" in fields else d
    dn = full(fields["dir_nee"]) if "dir_nee" in fields else dn
    if "types" in fields:
        sp = sp._replace(type=torch.tensor(fields["types"],
                                           dtype=torch.int32).expand(m)
                         .contiguous())
    if "Ni" in fields:
        sp = sp._replace(Ni=torch.full((m,), fields["Ni"]))
    if "backface" in fields:
        back = torch.full((m,), fields["backface"])
    return n, sp, back, d, dn, seed, T, P


def _runs():
    return (("plain", D.bsdf_shade),)


def _zero(t):
    return bool((t == 0.0).all())


@pytest.mark.parametrize("case", ["no_lobe", "left_out"])
def test_edge_no_lobe(case):
    """Terminated and missed lanes (a type of no lobe's bit), and a lobe
    the scene's mask leaves out: zeros everywhere, the origin P itself,
    and the seed after three draws."""
    if case == "no_lobe":
        lanes = [(t, ALL) for t in NO_LOBE]
    else:
        lanes = [(bx.BXDF_GLOSSY, GRID), (bx.BXDF_IDEAL_REFLECTION, PROD),
                 (bx.BXDF_EMISSIVE, GRID & ~bx.BXDF_DIFFUSE)]
    for t, mask in lanes:
        args = _lanes(64, types=t)
        s = args[5]
        for _ in range(3):
            s = W.burtle_hash(s)
        for what, run in _runs():
            out = run(*args, mask)
            for k, v in enumerate(_flat(out)):
                if k == 8:
                    assert torch.equal(v, s), (what, t)
                elif k < 12:
                    assert _zero(v), (what, t, k)
            assert all(torch.equal(a, b) for a, b in zip(out.orig, args[7]))


def test_edge_emissive_and_singular():
    """An emissive lane: its Ke as the NEE bsdf, pdf 0, the sample's bsdf 1
    with direction and pdf 0, so the path ends (T 0). The ideal mirror
    and dielectric: NEE bsdf and pdf 0, the sample's pdf 1."""
    for what, run in _runs():
        args = _lanes(64, types=bx.BXDF_EMISSIVE)
        out = run(*args, ALL)
        assert all(torch.equal(a, b) for a, b in zip(out.nee_bsdf,
                                                    args[1].Ke)), what
        for v in (out.nee_pdf, out.pdf, *out.dir, *out.T):
            assert _zero(v), what
        for t in (bx.BXDF_IDEAL_REFLECTION, bx.BXDF_IDEAL_DIELECTRIC):
            out = run(*_lanes(64, types=t), ALL)
            for v in (*out.nee_bsdf, out.nee_pdf):
                assert _zero(v), (what, t)
            assert bool((out.pdf == 1.0).all()), (what, t)


@pytest.mark.parametrize("rough", [False, True], ids=["ideal", "rough"])
def test_edge_total_internal_reflection(rough):
    """From inside glass of index 1.5 at 60 degrees (past the critical
    41.8): Fresnel is 1, so every lane reflects, the ideal dielectric
    about the normal (direction exactly dir + 2 cos n), the rough one
    about its sampled half-vector (its draw u3 < 1 always)."""
    din = (np.sin(np.pi / 3), 0.0, -np.cos(np.pi / 3))
    t = bx.BXDF_GGX_ROUGH_DIELECTRIC if rough else bx.BXDF_IDEAL_DIELECTRIC
    args = _lanes(64, types=t, n=(0.0, 0.0, 1.0), dir_in=din, Ni=1.5,
                  backface=True)
    n, sp, _, d = args[:4]
    for what, run in _runs():
        out = run(*args, ALL)
        if rough:
            from fluctus_tpu_torch.bsdf import ggx
            from fluctus_tpu_torch.rng import rand_n
            from fluctus_tpu_torch.vec import reflect0
            (u1, u2, _), _ = rand_n(args[5], 3)
            want = reflect0(d, ggx.ggx_sample_lobe(sp.alpha, n, u1, u2))
            for a, b in zip(out.dir, want):
                assert torch.allclose(a, b, rtol=0, atol=1e-5), what
            assert bool((dot(out.dir, want) > 0.9999).all()), what
        else:
            cos_i = -dot(d, n)
            for a, dc, nc in zip(out.dir, d, n):
                assert torch.equal(a, dc + nc * (cos_i + cos_i)), what
            assert bool((out.pdf == 1.0).all()), what
            assert bool((out.T.x > 0).all()), what


def test_edge_grazing():
    """cos_o == 0: a mirror lane whose reflection grazes the surface gets
    bsdf 0 (its 1 / cos guarded), so its path ends (T 0) with pdf 1; a
    NEE direction in the tangent plane gets the diffuse pdf 0 and the GGX
    reflection's bsdf 0 (the guarded division by cos_i cos_o)."""
    n, tangent = (0.0, 0.0, 1.0), (1.0, 0.0, 0.0)
    mirror = _lanes(64, types=bx.BXDF_IDEAL_REFLECTION, n=n,
                    dir_in=tangent)
    diffuse = _lanes(64, types=bx.BXDF_DIFFUSE, n=n, dir_nee=tangent)
    ggx_lanes = _lanes(64, types=bx.BXDF_GGX_ROUGH_REFLECTION, n=n,
                       dir_nee=(0.0, 1.0, 0.0), Ni=1.5)
    for what, run in _runs():
        out = run(*mirror, ALL)
        assert bool((out.pdf == 1.0).all()), what
        for v in (*out.T,):
            assert _zero(v), what
        assert _zero(run(*diffuse, ALL).nee_pdf), what
        for v in run(*ggx_lanes, ALL).nee_bsdf:
            assert _zero(v), what


SWITCHES = {"default": {}, "roulette": {"use_russian_roulette": True},
            "no_nee": {"sample_explicit": False}}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_wf_logic_phase_matches_parent(tmp_path, monkeypatch, switch):
    """Five segments of a 16x8 render of the production luxball (small
    maps; every lobe but the mirror) through bsdf_shade, and from the
    same reset through the three calls it replaced (``parent`` in
    dispatch's namespace, where surface_shade_plain looks it up): the
    whole state (pool, film, spp, ring cursors) bit for bit, one call a
    segment on each route."""
    scene = write_production_scene(str(tmp_path), (64, 32, 16), seed=3)
    s = Settings()
    s.max_path_depth = 7
    s.wf_buffer_size = 512
    for k, v in SWITCHES[switch].items():
        setattr(s, k, v)
    r = Renderer(16, 8, settings=s, data_dir=str(tmp_path), device="cpu")
    r.load_scene(scene)
    assert r.device_scene.material_types == PROD

    def render():
        r.init_wavefront(512)
        r.render_wavefront(5)
        return W.wf_state_to_numpy(r._wf_state)
    calls = []

    def counted(f):
        def run(*a, **k):
            calls.append(f)
            return f(*a, **k)
        return run
    monkeypatch.setattr(D, "bsdf_shade", counted(D.bsdf_shade))
    got = render()
    assert len(calls) == 5
    monkeypatch.setattr(D, "bsdf_shade", counted(parent))
    want = render()
    assert len(calls) == 10 and calls[5:] == [parent] * 5
    _assert_tree_equal(got, want)


def _assert_tree_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path
