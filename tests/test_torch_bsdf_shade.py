"""A wavefront segment's BSDF work in one call (fluctus_tpu_torch/bsdf/
dispatch.py: ``bsdf_shade``, its plain version ``bsdf_shade_plain`` and the
kernel csrc/bsdf_shade.cu), on the CPU.

Inputs are made with numpy from a seed: random unit normals, incoming
directions on the normal's far side, NEE directions over the whole
sphere, materials with and without Ks (the glossy lobe then derives it
from Ni, and Ni from Ks where Ni is 0), alphas from 0.01 to 1 and
indices of refraction from 1 to 2.4, seeds over all 32 bits. The scene
masks are those of the two benchmark scenes (the production luxball's
five lobes, the grid's diffuse and ideal dielectric) and every lobe.

- The plain version equals the three masked calls it replaces and their
  epilogue, bit for bit, lane for lane, seeds included.
- The edge lanes: no lobe (terminated or missed lanes, a type the scene
  mask leaves out), emissive, singular, total internal reflection and a
  grazing mirror direction, on the plain version and on the kernel's
  source.
- The kernel's source, built by g++ with CUDA stubs, against the plain
  version. It computes as torch's CUDA kernels do (x / 3.0 as x times the
  float 1/3, rsqrtf), torch on the CPU divides and takes its
  transcendentals otherwise, so each output agrees within 64 float32 ulps
  of its magnitude, or of 1 where it cancels to below 1 (the sampled
  GGX pdf within 2^13, see PDF_ULPS), and the lanes' branches agree. The
  card holds the compiled kernel to the plain version bit for bit:
  chip_smoke.py's phases 2, 2b and 11a (and every call recorded in 15a
  and 16).
- The wrapper refuses inputs of another dtype, shape, layout or device;
  on the CPU the plain version takes any layout.
- ``wf_logic_phase`` on a small production scene gives the state it gave
  with the three calls."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch import bxdf_types as bx
from fluctus_tpu_torch import kernel_build as kb
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
    """bsdf_shade_plain (and the wrapper on CPU tensors) against bxdf_eval,
    bxdf_pdf and bxdf_sample with their epilogue: bit for bit, seeds
    included, with the sample's three draws."""
    args = inputs(11, types=TYPES[name], backface=back)
    want = parent(*args, MASKS[mask])
    assert_same(D.bsdf_shade_plain(*args, MASKS[mask]), want)
    assert_same(D.bsdf_shade(*args, MASKS[mask]), want)
    s = args[5]
    for _ in range(3):
        s = W.burtle_hash(s)
    assert torch.equal(want.seed, s)


# The kernel's source compiled for the CPU: the CUDA keywords, the cache
# hints and intrinsics stubbed out, one call of the kernel body per lane.
_CUDA_STUB = """
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
typedef int cudaError_t;
typedef void* cudaStream_t;
struct Dim3 { int x, y, z; };
static Dim3 blockIdx, blockDim, threadIdx;
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }
inline float __uint_as_float(unsigned int u) {
  float f; memcpy(&f, &u, 4); return f;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/bsdf_shade.cu built by g++ (-ffp-contract=off, as nvcc's
    -fmad=false) with the launch rewritten as a loop over the lanes; called
    as bsdf_shade is."""
    d = tmp_path_factory.mktemp("bsdf_shade_cpu")
    csrc = os.path.join(os.path.dirname(kb.__file__), "csrc")
    (d / "cuda_runtime.h").write_text(_CUDA_STUB)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            with open(os.path.join(csrc, name)) as f:
                (d / name).write_text(f.read())
    with open(os.path.join(csrc, "bsdf_shade.cu")) as f:
        src = f.read()
    src, k = re.subn(
        r"(bsdf_shade_kernel)<<<[^>]*>>>\(([^;]*)\);",
        r"for (int r = 0; r < n; ++r) { threadIdx.x = r; blockDim.x = 1; "
        r"\1(\2); }", src)
    assert k == 1
    (d / "k.cpp").write_text(src)
    out = str(d / "libk.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(d), "-o", out,
                    str(d / "k.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(out).bsdf_shade_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]

    def run(n, sp, backface, dir_in, dir_nee, seed, T, P, types):
        tensors, m = D._shade_inputs(n, sp, backface, dir_in, dir_nee, seed,
                                     T, P)
        tensors = [t.contiguous() for t in tensors]
        out = torch.empty((14, m))
        seed_out = torch.empty_like(seed)
        ptrs = (ctypes.c_void_p * (len(tensors) + 15))(
            *(t.data_ptr() for t in (*tensors, *out, seed_out)))
        assert fn(ctypes.addressof(ptrs), m, types, None) == 0
        v = lambda k: Vec3(out[k], out[k + 1], out[k + 2])
        return D.Shaded(v(0), out[3], v(4), out[7], seed_out, v(8), v(11))
    return run


# The sampled pdf of a GGX lobe divides by 1 - cos^2 of the half-vector,
# near 0 for a half-vector near the normal: there a last-bit difference of
# the transcendentals grows some thousandfold (5,161 ulps at worst over 12
# seeds of 8,192 lanes). Every other output stays within 64 ulps (34 at
# worst).
ULPS = 64
PDF_ULPS = 1 << 13
PDF_OUT = 7                 # the continuation pdf's place in _flat


def assert_close(got, want, what):
    """Each float output within its ulps of max(|want|, 1), NaN where the
    other is NaN; the seeds equal."""
    for k, (a, b) in enumerate(zip(_flat(got), _flat(want))):
        if a.dtype != torch.float32:
            assert torch.equal(a, b), f"{what}: output {k} differs"
            continue
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan), f"{what}: output {k} NaN"
        ulps = PDF_ULPS if k == PDF_OUT else ULPS
        tol = ulps * torch.finfo(torch.float32).eps * torch.clamp_min(
            b.abs(), 1.0)
        err = torch.where(nan, 0.0, (a - b).abs())
        assert bool((err <= tol).all()), (
            f"{what}: output {k}, max |err| {float(err.max())} at lane "
            f"{int(torch.argmax(err - tol))}")


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_source_matches_plain(kernel_on_cpu, seed, mask):
    """Every type and the no-lobe values mixed over the lanes, both faces:
    the kernel's source against the plain version. Ni = 1 is left out: a
    rough dielectric that matches the outside index refracts straight
    through, and its half-vector is the normalized difference of two
    nearly equal directions, rounding noise on either side."""
    args = inputs(seed, m=4096, ni_choices=(0.0, 1.33, 1.5, 2.4))
    assert_close(kernel_on_cpu(*args, MASKS[mask]),
                 D.bsdf_shade_plain(*args, MASKS[mask]), f"seed {seed}")


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


def _runs(kernel_on_cpu):
    return (("plain", D.bsdf_shade_plain), ("kernel source", kernel_on_cpu))


def _zero(t):
    return bool((t == 0.0).all())


@pytest.mark.parametrize("case", ["no_lobe", "left_out"])
def test_edge_no_lobe(kernel_on_cpu, case):
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
        for what, run in _runs(kernel_on_cpu):
            out = run(*args, mask)
            for k, v in enumerate(_flat(out)):
                if k == 8:
                    assert torch.equal(v, s), (what, t)
                elif k < 12:
                    assert _zero(v), (what, t, k)
            assert all(torch.equal(a, b) for a, b in zip(out.orig, args[7]))


def test_edge_emissive_and_singular(kernel_on_cpu):
    """An emissive lane: its Ke as the NEE bsdf, pdf 0, the sample's bsdf 1
    with direction and pdf 0, so the path ends (T 0). The ideal mirror
    and dielectric: NEE bsdf and pdf 0, the sample's pdf 1."""
    for what, run in _runs(kernel_on_cpu):
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
def test_edge_total_internal_reflection(kernel_on_cpu, rough):
    """From inside glass of index 1.5 at 60 degrees (past the critical
    41.8): Fresnel is 1, so every lane reflects, the ideal dielectric
    about the normal (direction exactly dir + 2 cos n), the rough one
    about its sampled half-vector (its draw u3 < 1 always)."""
    din = (np.sin(np.pi / 3), 0.0, -np.cos(np.pi / 3))
    t = bx.BXDF_GGX_ROUGH_DIELECTRIC if rough else bx.BXDF_IDEAL_DIELECTRIC
    args = _lanes(64, types=t, n=(0.0, 0.0, 1.0), dir_in=din, Ni=1.5,
                  backface=True)
    n, sp, _, d = args[:4]
    for what, run in _runs(kernel_on_cpu):
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


def test_edge_grazing(kernel_on_cpu):
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
    for what, run in _runs(kernel_on_cpu):
        out = run(*mirror, ALL)
        assert bool((out.pdf == 1.0).all()), what
        for v in (*out.T,):
            assert _zero(v), what
        assert _zero(run(*diffuse, ALL).nee_pdf), what
        for v in run(*ggx_lanes, ALL).nee_bsdf:
            assert _zero(v), what


def test_wrapper_refuses_malformed_inputs():
    """A float64 direction, an int64 type, a [m, 1] throughput, a
    mismatched length, a tensor on another device, a strided normal among
    tensors of a device the kernel could take, and tensors on a device
    that is neither the CPU nor CUDA: each a ValueError. On the CPU a
    strided input is the plain version's to take: the same result."""
    args = list(inputs(3, m=16))
    n, sp, back, d, dn, seed, T, P = args
    bad = {
        "dtype": dict(dir_in=Vec3(d.x.double(), d.y, d.z)),
        "type dtype": dict(sp=sp._replace(type=sp.type.long())),
        "shape": dict(T=Vec3(T.x[:, None], T.y, T.z)),
        "length": dict(P=Vec3(P.x[:8], P.y, P.z)),
        "device": dict(backface=back.to("meta")),
    }
    names = ("n", "sp", "backface", "dir_in", "dir_nee", "seed", "T", "P")
    for what, swap in bad.items():
        a = dict(zip(names, args), **swap)
        with pytest.raises(ValueError, match="bsdf_shade"):
            D.bsdf_shade(*(a[k] for k in names), PROD)
    to_meta = lambda v: Vec3(*(c.to("meta") for c in v))
    meta = [to_meta(x) if isinstance(x, Vec3) else x.to("meta")
            for x in (n, sp.Kd, back, d, dn, seed, T, P)]
    meta[1] = sp._replace(Kd=meta[1], Ks=to_meta(sp.Ks), Ke=to_meta(sp.Ke),
                          alpha=sp.alpha.to("meta"), Ni=sp.Ni.to("meta"),
                          type=sp.type.to("meta"))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        D.bsdf_shade(*meta, PROD)
    strided = Vec3(torch.zeros(32, device="meta")[::2], *meta[0][1:])
    with pytest.raises(ValueError, match="argument 0 is not contiguous"):
        D.bsdf_shade(strided, *meta[1:], PROD)
    assert D.K_SHADE.launches == 0
    wide = Vec3(torch.stack([n.x, n.x], dim=1)[:, 0], n.y, n.z)
    assert not wide.x.is_contiguous()
    assert_same(D.bsdf_shade(wide, *args[1:], PROD),
                D.bsdf_shade(*args, PROD))


SWITCHES = {"default": {}, "roulette": {"use_russian_roulette": True},
            "no_nee": {"sample_explicit": False}}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_wf_logic_phase_matches_parent(tmp_path, monkeypatch, switch):
    """Five segments of a 16x8 render of the production luxball (small
    maps; every lobe but the mirror) through bsdf_shade, and from the
    same reset through the three calls it replaced: the whole state
    (pool, film, spp, ring cursors) bit for bit."""
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
    kb.reset_counts()
    got = render()
    assert D.K_SHADE.plain_runs == 5
    monkeypatch.setattr(W, "bsdf_shade", parent)
    want = render()
    assert D.K_SHADE.plain_runs == 5
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
