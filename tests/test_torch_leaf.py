"""PyTorch port vs the JAX package: RNG, camera rays, tonemapping and the
BSDF lobes (diffuse, glossy, GGX rough reflection, GGX rough dielectric,
ideal mirror, ideal dielectric, emissive). Inputs are made with numpy
from a seed and fed to both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import bxdf_types as bx
from fluctus_tpu import rng as jrng
from fluctus_tpu.bsdf import dispatch as jdisp
from fluctus_tpu.core import camera as jcam
from fluctus_tpu.core import tonemap as jtm
from fluctus_tpu.geom import Camera as JCamera
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch import rng as trng
from fluctus_tpu_torch.bsdf import dispatch as tdisp
from fluctus_tpu_torch.core import camera as tcam
from fluctus_tpu_torch.core import tonemap as ttm
from fluctus_tpu_torch.geom import Camera as TCamera
from fluctus_tpu_torch.vec import Vec3 as TVec3


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                   for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], axis=1)


def test_rng_bit_exact():
    """1M seeds x 8 draws: uniforms and seeds bit-equal (tolerance: none)."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32)
    seeds[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    js = jnp.asarray(seeds)
    ts = torch.from_numpy(seeds.astype(np.int64))
    for _ in range(8):
        ju, js = jrng.rand(js)
        tu, ts = trng.rand(ts)
        np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                      tu.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())


def test_camera_rays_within_2ulp():
    """generate_camera_rays on a 64x32 film: origins and directions within
    2 ulp (rsqrt rounds differently in XLA and torch), seeds bit-equal."""
    w, h = 64, 32
    rng = np.random.default_rng(1)
    pid = np.arange(w * h, dtype=np.int32)
    seeds = rng.integers(0, 1 << 32, w * h, dtype=np.uint64).astype(np.uint32)
    for aperture in (0.0, 0.05):
        kw = dict(pos=(0.0, 1.6, 4.5), dir=(0.0, -0.12, -1.0),
                  up=(0.0, 1.0, 0.0), right=(1.0, 0.0, 0.0), fov=60.0,
                  aperture_size=aperture, focal_dist=3.0)
        jo, jd, js = jcam.generate_camera_rays(
            jnp.asarray(pid), JCamera.make(**kw), w, h, jnp.float32(2.5),
            jnp.asarray(seeds))
        to, td, ts = tcam.generate_camera_rays(
            torch.from_numpy(pid), TCamera.make(**kw, device="cpu"), w, h,
            torch.tensor(2.5), torch.from_numpy(seeds.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        if aperture == 0.0:
            np.testing.assert_array_max_ulp(_np3(jo), _np3(to), maxulp=2)
            np.testing.assert_array_max_ulp(_np3(jd), _np3(td), maxulp=2)
        else:
            # thin lens: the pinhole direction's rsqrt ulp passes through
            # the focal point minus the lens point (a cancellation), so the
            # depth-of-field ray is held to rtol 1e-5 instead
            np.testing.assert_allclose(_np3(to), _np3(jo), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(_np3(td), _np3(jd), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("op", [0, 1, 2, 3])
def test_tonemap_ops(op):
    """postprocess for operators 0-3: rtol 1e-6 (pow/divide rounding)."""
    rng = np.random.default_rng(2)
    c = (rng.random((4096, 3)) * 8.0).astype(np.float32)
    w = rng.integers(0, 5, 4096).astype(np.float32)
    jr = jtm.postprocess(_jv(c), jnp.asarray(w), jnp.float32(1.3),
                         jnp.int32(op))
    tr = ttm.postprocess(_tv(c), torch.from_numpy(w), torch.tensor(1.3), op)
    np.testing.assert_allclose(_np3(tr), _np3(jr), rtol=1e-6, atol=0)


def _shading_inputs(n, mtype, seed):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    din = rng.normal(size=(n, 3)).astype(np.float32)
    din /= np.linalg.norm(din, axis=1, keepdims=True)
    # incoming directions point toward the surface
    flip = (din * nrm).sum(1) > 0
    din[flip] = -din[flip]
    dout = rng.normal(size=(n, 3)).astype(np.float32)
    dout /= np.linalg.norm(dout, axis=1, keepdims=True)
    f = lambda *s: rng.random(s).astype(np.float32)
    sp = dict(Kd=f(n, 3), Ks=f(n, 3), Ke=f(n, 3) * 4, Kt=f(n, 3),
              alpha=f(n) * 0.5 + 0.05, Ni=f(n) * 0.8 + 1.2, d=np.ones(n,
                                                                  np.float32),
              type=np.full(n, mtype, np.int32))
    backface = rng.random(n) < 0.3
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return nrm, din, dout, sp, backface, seeds


def _sp(mod, vec, sp, conv):
    m1 = np.full(sp["d"].shape, -1, np.int32)
    return mod.ShadingParams(
        Kd=vec(sp["Kd"]), Ks=vec(sp["Ks"]), Ke=vec(sp["Ke"]),
        Kt=vec(sp["Kt"]), alpha=conv(sp["alpha"]), Ni=conv(sp["Ni"]),
        d=conv(sp["d"]), type=conv(sp["type"]), map_N=conv(m1),
        map_Kd=conv(m1), map_Ks=conv(m1))


GGX_LOBES = (bx.BXDF_GLOSSY, bx.BXDF_GGX_ROUGH_REFLECTION,
             bx.BXDF_GGX_ROUGH_DIELECTRIC)
# float32 against float64 on the GGX lobes: the microfacet distribution
# reads 1 - (n.h)^2, which cancels near the normal, so at alpha 0.05 one
# ulp of n.h moves a pdf by ~1e-4 relative (measured on these inputs: up
# to 2.8e-4 for either package)
GGX_F32_RTOL = 5e-4


def _lobe_outputs(mtype, wide):
    """bxdf_sample's (direction, pdf, bsdf, seed), bxdf_eval and bxdf_pdf
    of both packages on the same seeded inputs, as (reference, port) dicts
    of numpy arrays; with ``wide`` every float input is float64 (the
    caller makes the uniforms float64 too)."""
    n = 4096
    scene_types = mtype | bx.BXDF_DIFFUSE
    nrm, din, dout, sp, backface, seeds = _shading_inputs(n, mtype, 3)
    if wide:
        up = lambda a: a.astype(np.float64) if a.dtype == np.float32 else a
        nrm, din, dout = up(nrm), up(din), up(dout)
        sp = {k: up(v) for k, v in sp.items()}
    jsp = _sp(jdisp, _jv, sp, jnp.asarray)
    tsp = _sp(tdisp, _tv, sp, lambda a: torch.from_numpy(
        np.ascontiguousarray(a)))
    jb, tb = jnp.asarray(backface), torch.from_numpy(backface)
    jd, jp, jf, js = jdisp.bxdf_sample(_jv(nrm), jsp, jb, _jv(din),
                                       jnp.asarray(seeds), scene_types)
    td, tp, tf, ts = tdisp.bxdf_sample(_tv(nrm), tsp, tb, _tv(din),
                                       torch.from_numpy(seeds.astype(
                                           np.int64)), scene_types)
    je = jdisp.bxdf_eval(_jv(nrm), jsp, jb, _jv(din), _jv(dout), scene_types)
    te = tdisp.bxdf_eval(_tv(nrm), tsp, tb, _tv(din), _tv(dout), scene_types)
    jq = jdisp.bxdf_pdf(_jv(nrm), jsp, jb, _jv(din), _jv(dout), scene_types)
    tq = tdisp.bxdf_pdf(_tv(nrm), tsp, tb, _tv(din), _tv(dout), scene_types)
    ref = dict(dir=_np3(jd), pdf=np.asarray(jp), bsdf=_np3(jf),
               eval=_np3(je), pdf_of=np.asarray(jq))
    got = dict(dir=_np3(td), pdf=tp.numpy(), bsdf=_np3(tf), eval=_np3(te),
               pdf_of=tq.numpy())
    ref["seed"], got["seed"] = np.asarray(js).astype(np.int64), ts.numpy()
    return ref, got


def _check_ggx_lobe(mtype, monkeypatch):
    """A GGX lobe (glossy, rough reflection, rough dielectric), evaluated
    twice from the same inputs. In float64 (the reference under
    jax.enable_x64, the uniforms of rand_n widened in both packages) the
    port equals the reference at rtol 1e-5 / atol 1e-6 on every value and
    every branch (back faces, the dot(n, d) < 1e-5 cut, grazing lanes).
    In float32 each package is within GGX_F32_RTOL (atol 1e-6) of that
    float64 evaluation on every value: XLA's and torch's CPU rsqrt, sqrt,
    atan2, sin and cos differ in the last bit on a few percent of lanes,
    and 1 - (n.h)^2 magnifies that ulp, so the two float32 results may
    differ by twice that distance but neither strays further from the
    exact value than the conditioning allows."""
    ref32, got32 = _lobe_outputs(mtype, wide=False)
    for mod, rng_mod, widen in ((jdisp, jrng, lambda u: u.astype(
            jnp.float64)), (tdisp, trng, lambda u: u.to(torch.float64))):
        def wide_uniforms(seed, k, _rand_n=rng_mod.rand_n, _widen=widen):
            us, seed = _rand_n(seed, k)
            return [_widen(u) for u in us], seed
        monkeypatch.setattr(mod, "rand_n", wide_uniforms)
    with jax.enable_x64(True):
        ref64, got64 = _lobe_outputs(mtype, wide=True)
    seed = ref32["seed"]
    for r in (ref32, got32, ref64, got64):
        np.testing.assert_array_equal(r.pop("seed"), seed)
    for k, want in ref64.items():
        assert want.dtype == got64[k].dtype == np.float64, k
        np.testing.assert_allclose(got64[k], want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{k}, float64")
        for pkg, out in (("reference", ref32[k]), ("port", got32[k])):
            assert out.dtype == np.float32
            np.testing.assert_allclose(out, want, rtol=GGX_F32_RTOL,
                                       atol=1e-6,
                                       err_msg=f"{k}, float32 {pkg}")
    assert (np.abs(ref64["pdf"]) > 0).mean() > 0.2


@pytest.mark.parametrize("mtype", [bx.BXDF_DIFFUSE, bx.BXDF_IDEAL_REFLECTION,
                                   bx.BXDF_IDEAL_DIELECTRIC,
                                   bx.BXDF_EMISSIVE, *GGX_LOBES])
def test_bsdf_lobes(mtype, monkeypatch):
    """bxdf_sample / bxdf_eval / bxdf_pdf per lobe: rtol 1e-5 with
    atol 1e-6 for components near zero (sin/cos/rsqrt round differently);
    the singular lobes' sampled directions and pdfs are bit-equal (same
    operation order, no transcendental). The GGX lobes are held in float64
    and against float64 (_check_ggx_lobe); ``ggx_sample_lobe`` and the GGX
    terms on equal inputs are in test_torch_ggx.py."""
    if mtype in GGX_LOBES:
        _check_ggx_lobe(mtype, monkeypatch)
        return
    ref, got = _lobe_outputs(mtype, wide=False)
    nrm = _shading_inputs(4096, mtype, 3)[0]
    np.testing.assert_array_equal(ref["seed"], got["seed"])
    jd, td = ref["dir"], got["dir"]
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["pdf"], ref["pdf"], rtol=1e-5, atol=1e-6)
    # singular lobes divide by cos(dir_out, n) of an rsqrt-normalized
    # direction: at grazing angles that cancellation magnifies the rsqrt
    # ulp, so lanes with |cos| < 0.05 are held to rtol 1e-4
    cos_o = np.abs((jd * nrm).sum(1))
    graze = cos_o < 0.05
    np.testing.assert_allclose(got["bsdf"][~graze], ref["bsdf"][~graze],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["bsdf"][graze], ref["bsdf"][graze],
                               rtol=1e-4, atol=1e-6)
    if mtype == bx.BXDF_IDEAL_REFLECTION:
        np.testing.assert_array_equal(td, jd)
    if mtype == bx.BXDF_IDEAL_DIELECTRIC:
        # same operation order, but torch's vectorized CPU sqrt is not
        # correctly rounded (off by one ulp on ~0.5% of inputs against
        # numpy's), and the refraction uses sqrt twice: the unit
        # directions agree within 2 ulp of 1.0 (2.4e-7) absolute
        np.testing.assert_allclose(td, jd, rtol=0, atol=2.4e-7)
    if mtype & bx.BXDF_SINGULAR_MASK:
        np.testing.assert_array_equal(got["pdf"], ref["pdf"])
    np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["pdf_of"], ref["pdf_of"], rtol=1e-5,
                               atol=1e-6)
