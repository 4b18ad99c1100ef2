"""PyTorch port vs the JAX package: RNG, camera rays, tonemapping and the
BSDF lobes the port has (diffuse, ideal mirror, ideal dielectric,
emissive). Inputs are made with numpy from a seed and fed to both."""

import numpy as np
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


@pytest.mark.parametrize("mtype", [bx.BXDF_DIFFUSE, bx.BXDF_IDEAL_REFLECTION,
                                   bx.BXDF_IDEAL_DIELECTRIC,
                                   bx.BXDF_EMISSIVE])
def test_bsdf_lobes(mtype):
    """bxdf_sample / bxdf_eval / bxdf_pdf per ported lobe: rtol 1e-5 with
    atol 1e-6 for components near zero (sin/cos/rsqrt round differently);
    the singular lobes' sampled directions and pdfs are bit-equal (same
    operation order, no transcendental)."""
    n = 4096
    scene_types = mtype | bx.BXDF_DIFFUSE
    nrm, din, dout, sp, backface, seeds = _shading_inputs(n, mtype, 3)
    jsp = _sp(jdisp, _jv, sp, jnp.asarray)
    tsp = _sp(tdisp, _tv, sp, lambda a: torch.from_numpy(
        np.ascontiguousarray(a)))
    jb, tb = jnp.asarray(backface), torch.from_numpy(backface)

    jd, jp, jf, js = jdisp.bxdf_sample(_jv(nrm), jsp, jb, _jv(din),
                                       jnp.asarray(seeds), scene_types)
    td, tp, tf, ts = tdisp.bxdf_sample(_tv(nrm), tsp, tb, _tv(din),
                                       torch.from_numpy(seeds.astype(
                                           np.int64)), scene_types)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_allclose(_np3(td), _np3(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    # singular lobes divide by cos(dir_out, n) of an rsqrt-normalized
    # direction: at grazing angles that cancellation magnifies the rsqrt
    # ulp, so lanes with |cos| < 0.05 are held to rtol 1e-4
    cos_o = np.abs((_np3(jd) * nrm).sum(1))
    graze = cos_o < 0.05
    np.testing.assert_allclose(_np3(tf)[~graze], _np3(jf)[~graze], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np3(tf)[graze], _np3(jf)[graze], rtol=1e-4,
                               atol=1e-6)
    if mtype == bx.BXDF_IDEAL_REFLECTION:
        np.testing.assert_array_equal(_np3(td), _np3(jd))
    if mtype == bx.BXDF_IDEAL_DIELECTRIC:
        # same operation order, but torch's vectorized CPU sqrt is not
        # correctly rounded (off by one ulp on ~0.5% of inputs against
        # numpy's), and the refraction uses sqrt twice: the unit
        # directions agree within 2 ulp of 1.0 (2.4e-7) absolute
        np.testing.assert_allclose(_np3(td), _np3(jd), rtol=0, atol=2.4e-7)
    if mtype & bx.BXDF_SINGULAR_MASK:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    je = jdisp.bxdf_eval(_jv(nrm), jsp, jb, _jv(din), _jv(dout), scene_types)
    te = tdisp.bxdf_eval(_tv(nrm), tsp, tb, _tv(din), _tv(dout), scene_types)
    np.testing.assert_allclose(_np3(te), _np3(je), rtol=1e-5, atol=1e-6)
    jq = jdisp.bxdf_pdf(_jv(nrm), jsp, jb, _jv(din), _jv(dout), scene_types)
    tq = tdisp.bxdf_pdf(_tv(nrm), tsp, tb, _tv(din), _tv(dout), scene_types)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)


def test_unported_lobes_raise():
    """Glossy / GGX / rough-dielectric scenes raise, naming the lobe."""
    for t in (bx.BXDF_GLOSSY, bx.BXDF_GGX_ROUGH_REFLECTION,
              bx.BXDF_GGX_ROUGH_DIELECTRIC):
        with pytest.raises(NotImplementedError, match=bx.type_name(t)):
            tdisp.check_lobes(bx.BXDF_DIFFUSE | t)
