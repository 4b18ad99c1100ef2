"""The port's GGX lobes (bsdf/ggx.py) against the JAX package, on the CPU:

  terms on equal inputs  ggx_g1, ggx_g, ggx_d, ggx_pdf_reflect and
                         ggx_pdf_refract on seeded normals, directions and
                         half vectors: rtol 2e-6 (their only transcendental
                         is sqrt, which torch's vectorized CPU loop rounds
                         differently on ~0.5% of inputs)
  ggx_sample_lobe        seeded uniforms: unit half vectors within 1e-6
                         absolute (atan2, sin and cos differ between XLA
                         and torch in the last bit on up to a quarter of
                         the lanes)
  the lobes              sample_/eval_/pdf_reflect and _refract, run
                         twice from the same inputs: in float64 (the
                         reference under jax.enable_x64) the port equals
                         the reference at rtol 1e-5 (atol 1e-6) on every
                         value and every branch; in float32 each package
                         is within rtol 2e-3 (atol 1e-6) of that float64
                         evaluation. The float32 results differ because
                         XLA's and torch's rsqrt, sqrt, atan2, sin and cos
                         differ in the last bit on a few percent of
                         lanes, and two cancellations magnify that ulp:
                         1 - (n.h)^2 in the distribution near the normal
                         (up to 2.3e-4 relative at alpha 0.05 on these
                         inputs) and the pdf's division by o.h at a
                         grazing half vector (1.4e-3 for the port, 1.2e-3
                         for the reference, on the one lane with
                         |o.h| = 1.9e-4)

The lobes in a scene (glossy, rough-reflection and rough-dielectric
materials on the wavefront and the megastep against the reference) are
held in test_torch_texture.py, on the production luxball, which has all
three.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu.bsdf import ggx as jggx
from fluctus_tpu.vec import Vec3 as JVec3

from fluctus_tpu_torch.bsdf import ggx as tggx
from fluctus_tpu_torch.vec import Vec3 as TVec3

N = 4096


def _unit(rng, n):
    a = rng.normal(size=(n, 3))
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    """Seeded numpy inputs: normal n, incoming direction (toward the
    surface), outgoing direction, a half vector near n, alpha in
    [0.05, 0.55], Ni in [1.2, 2.0], Ks, back faces on 30% of lanes,
    uniforms."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    din = _unit(rng, N)
    flip = (din * n).sum(1) > 0
    din[flip] = -din[flip]
    dout = _unit(rng, N)
    h = n + 0.4 * _unit(rng, N)
    h = (h / np.linalg.norm(h, axis=1, keepdims=True)).astype(np.float32)
    f = lambda *s: rng.random(s).astype(np.float32)
    return dict(n=n, din=din, dout=dout, h=h, alpha=f(N) * 0.5 + 0.05,
                ni=f(N) * 0.8 + 1.2, eta_i=f(N) * 0.8 + 1.0,
                eta_o=f(N) * 0.8 + 1.0, ks=f(N, 3),
                back=rng.random(N) < 0.3, u1=f(N), u2=f(N), u3=f(N))


def _args(x, names, vec, arr):
    return [vec(x[k]) if x[k].ndim == 2 else arr(x[k]) for k in names]


def _run(fn, names, seed=7, wide=False):
    """fn of both packages on the same inputs; results as numpy lists.
    With ``wide`` every float input is float64."""
    x = _inputs(seed)
    if wide:
        x = {k: a.astype(np.float64) if a.dtype == np.float32 else a
             for k, a in x.items()}
    tv = lambda a: TVec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                           for k in range(3)))
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    got = getattr(tggx, fn)(*_args(x, names, tv, torch.from_numpy))
    ref = getattr(jggx, fn)(*_args(x, names, jv, jnp.asarray))
    flat = lambda r: [np.stack([np.asarray(c) for c in v], 1)
                      if isinstance(v, tuple) else np.asarray(v)
                      for v in (r if isinstance(r, tuple)
                                and not hasattr(r, "x") else (r,))]
    return flat(got), flat(ref)


# (function, its arguments by input name)
_TERMS = [("ggx_g1", ("alpha", "din", "n", "h")),
          ("ggx_g", ("alpha", "din", "dout", "n", "h")),
          ("ggx_d", ("alpha", "n", "h")),
          ("ggx_pdf_reflect", ("alpha", "dout", "n", "h")),
          ("ggx_pdf_refract", ("alpha", "eta_i", "eta_o", "din", "dout",
                               "n", "h"))]


@pytest.mark.parametrize("fn,names", _TERMS, ids=[t[0] for t in _TERMS])
def test_ggx_terms(fn, names):
    got, ref = _run(fn, names)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
    assert (ref[0] != 0).mean() > 0.2


def test_ggx_sample_lobe():
    got, ref = _run("ggx_sample_lobe", ("alpha", "n", "u1", "u2"))
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), 1.0,
                               atol=1e-6)


_LOBES = [("sample_reflect", ("n", "ks", "alpha", "ni", "din", "u1", "u2")),
          ("eval_reflect", ("n", "ks", "alpha", "ni", "din", "dout")),
          ("pdf_reflect", ("n", "alpha", "din", "dout")),
          ("sample_refract", ("n", "ks", "alpha", "ni", "back", "din", "u1",
                              "u2", "u3")),
          ("eval_refract", ("n", "ks", "alpha", "ni", "back", "din",
                            "dout")),
          ("pdf_refract", ("n", "alpha", "ni", "back", "din", "dout"))]


@pytest.mark.parametrize("fn,names", _LOBES, ids=[t[0] for t in _LOBES])
def test_ggx_lobes(fn, names):
    got, ref = _run(fn, names)
    with jax.enable_x64(True):
        got64, ref64 = _run(fn, names, wide=True)
    for a, b, a64, b64 in zip(got, ref, got64, ref64):
        assert a64.dtype == b64.dtype == np.float64
        np.testing.assert_allclose(a64, b64, rtol=1e-5, atol=1e-6)
        for out in (a, b):
            assert out.dtype == np.float32
            np.testing.assert_allclose(out, b64, rtol=2e-3, atol=1e-6)
    assert (np.abs(ref[-1]) > 0).mean() > 0.2
