"""The check can fail: the control (the reference in bfloat16 in the
program's place) fails the cell's numbers, and a run with the timed path
broken underneath comes out not correct, for each fault a renderer's
cell can have: a step that returns its state unchanged, half of the
batch left out of the trace, and an answer altered where it is made (a
splat's radiance, a hit's distance); and so does a run whose shading is
wrong where the reference works it out on its own (a GGX lobe, the
Fresnel term, the albedo's gamma, the env map's radiance). The sharded
exchange between chips is a fault no cell here can have (every cell is
on one chip)."""

import pytest
import torch

from benchmark.bm import harness
from benchmark.tools.readings import readings

import tiny

torch.set_num_threads(1)

CELLS = ["luxball_prod.wavefront", "luxball_prod.preview"]


def _parts(name, tmp_path):
    b = harness.BENCH
    return dict(device="cpu", scale=tiny.SCALE, params=tiny.PARAMS,
                cell=tiny.cell(b, name),
                cfg=tiny.config(b, str(tmp_path / "scene")))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, tmp_path):
    p = _parts(name, tmp_path)
    limits = p["cell"]["check"]["limits"]
    rows = readings(name, [3000000011], tiny.SECONDS[name],
                    out=lambda line: None, **p)
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    assert all(prog[k] <= lim for k, lim in limits.items() if k in prog)
    assert any(ctrl[k] > lim for k, lim in limits.items() if k in ctrl)


def _faulty(monkeypatch, fault):
    from fluctus_tpu_torch import renderer as R
    from fluctus_tpu_torch.core import block_splat as BS
    from fluctus_tpu_torch.core import integrator_wf as W
    if fault == "state_unchanged":
        f = W.wf_shade_phase

        def shade(scene, params, state, config, raw, occ, *a, **k):
            _, cnt = f(scene, params, state, config, raw, occ, *a, **k)
            return state, cnt
        monkeypatch.setattr(W, "wf_shade_phase", shade)
        monkeypatch.setattr(R, "wf_shade_phase", shade)
    elif fault == "half_batch":
        f = W.wf_trace_phase

        def trace(scene, pool, params, config):
            (t, col), occ = f(scene, pool, params, config)
            half = t.shape[0] // 2
            col = col.clone()
            col[half:] = -1
            return (t, col), occ
        monkeypatch.setattr(W, "wf_trace_phase", trace)
        monkeypatch.setattr(R, "wf_trace_phase", trace)
    elif fault == "splat_altered":
        f = BS.splat

        def splat(local, data, film, groups, remaining=None):
            data = data.clone()
            data[0] *= 1.01
            return f(local, data, film, groups=groups, remaining=remaining)
        monkeypatch.setattr(BS, "splat", splat)
    elif fault == "hit_altered":
        f = W.wf_resolve_phase

        def resolve(*a, **k):
            hit, sp = f(*a, **k)
            return hit._replace(t=hit.t * 1.001), sp
        monkeypatch.setattr(W, "wf_resolve_phase", resolve)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "splat_altered", "hit_altered"])
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    _faulty(monkeypatch, fault)
    name = "luxball_prod.wavefront"
    res, lines, _, _ = harness.run_cell(name, 3000000013,
                                        tiny.SECONDS[name], False,
                                        **_parts(name, tmp_path))
    assert not res["correct"], lines


def _shading_fault(monkeypatch, fault):
    from fluctus_tpu_torch.bsdf import dispatch as D
    from fluctus_tpu_torch.bsdf import ggx as G
    from fluctus_tpu_torch.core import integrator_wf as W
    from fluctus_tpu_torch.vec import Vec3
    if fault == "ggx_d":
        f = G.ggx_d
        monkeypatch.setattr(G, "ggx_d", lambda *a: f(*a) * 1.01)
    elif fault == "fresnel":
        f = D.fresnel_dielectric
        monkeypatch.setattr(D, "fresnel_dielectric",
                            lambda *a: (f(*a) * 1.01).clamp_max(1.0))
    elif fault == "albedo_gamma":
        monkeypatch.setattr(D, "mat_get_albedo", D.mat_get_float3)
    elif fault == "env_radiance":
        f = W.env_radiance_and_pdf

        def env(*a):
            c, pdf = f(*a)
            return Vec3(c.x * 1.01, c.y, c.z), pdf
        monkeypatch.setattr(W, "env_radiance_and_pdf", env)


@pytest.mark.parametrize("fault", ["ggx_d", "fresnel", "albedo_gamma",
                                   "env_radiance"])
def test_wrong_shading_is_not_correct(fault, tmp_path, monkeypatch):
    _shading_fault(monkeypatch, fault)
    name = "luxball_prod.wavefront"
    res, lines, _, _ = harness.run_cell(name, 3000000017,
                                        tiny.SECONDS[name], False,
                                        **_parts(name, tmp_path))
    assert not res["correct"], lines
    assert any(ln.startswith("check shade_bad") and ln.endswith("FAIL")
               for ln in lines), lines
