"""The exact-spp job's traffic (``traffic/exact_job.py``) end to end at a
tiny size on the program's CPU path, and the check it brings failing:
the control (the reference in bfloat16 in the program's place) fails
the cell's numbers, and each planted fault of the job makes a run not
correct, by the number that watches it: a tap dropped from the denoise
or one pass fewer (``denoise_err``), the guide normal taken from the
second hit (``feature_err``) and a pixel left a sample short
(``spp_gap``)."""

import inspect
import textwrap

import pytest
import torch

from benchmark.bm import harness
from benchmark.tools.readings import readings

import tiny

torch.set_num_threads(1)

NAME = "luxball_prod.denoise"
SECONDS = 0.05
PARAMS = dict(warm_jobs=1, trace_spp=1)


def _parts(tmp_path):
    b = harness.BENCH
    return dict(device="cpu", scale=tiny.SCALE, params=dict(PARAMS),
                cell=tiny.cell(b, NAME),
                cfg=tiny.config(b, str(tmp_path / "scene")))


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Caches and the trace file of each test's own, so that tests run at
    once do not share the cache's fixed trace file."""
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))


def _run(tmp_path, trace=False, seed=3000000019):
    return harness.run_cell(NAME, seed, SECONDS, trace, **_parts(tmp_path))


def test_exact_job_runs_and_checks(tmp_path):
    res, lines, setup, found = _run(tmp_path)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"msamples_s", "setup_s"}
    w = setup["window"]
    # every job renders each true pixel exactly its spp
    assert w["samples"] == w["jobs"] * 4 * tiny.SCALE[0] * tiny.SCALE[1]
    assert w["segments"] % 16 == 0 and 0 < w["held_lanes"] \
        < w["lane_segments"]
    assert found == []


def test_traced_job_reports_its_layers(tmp_path):
    res, lines, _, _ = _run(tmp_path, trace=True)
    assert res["correct"], lines
    m = res["metrics"]
    assert m["segments.job"]["value"] % 16 == 0
    assert 0 < m["capped_lanes.job"]["value"] < 100
    assert m["frame_ms.job"]["value"] > 0
    # device time exists only on a card
    assert "denoise_ms.job" not in m and "denoise_roofline.job" not in m


def test_control_fails_and_program_passes(tmp_path):
    p = _parts(tmp_path)
    limits = p["cell"]["check"]["limits"]
    rows = readings(NAME, [3000000023], SECONDS, out=lambda line: None, **p)
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    assert set(limits) <= set(prog)
    assert all(prog[k] <= lim for k, lim in limits.items())
    assert any(ctrl[k] > lim for k, lim in limits.items() if k in ctrl)
    assert ctrl["denoise_err"] > limits["denoise_err"]


def _mutated(mod, name, old, new):
    """``mod.name`` rebuilt from its source with ``old`` replaced by
    ``new``, in the module's namespace."""
    src = textwrap.dedent(inspect.getsource(getattr(mod, name)))
    assert old in src, old
    ns = dict(vars(mod))
    exec(compile(src.replace(old, new), mod.__file__, "exec"), ns)
    return ns[name]


def _plant(monkeypatch, fault):
    from fluctus_tpu_torch import renderer as R
    from fluctus_tpu_torch.core import denoise as D
    from fluctus_tpu_torch.core import integrator_wf as W
    if fault == "tap_dropped":
        line = "            dy, dx = (ky - 2) * step, (kx - 2) * step\n"
        monkeypatch.setattr(D, "_iteration", _mutated(
            D, "_iteration", line,
            "            if (ky, kx) == (0, 0):\n"
            "                continue\n" + line))
    elif fault == "pass_fewer":
        f = R.atrous_denoise

        def denoise(*a, **k):
            return f(*a, **dict(k, iterations=1))
        monkeypatch.setattr(R, "atrous_denoise", denoise)
    elif fault == "second_hit_features":
        monkeypatch.setattr(W, "wf_logic_phase", _mutated(
            W, "wf_logic_phase", "nm = alive & (plen == 1)",
            "nm = alive & (plen == 2)"))
    elif fault == "sample_short":
        f = R.wf_segment

        def segment(scene, params, state, config, *a, **k):
            first = float(state.film.weight.sum()) == 0.0
            state, cnt = f(scene, params, state, config, *a, **k)
            if first:     # the job's count of pixel 0 runs one ahead
                spp = state.spp.clone()
                spp[0] += 1
                state = state._replace(spp=spp)
            return state, cnt
        monkeypatch.setattr(R, "wf_segment", segment)


@pytest.mark.parametrize("fault, check", [
    ("tap_dropped", "denoise_err"), ("pass_fewer", "denoise_err"),
    ("second_hit_features", "feature_err"), ("sample_short", "spp_gap")])
def test_planted_fault_is_not_correct(fault, check, tmp_path, monkeypatch):
    _plant(monkeypatch, fault)
    res, lines, _, _ = _run(tmp_path)
    assert not res["correct"], lines
    assert any(ln.startswith(f"check {check} ") and ln.endswith("FAIL")
               for ln in lines), lines
