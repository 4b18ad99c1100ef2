"""The flat ring's exact-spp job (``traffic/exact_flat.py``) end to end
at a tiny size on the program's CPU path, and the check it brings
failing: the control (the reference in bfloat16 in the program's place)
fails the cell's numbers, and each planted fault of the flat ring makes a
run not correct, by the number that watches it: a raygen off by one lane
(``ring_bad``), an admission that lets one extra record in
(``admit_bad``) and a film scatter that drops a channel (``splat_err``).
A program without the refused-path counter or the ring spans (the tree
before them) runs correct, and the new readers give None. The ring's
readers and byte count, worked by hand on a stub session."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.bm import harness, ring_work
from benchmark.tools.readings import readings

import tiny

torch.set_num_threads(1)

NAME = "luxball_prod.flat_exact"
SECONDS = 0.05
PARAMS = dict(warm_jobs=1, trace_spp=1)
NEW = ("ring_ms.job", "ring_roofline.job", "refused_paths.job")


def _parts(tmp_path):
    b = harness.BENCH
    cfg = tiny.config(b, str(tmp_path / "scene"))
    cfg["wfBlockRing"] = False      # luxball_prod_flat's one change
    return dict(device="cpu", scale=tiny.SCALE, params=dict(PARAMS),
                cell=tiny.cell(b, NAME), cfg=cfg)


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Caches and the trace file of each test's own."""
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))


def _run(tmp_path, trace=False, seed=3000000037, **params):
    p = _parts(tmp_path)
    p["params"].update(params)
    return harness.run_cell(NAME, seed, SECONDS, trace, **p)


def test_config_is_luxball_prod_on_the_flat_ring():
    a = harness.load_json(harness.BENCH, "configs", "luxball_prod.json")
    b = harness.load_json(harness.BENCH, "configs", "luxball_prod_flat.json")
    assert b["wfBlockRing"] is False and a["wfBlockRing"] is True
    differ = {k for k in a.keys() | b.keys() if a.get(k) != b.get(k)}
    assert differ == {"wfBlockRing", "source", "assumed"}
    assert b["reduced"] == []


def test_flat_job_runs_and_checks(tmp_path):
    res, lines, setup, found = _run(tmp_path)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"msamples_s", "setup_s"}
    w = setup["window"]
    # every job renders each pixel exactly its spp
    assert w["samples"] == w["jobs"] * 16 * tiny.SCALE[0] * tiny.SCALE[1]
    assert w["admitted_paths"] == w["samples"]
    assert w["segments"] % 16 == 0 and 0 < w["held_lanes"] \
        < w["lane_segments"]
    assert w["refused_paths"] > 0
    for k in ("ring_bad", "admit_bad", "spp_gap"):
        assert res["checks"][k]["value"] == 0, k
    assert found == []


def test_traced_flat_job_reports_its_layers(tmp_path):
    res, lines, _, _ = _run(tmp_path, trace=True)
    assert res["correct"], lines
    m = res["metrics"]
    assert m["segments.job"]["value"] % 16 == 0
    assert 0 < m["capped_lanes.job"]["value"] < 100
    assert 0 < m["refused_paths.job"]["value"] < 100
    assert m["frame_ms.job"]["value"] > 0
    # device time exists only on a card
    assert "ring_ms.job" not in m and "ring_roofline.job" not in m


def test_control_fails_and_program_passes(tmp_path):
    p = _parts(tmp_path)
    limits = p["cell"]["check"]["limits"]
    rows = readings(NAME, [3000000041], SECONDS, out=lambda line: None, **p)
    prog, ctrl = rows[0]["program"], rows[0]["control"]
    assert set(limits) <= set(prog)
    assert all(prog[k] <= lim for k, lim in limits.items())
    assert any(ctrl[k] > lim for k, lim in limits.items() if k in ctrl)


def _plant(monkeypatch, fault):
    from fluctus_tpu_torch.core import pixel_ring as PR
    if fault == "raygen_off_by_one":
        def exclusive_rank(mask):
            incl = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
            return incl, incl[-1]
        monkeypatch.setattr(PR, "exclusive_rank", exclusive_rank)
    elif fault == "admit_one_extra":
        f = PR.run_ranks
        monkeypatch.setattr(PR, "run_ranks",
                            lambda key: (f(key) - 1).clamp_min(0))
    elif fault == "scatter_drops_blue":
        f = PR.scatter_pixels

        def scatter_pixels(seg, data, num_pixels):
            if data.ndim == 2 and data.shape[1] == 4:
                data = data.clone()
                data[:, 2] = 0.0
            return f(seg, data, num_pixels)
        monkeypatch.setattr(PR, "scatter_pixels", scatter_pixels)


# at this size the kept segment (the job's second) holds pixels at the
# edge of their budget only in a one-sample job; in the cell's 16-spp
# job it is the 66th of 80, where they are common
@pytest.mark.parametrize("fault, check, spp", [
    ("raygen_off_by_one", "ring_bad", 16),
    ("admit_one_extra", "admit_bad", 1),
    ("scatter_drops_blue", "splat_err", 16)])
def test_planted_fault_is_not_correct(fault, check, spp, tmp_path,
                                      monkeypatch):
    from fluctus_tpu_torch.core import pixel_ring as PR
    # the probe's hook wraps the planted function; both go back after
    monkeypatch.setattr(PR, "scatter_pixels", PR.scatter_pixels)
    _plant(monkeypatch, fault)
    res, lines, _, _ = _run(tmp_path, spp=spp)
    assert not res["correct"], lines
    assert any(ln.startswith(f"check {check} ") and ln.endswith("FAIL")
               for ln in lines), lines


def test_without_the_counter_and_spans(tmp_path, monkeypatch):
    """The tree before the counter and the spans: ``CappedStats`` of four
    fields and no ``flt::ring.*`` span. The run is correct, and the new
    readers give None."""
    import contextlib
    from typing import NamedTuple

    from fluctus_tpu_torch import renderer as R
    from fluctus_tpu_torch.core import pixel_ring as PR

    class Old(NamedTuple):
        segments: int
        lanes: int
        held: int
        admitted: int
    f = R.Renderer.capped_stats
    monkeypatch.setattr(R.Renderer, "capped_stats",
                        lambda self: Old(*f(self)[:4]))
    monkeypatch.setattr(PR, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(PR, "scatter_pixels", PR.scatter_pixels)
    res, lines, setup, _ = _run(tmp_path, trace=True)
    assert res["correct"], lines
    assert "refused_paths" not in setup["window"]
    assert not set(NEW) & set(res["metrics"])
    assert res["metrics"]["segments.job"]["value"] % 16 == 0


def _stub(ring_us, segments=2, cuda=True, capped=None, window=None,
          job_spp=1, block_ring=False):
    """A session whose trace holds ``ring_us`` (device us by ring span,
    summed over ``segments`` segments), after a traced job of
    ``job_spp``."""
    stats = {f"flt::ring.{k}": SimpleNamespace(device_us=v, count=segments)
             for k, v in ring_us.items()}
    stats["flt::segment"] = SimpleNamespace(device_us=0.0, count=segments)
    t = SimpleNamespace(cuda=cuda, get=stats.get)
    r = SimpleNamespace(width=4, height=2)
    if capped is not None:
        r.capped_stats = lambda: capped
    return SimpleNamespace(summary=object(), flt_spans=t, r=r,
                           window=window or {}, job_spp=job_spp,
                           cfg=dict(wfBlockRing=block_ring))


def _read(name, s):
    return harness.load_module("metrics", name).read(s)


def test_ring_bytes_by_hand():
    # 4 lanes: pixel id and count read, new pixel written (12 B each);
    # 3 admitted records of 16 B; 3 pixels, each 4 floats and a count
    # read and written (40 B)
    assert ring_work.segment_bytes(4, 3, 3) == 4 * 12 + 3 * 16 + 3 * 40
    # two records on one pixel: that pixel is read and written once
    assert ring_work.segment_bytes(4, 3, 2) == 4 * 12 + 3 * 16 + 2 * 40


def test_ring_readers_on_a_stub():
    from fluctus_tpu_torch.renderer import CappedStats
    capped = CappedStats(segments=2, lanes=4, held=1, admitted=6, refused=2)
    s = _stub({"fetch": 1.0, "admit": 2.0, "scatter": 3.0, "raygen": 4.0},
              capped=capped)
    assert _read("ring_ms.job", s) == pytest.approx(5e-3)
    # a 1-spp job admits at most one record a pixel: 3 records, 3 pixels
    least = ring_work.segment_bytes(4, 3, 3) / 3.35e12
    assert _read("ring_roofline.job", s) == pytest.approx(
        100.0 * least / 5e-6)
    # a job of more spp, or the block ring: its touched pixels or its
    # timed work are not counted, so no share
    ring = {"fetch": 1.0, "scatter": 3.0}
    for other in (_stub(ring, capped=capped, job_spp=16),
                  _stub(ring, capped=capped, block_ring=True)):
        assert _read("ring_ms.job", other) is not None
        assert _read("ring_roofline.job", other) is None
    assert _read("refused_paths.job", s) == pytest.approx(25.0)
    w = dict(refused_paths=1, admitted_paths=9)
    assert _read("refused_paths.job", _stub({}, capped=capped,
                                            window=w)) == pytest.approx(10.0)
    # without ring spans, off a card, or without the counter: None
    for s in (_stub({}, capped=capped), _stub({"fetch": 1.0}, cuda=False,
                                              capped=capped)):
        assert _read("ring_ms.job", s) is None
        assert _read("ring_roofline.job", s) is None
    old = SimpleNamespace(segments=2, lanes=4, held=1, admitted=6)
    assert _read("refused_paths.job", _stub({}, capped=old)) is None
