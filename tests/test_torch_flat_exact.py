"""The exact-spp final frame on the flat pixel ring (``Settings.
wf_block_ring`` off: ``reset``, ``render_single``, ``save_image``)
against the benchmark's plain reference (``benchmark/reference/
flat_exact.py``: float64 torch that imports nothing of the program), on
the CPU at a tiny size: the benchmark's tiny scene (a textured floor, a
glossy cube and a rough glass cube under the area light and the env map)
at 16 x 8 with 256 paths, 16 spp, seeded.

Every segment of the job is recorded and followed by the reference, and
the job's outcome is held to it:

  segments          on every lane of every segment: the trace, the hit
                    records, the logic under the spp cap, the admission
                    (each pixel's admitted lanes and its count after the
                    segment) and the raygen (each lane's pixel, the
                    cursor) agree exactly, and the film after the
                    segment is within 1e-6 of a float64 sum of the
                    admitted records (float32 sums of a few records)
  job               the film within 1e-6 of the reference's admission of
                    every segment's records, counting each pixel's
                    samples itself; every pixel's weight and count
                    exactly 16; the cursor followed from 0 through every
                    segment lands where the program's does; the PNG's
                    8-bit values equal the reference's tonemap of the
                    film
  counter           ``capped_stats().refused`` equals the reference's
                    count of records refused, on the flat ring and on
                    the block ring, and ``CappedStats`` still builds from
                    its first four fields
  spans             under ``torch.profiler`` the ring's work is marked by
                    ``flt::ring.fetch``, ``.admit``, ``.scatter`` and
                    ``.raygen`` inside each ``flt::segment``, on both
                    rings; the film is bit-equal to the unprofiled job's
  faults            a raygen off by one lane, an admission that lets one
                    extra record in and a scatter that drops a channel
                    each fail the number that watches it"""

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from benchmark.bm import harness  # noqa: E402
from benchmark.bm.capture import Segment  # noqa: E402
from benchmark.bm.flat_capture import FlatJobProbe, FlatSegment  # noqa: E402
from benchmark.bm.probe import Probe  # noqa: E402
from benchmark.reference import checks, exact, flat_exact  # noqa: E402
from fluctus_tpu_torch import renderer as R  # noqa: E402
from fluctus_tpu_torch.core import block_splat as BS  # noqa: E402
from fluctus_tpu_torch.core import integrator_wf as W  # noqa: E402
from fluctus_tpu_torch.core import pixel_ring as PR  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "luxball_prod.flat_exact"
SPP = 16
SEED = 3000000031
RING_SPANS = ("fetch", "admit", "scatter", "raygen")
# the hooks the probes install, put back after each job
HOOKED = ((W, "wf_trace_phase"), (W, "wf_shade_phase"),
          (W, "wf_resolve_phase"), (R, "wf_trace_phase"),
          (R, "wf_shade_phase"), (R, "wf_reset"), (R, "wf_segment"),
          (R, "atrous_denoise"), (BS, "splat"), (PR, "scatter_pixels"),
          (PR, "exclusive_rank"), (PR, "run_ranks"))


def _tiny():
    path = os.path.join(ROOT, "benchmark", "tests", "tiny.py")
    spec = importlib.util.spec_from_file_location("bm_tiny", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fault(mp, fault):
    """Plant ``fault`` in the flat ring."""
    if fault == "raygen_off_by_one":
        def exclusive_rank(mask):
            incl = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
            return incl, incl[-1]     # each ended lane one pixel on
        mp.setattr(PR, "exclusive_rank", exclusive_rank)
    elif fault == "admit_one_extra":
        f = PR.run_ranks
        mp.setattr(PR, "run_ranks", lambda key: (f(key) - 1).clamp_min(0))
    elif fault == "scatter_drops_blue":
        f = PR.scatter_pixels

        def scatter_pixels(seg, data, num_pixels):
            if data.ndim == 2 and data.shape[1] == 4:
                data = data.clone()
                data[:, 2] = 0.0
            return f(seg, data, num_pixels)
        mp.setattr(PR, "scatter_pixels", scatter_pixels)


def _run_job(tmp, block_ring, fault=None):
    """One job, every segment recorded, then once more under the
    profiler."""
    tiny = _tiny()
    cell = tiny.cell(harness.BENCH, NAME)
    cfg = tiny.config(harness.BENCH, str(tmp / "scene"))
    cfg["wfBlockRing"] = block_ring
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "CACHE", str(tmp / "cache"))
    for mod, name in HOOKED:
        mp.setattr(mod, name, getattr(mod, name))
    try:
        _fault(mp, fault)
        r = harness.make_renderer(cfg, torch.device("cpu"), tiny.SCALE)
        probe = Probe(SEED)
        probe.install(r)
        FlatJobProbe(probe).install()
        caps = []
        f = R.wf_segment

        def recording(*a, **k):
            out = f(*a, **k)
            caps.append(probe.last)
            return out
        mp.setattr(R, "wf_segment", recording)
        r.reset()
        r.render_single(SPP)
        png = str(tmp / "job.png")
        r.save_image(png)
        out = dict(r=r, cfg=cfg, caps=list(caps), png=png,
                   stats=r.capped_stats(),
                   film=[a.clone() for a in (*r.film.color, r.film.weight)])
        r.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render_single(SPP)
        trace = tmp / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        out["spans"] = sorted(
            ((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("flt::")), key=lambda s: s[1])
        out["traced_film"] = [a.clone() for a in (*r.film.color,
                                                   r.film.weight)]
        out["ref"] = harness.reference_scene(
            harness.Session(cell, cfg, NAME, SEED, 0.0, False,
                            torch.device("cpu")))
        out["logic"] = harness.load_module(
            "traffic", "exact_job").logic_config(cfg, r)
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}

    def get(ring, fault=None):
        key = (ring, fault)
        if key not in out:
            tmp = tmp_path_factory.mktemp(f"{ring}_{fault}")
            out[key] = _run_job(tmp, ring == "block", fault)
        return out[key]
    return get


def _flat(job, cap):
    return FlatSegment(cap, job["ref"].params())


def test_every_flat_segment_follows_the_reference(jobs):
    job = jobs("flat")
    ref = job["ref"]
    assert not job["r"]._wf_cfg.block_ring
    assert len(job["caps"]) % 16 == 0
    for k, cap in enumerate(job["caps"]):
        n = flat_exact.flat_segment_numbers(_flat(job, cap), ref,
                                            job["logic"], 256, SEED + k, SPP)
        assert n["trace_bad"] == n["resolve_bad"] == n["shade_bad"] == 0, k
        assert n["admit_bad"] == n["ring_bad"] == 0, (k, n)
        assert n["splat_err"] <= 1e-6, (k, n)


def test_flat_job_film_spp_pixels_and_png(jobs):
    job = jobs("flat")
    r, caps = job["r"], job["caps"]
    npx = r.width * r.height
    film = torch.zeros(4, npx, dtype=torch.float64)
    spp = torch.zeros(npx, dtype=torch.int64)
    cursor = 0
    for cap in caps:
        seg = _flat(job, cap)
        pixel = seg.pool0.pixel_index
        assert torch.equal(seg.spp0.long(), spp)
        take = flat_exact.admitted(seg.splat_data[3] > 0.5, pixel, spp, SPP)
        film = flat_exact.film_after(film, pixel, seg.splat_data, take,
                                     torch.float64)
        spp = flat_exact.spp_after(spp, pixel, take)
        new, cursor = flat_exact.raygen(seg.pool1.path_len == 0, pixel,
                                        cursor, npx)
        assert torch.equal(new, seg.pool1.pixel_index.long())
        assert int(seg.cursor1) == cursor
    last = caps[-1]["state_out"]
    assert checks.splat_error(torch.stack([*last.film.color,
                                           last.film.weight]), film) <= 1e-6
    assert torch.equal(torch.stack(job["film"]), torch.stack(
        [*last.film.color, last.film.weight]))
    w = r.film.weight
    assert w.shape[0] == npx and torch.equal(w, torch.full_like(w, SPP))
    assert torch.equal(spp, torch.full_like(spp, SPP))
    assert torch.equal(last.spp.long(), spp)
    assert exact.spp_gap(w, SPP) == 0
    f = r.film
    levels = checks.frame_levels(f.color, f.weight, r.width, r.height, 1.0,
                                 job["cfg"]["tonemap"], torch.float64)
    assert checks.frame_bad(checks.read_png(job["png"]), levels) == 0.0


def _refused(job):
    """The reference's count of the job's records that the cap refused:
    the records that tried to splat less those each pixel admits."""
    out = 0
    for cap in job["caps"]:
        st0 = cap["state_in"]
        if cap["config"].block_ring:
            seg = Segment(cap, job["ref"].params())
            tried = seg.splat_local >= 0
            pixel = checks.ring_pixels(seg.splat_local, seg.groups,
                                       seg.pk).clamp_min(0)
        else:
            seg = _flat(job, cap)
            tried = seg.splat_data[3] > 0.5
            pixel = seg.pool0.pixel_index
        take = flat_exact.admitted(tried, pixel, st0.spp, SPP)
        out += int(tried.sum()) - int(take.sum())
    return out


@pytest.mark.parametrize("ring", ["flat", "block"])
def test_refused_counter_equals_the_reference(jobs, ring):
    job = jobs(ring)
    st = job["stats"]
    assert job["r"]._wf_cfg.block_ring == (ring == "block")
    assert (st.segments, st.lanes) == (len(job["caps"]), 256)
    assert st.admitted == SPP * job["r"].width * job["r"].height
    assert st.refused == _refused(job) > 0
    assert R.CappedStats(0, 0, 0, 0).refused == 0


@pytest.mark.parametrize("ring", ["flat", "block"])
def test_ring_spans(jobs, ring):
    job = jobs(ring)
    spans = job["spans"]
    segs = [s for s in spans if s[0] == "flt::segment"]
    assert len(segs) == len(job["caps"])
    for part in RING_SPANS:
        got = [s for s in spans if s[0] == f"flt::ring.{part}"]
        assert got, part
        assert all(any(g[1] <= s[1] and s[2] <= g[2] for g in segs)
                   for s in got), part
    # fetch and admit once a capped segment; the film's scatter too
    for part in ("fetch", "admit"):
        assert sum(s[0] == f"flt::ring.{part}" for s in spans) == len(segs)
    assert all(torch.equal(a, b) for a, b in zip(job["film"],
                                                 job["traced_film"]))


@pytest.mark.parametrize("fault, check", [
    ("raygen_off_by_one", "ring_bad"), ("admit_one_extra", "admit_bad"),
    ("admit_one_extra", "splat_err"), ("scatter_drops_blue", "splat_err")])
def test_planted_fault_fails_its_check(jobs, fault, check):
    job = jobs("flat", fault)
    limit = 1e-5 if check == "splat_err" else 0
    worst = max(flat_exact.flat_segment_numbers(
        _flat(job, cap), job["ref"], job["logic"], 256, SEED + k, SPP)[check]
        for k, cap in enumerate(job["caps"]))
    assert worst > limit, (fault, check, worst)
