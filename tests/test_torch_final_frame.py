"""The denoised final-frame job (``Renderer.render_single`` with the
denoiser on, then ``save_denoised``) against the benchmark's plain
reference (``benchmark/reference/``: float64 torch that imports nothing
of the program), on the CPU at a tiny size: the benchmark's tiny scene
(a textured floor, a glossy cube and a rough glass cube under the area
light and the env map) at 16 x 8 with 256 paths, 4 spp, seeded.

Every segment of the job is recorded and followed by the reference, and
the job's outcome is held to it:

  segments          on every lane of every segment: the trace, the hit
                    records, the logic under the spp cap and the guide
                    records agree (no lane differs), the film's capped
                    splat and the feature film's splat within 1e-6 of a
                    float64 scatter (float32 sums of at most 4 records)
  film              the job's film within 1e-6 of the reference's capped
                    scatter of every segment's records, counting each
                    pixel's samples itself
  spp               every pixel's weight and count exactly 4
  features          the guide film within 1e-6 of the float64 sum of
                    every segment's records
  denoised image    within 1e-5 (relative, floor 1e-3) of the
                    reference's a-trous filter of the program's film and
                    features (float32 against float64 over two passes)
  PNG               no pixel more than one 8-bit step from the
                    reference's tonemap of its image, and at most 1% one
                    step off (a float32 value on a rounding edge)
  counter           ``capped_stats`` equals a host recount of the same
                    segments' idle lanes and admitted records
  spans             under ``torch.profiler`` the job is one ``flt::job``
                    with an ``flt::job.check`` every 16 segments, the
                    denoise one ``flt::denoise`` of two ``.iter``, and the
                    write one ``flt::frame`` holding tonemap, copy, host
                    and encode; the film is bit-equal to the unprofiled
                    job's"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from benchmark.bm import harness  # noqa: E402
from benchmark.bm.job_probe import JobProbe  # noqa: E402
from benchmark.bm.probe import Probe  # noqa: E402
from benchmark.reference import checks, denoise, exact  # noqa: E402
from fluctus_tpu_torch import renderer as R  # noqa: E402
from fluctus_tpu_torch.core import block_splat as BS  # noqa: E402
from fluctus_tpu_torch.core import integrator_wf as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPP = 4
SEED = 3000000029
# the hooks the probes install, put back after the test
HOOKED = ((W, "wf_trace_phase"), (W, "wf_shade_phase"),
          (W, "wf_resolve_phase"), (R, "wf_trace_phase"),
          (R, "wf_shade_phase"), (R, "wf_reset"), (R, "wf_segment"),
          (R, "atrous_denoise"), (BS, "splat"))


def _tiny():
    path = os.path.join(ROOT, "benchmark", "tests", "tiny.py")
    spec = importlib.util.spec_from_file_location("bm_tiny", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The job, run once with every segment recorded, then once more
    under the profiler."""
    tmp = tmp_path_factory.mktemp("final_frame")
    tiny = _tiny()
    cell = tiny.cell(harness.BENCH, "luxball_prod.denoise")
    cfg = tiny.config(harness.BENCH, str(tmp / "scene"))
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "CACHE", str(tmp / "cache"))
    for mod, name in HOOKED:
        mp.setattr(mod, name, getattr(mod, name))
    try:
        r = harness.make_renderer(cfg, torch.device("cpu"), tiny.SCALE)
        probe = Probe(SEED)
        probe.install(r)
        jp = JobProbe(probe)
        jp.install()
        caps = []
        f = R.wf_segment

        def recording(*a, **k):
            out = f(*a, **k)
            caps.append(probe.last)
            return out
        mp.setattr(R, "wf_segment", recording)
        r.settings.use_denoiser = True
        r.rebuild_config()
        r.reset()
        r.render_single(SPP)
        png = str(tmp / "job.png")
        r.save_denoised(png, blend=cell["params"]["denoise"]["blend"])
        out = dict(r=r, cfg=cfg, cell=cell, caps=list(caps), png=png,
                   denoised=jp.denoised, stats=r.capped_stats(),
                   film=[a.clone() for a in (*r.film.color, r.film.weight)])
        r.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render_single(SPP)
            r.save_denoised(str(tmp / "traced.png"))
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
            harness.Session(cell, cfg, "luxball_prod.denoise", SEED, 0.0,
                            False, torch.device("cpu")))
        yield out
    finally:
        mp.undo()


TRAFFIC = harness.load_module("traffic", "exact_job")
_segment = TRAFFIC.job_segment


def test_every_segment_follows_the_reference(job):
    ref = job["ref"]
    cfg = TRAFFIC.logic_config(job["cfg"], job["r"])
    assert len(job["caps"]) % 16 == 0
    for k, cap in enumerate(job["caps"]):
        n = exact.exact_segment_numbers(_segment(cap, ref), ref, cfg, 256,
                                        SEED + k, SPP)
        assert n["trace_bad"] == n["resolve_bad"] == n["shade_bad"] == 0, k
        assert n["feature_err"] <= 1e-6 and n["splat_err"] <= 1e-6, (k, n)


def test_film_spp_and_features(job):
    r, caps = job["r"], job["caps"]
    seg0 = _segment(caps[0], job["ref"])
    film = torch.zeros_like(seg0.film0, dtype=torch.float64)
    feat = torch.zeros_like(seg0.features["film0"], dtype=torch.float64)
    for cap in caps:
        seg = _segment(cap, job["ref"])
        # the reference counts each pixel's samples itself; dead padded
        # slots are parked as the program parks them
        spp = torch.where(seg.spp0 >= 1 << 29, seg.spp0,
                          film[3].round().to(torch.int32))
        film = exact.capped_splat(film, seg.splat_local, seg.splat_data,
                                  seg.groups, seg.pk, spp, SPP,
                                  torch.float64)
        f = seg.features
        feat = checks.splat_reference(feat, f["local"], f["data"],
                                      seg.groups, seg.pk, torch.float64)
    last = caps[-1]["state_out"]
    stack = lambda fl: torch.stack([*fl.color, fl.weight])
    assert checks.splat_error(stack(last.film), film) <= 1e-6
    assert torch.equal(W.unpad_pixels(stack(last.film).T, r._wf_cfg),
                       torch.stack(job["film"]).T)
    w = r.film.weight
    assert w.shape[0] == r.width * r.height
    assert torch.equal(w, torch.full_like(w, SPP))
    spp = W.unpad_pixels(last.spp, r._wf_cfg)
    assert torch.equal(spp, torch.full_like(spp, SPP))
    assert exact.spp_gap(w, SPP) == 0
    fs = lambda fl: torch.stack([*fl.albedo, fl.albedo_w, *fl.normal,
                                 fl.normal_w])
    assert checks.splat_error(fs(last.features), feat) <= 1e-6
    assert torch.equal(W.unpad_pixels(fs(last.features).T, r._wf_cfg),
                       fs(r.features).T)


def test_denoised_image_and_png(job):
    r = job["r"]
    p = job["cell"]["params"]["denoise"]
    ref_img = denoise.denoised(r.film, r.features, r.height, r.width, p,
                               torch.float64)
    assert denoise.denoise_error(job["denoised"], ref_img) <= 1e-5
    levels = denoise.levels(ref_img, 1.0, job["cfg"]["tonemap"])
    got = checks.read_png(job["png"])
    assert denoise.frame_off(got, levels) == 0.0
    assert np.mean(got != levels) <= 0.01


def test_capped_counter_equals_a_recount(job):
    ref, caps, st = job["ref"], job["caps"], job["stats"]
    held = sum(int(exact.held_lanes(_segment(c, ref), SPP).sum())
               for c in caps)
    admitted = sum(int(c["state_out"].film.weight.sum()
                       - c["state_in"].film.weight.sum()) for c in caps)
    npx = job["r"].width * job["r"].height
    assert (st.segments, st.lanes) == (len(caps), 256)
    assert st.held == held > 0
    assert st.admitted == admitted == SPP * npx


def test_job_spans(job):
    spans = job["spans"]
    names = [s[0] for s in spans]
    jobs = [s for s in spans if s[0] == "flt::job"]
    assert len(jobs) == 1
    segs = [s for s in spans if s[0] == "flt::segment"]
    checks_ = [s for s in spans if s[0] == "flt::job.check"]
    assert len(segs) == 16 * len(checks_) > 0
    assert all(jobs[0][1] <= s[1] and s[2] <= jobs[0][2]
               for s in segs + checks_)
    dn = [s for s in spans if s[0] == "flt::denoise"]
    assert len(dn) == 1
    iters = [s for s in spans if s[0] == "flt::denoise.iter"]
    assert len(iters) == 2 and all(dn[0][1] <= s[1] and s[2] <= dn[0][2]
                                   for s in iters)
    frames = [s for s in spans if s[0] == "flt::frame"]
    assert len(frames) == 1 and frames[0][1] >= dn[0][2]
    for part in ("tonemap", "copy", "host", "encode"):
        got = [s for s in spans if s[0] == f"flt::frame.{part}"]
        assert len(got) == 1 and frames[0][1] <= got[0][1] \
            and got[0][2] <= frames[0][2], part
    assert names.index("flt::frame.encode") > names.index("flt::frame.copy")
    assert all(torch.equal(a, b) for a, b in zip(job["film"],
                                                 job["traced_film"]))
