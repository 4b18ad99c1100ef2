"""One captured segment of the exact-spp job on the flat pixel ring
(fluctus's own: one global raygen cursor, wf_raygen.cl:25, advanced by
the host by the raygen count, tracer.cpp:336; the film, the sample
counts and the cursor in true pixel order), under the CHECK_SPP cap
(wf_logic.cl:76-84), followed from the program's own pool as ``checks``
follows a free-running segment, with what the cap and the one ring add:

- the spp fetch: each lane reads its pixel's sample count by a gather of
  the true-pixel count table; a lane whose pixel has reached the job's
  target ends its path there, held idle, and splats nothing;
- the admission: each pixel admits, of its splatting lanes in lane
  order, exactly its remaining budget (target less its count); the film
  after the segment is the film before plus the admitted records, summed
  in float64, and the count table gains the admitted counts, exactly.
  On the card the program adds its records by float atomics, in no fixed
  order, so its film differs from this sum by float32 rounding alone;
- the raygen: the lanes that ended take ``cursor + r`` modulo the pixel
  count, r their exclusive rank among the ended lanes in lane order, and
  the cursor moves on by their number.

The logic of a lane is ``lanes.segment_lanes``; the cap enters it as in
``exact``: a held lane is handed a zero pdf, which ends its path at the
same step and with the same draws, and its splat record is taken away.
The admission and the raygen are integer bookkeeping over the whole
pool, so they are held to the program exactly (``admit_bad``,
``ring_bad``); they take the program's own splat flags and ended lanes,
which the lane logic checks on the sampled lanes. Roulette is off in
every exact job, as fluctus turns it off there.

The trace, hit-record and lane stages are ``exact.exact_segment_numbers``'
own, written out again here: that function reads the block ring's
padded layout and the denoiser's guide features, which this job has
not."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import checks
from .exact import lane_ranks
from .lanes import segment_lanes
from .shading import pick


def pixel_spp(spp0, pixel):
    """Each lane's pixel's sample count: a gather of the count table."""
    return spp0[pixel.long()]


def admitted(tried, pixel, spp0, target: int):
    """Which of the lanes that tried to splat (``tried``, [n] bool, on
    their ``pixel``) each pixel admits: its first ``target - spp0``
    in lane order."""
    key = torch.where(tried, pixel.long(), -1)
    rank = lane_ranks(key)
    budget = (target - spp0.long()).clamp_min(0)
    return tried & (rank < budget[pixel.long()])


def film_after(film0, pixel, data, take, dtype):
    """``film0`` [4, P] plus the records ``data`` [4, n] of the lanes
    ``take`` at their ``pixel``, summed in ``dtype``."""
    acc = film0.to(dtype).clone()
    acc.index_add_(1, pixel[take].long(), data[:, take].to(dtype))
    return acc


def spp_after(spp0, pixel, take):
    """The count table after the segment: each pixel's count plus the
    records it admitted."""
    return spp0.long() + torch.bincount(pixel[take].long(),
                                        minlength=spp0.shape[0])


def raygen(ended, pixel0, cursor0: int, num_pixels: int):
    """Each lane's pixel after the raygen, and the cursor after it: an
    ended lane takes ``cursor0 + r`` modulo ``num_pixels`` (r its
    exclusive rank among the ended lanes, in lane order); the others keep
    their pixel."""
    e = ended.long()
    rank = torch.cumsum(e, 0) - e
    new = torch.where(ended, (cursor0 + rank) % num_pixels, pixel0.long())
    return new, (cursor0 + int(e.sum())) % num_pixels


def admit_bad(seg, target: int) -> float:
    """The share of pixels with a splatting lane whose admitted lanes, or
    whose count after the segment, differ from the reference's."""
    tried = seg.splat_data[3] > 0.5
    pixel = seg.pool0.pixel_index
    ref_take = admitted(tried, pixel, seg.spp0, target)
    prog_take = seg.splat_index.long() < seg.npx
    touched = torch.zeros(seg.npx, dtype=torch.bool, device=pixel.device)
    touched[pixel[tried | prog_take].long()] = True
    differ = torch.zeros_like(touched)
    off = ref_take != prog_take
    differ[pixel[off].long()] = True
    # an admitted lane's record lands on its own pixel
    wrong = prog_take & (seg.splat_index.long() != pixel.long())
    differ[pixel[wrong].long()] = True
    differ |= spp_after(seg.spp0, pixel, ref_take) != seg.spp1.long()
    n = int((touched | differ).sum())
    return float(differ.sum()) / n if n else 0.0


def ring_bad(seg, idx) -> float:
    """The share of the lanes ``idx`` whose pixel after the raygen is not
    the reference's; 1 where the cursor after it is not."""
    ended = seg.pool1.path_len == 0
    new, cursor1 = raygen(ended, seg.pool0.pixel_index, int(seg.cursor0),
                          seg.npx)
    if int(seg.cursor1) != cursor1:
        return 1.0
    bad = new[idx] != seg.pool1.pixel_index[idx].long()
    return float(bad.float().mean()) if idx.numel() else 0.0


def flat_segment_numbers(seg, ref, cfg, k, seed, target, control=None):
    """``trace_bad``, ``resolve_bad``, ``shade_bad``, ``splat_err``,
    ``admit_bad`` and ``ring_bad`` of the captured flat exact segment
    ``seg`` (``bm/flat_capture.FlatSegment``) on ``k`` lanes drawn from
    ``seed``, under the job's ``target``. With ``control`` the reference
    computed in that lower type takes the program's place in the float
    stages, as in ``checks.segment_numbers``; the integer bookkeeping
    (admission, raygen) is the same in any type."""
    dev = ref.device
    f64 = torch.float64
    n = seg.pool0.seed.shape[0]
    idx = checks.sample_lanes(n, k, seed, dev)
    p0 = checks.gather_pool(seg.pool0, idx)
    params = seg.ref_params
    light = params.light
    held = (pixel_spp(seg.spp0, seg.pool0.pixel_index) >= target)[idx]

    kind_r, t_r, _ = checks.trace_outcome(ref, p0.orig, p0.dir, light,
                                          cfg.sample_impl, torch.float32)
    pending = p0.shadow_pending
    tmax = torch.where(pending, p0.shadow_len, 0.0)
    occ_r = checks.shadow_outcome(ref, p0.shadow_orig, p0.shadow_dir, tmax,
                                  light, torch.float32)
    if control is None:
        hit = seg.hit
        kind_p = checks.program_kind(hit)[idx]
        t_p = hit.t[idx].double()
        occ_p = seg.occluded[idx]
        tri_p = hit.i[idx]
    else:
        kind_p, t_p, tri_p = checks.trace_outcome(
            ref, p0.orig, p0.dir, light, cfg.sample_impl, control)
        occ_p = checks.shadow_outcome(ref, p0.shadow_orig, p0.shadow_dir,
                                      tmax, light, control)
    bad, rays, ext_ok = checks.trace_compare(kind_p, t_p, occ_p, kind_r,
                                             t_r, occ_r, pending)
    out = dict(trace_bad=bad / max(rays, 1))
    sh_ok = (occ_p == occ_r) | ~pending

    tri_lanes = (kind_p == 2) & (kind_r == 2)
    n_r, uv_r, mat_r, t_own = checks.hit_record(ref, p0.orig, p0.dir, tri_p,
                                                f64)
    if control is None:
        n_p = checks.vec(seg.hit.N, idx)
        uv_p = torch.stack([seg.hit.uv_u[idx], seg.hit.uv_v[idx]], 1)
        mat_p = seg.hit.mat_id[idx]
        P_p = checks.vec(seg.hit.P, idx)
    else:
        n_p, uv_p, mat_p, _ = checks.hit_record(ref, p0.orig, p0.dir, tri_p,
                                                control)
        P_p = p0.orig + p0.dir * t_p.to(p0.dir.dtype)[:, None]
    rec_ok = checks.resolve_compare(n_p, uv_p, mat_p, t_p, n_r, uv_r, mat_r,
                                    t_own)
    out["resolve_bad"] = float((~rec_ok[tri_lanes]).float().mean()) \
        if tri_lanes.any() else 0.0

    # the logic: a held lane is handed a zero pdf, which ends its path
    keep = ext_ok & sh_ok & (rec_ok | (kind_r != 2))
    light_hit = kind_p == 1
    hit_l = SimpleNamespace(
        P=P_p, N=n_p, u=uv_p[:, 0], v=uv_p[:, 1],
        i=torch.where(light_hit, 0, tri_p.long()), light=light_hit,
        mat_id=torch.where(kind_p == 2, mat_r.long(),
                           torch.where(light_hit, 0, -1)))
    capped = SimpleNamespace(**vars(p0))
    capped.last_pdf_w = torch.where(held, 0.0, p0.last_pdf_w)
    new_pix = seg.pool1.pixel_index[idx]

    def logic(dt):
        o = segment_lanes(capped, hit_l, occ_p, new_pix, ref, params, cfg,
                          dt)
        o.splat = o.splat & ~held
        o.splat_rgb = pick(held, torch.zeros_like(o.splat_rgb), o.splat_rgb)
        return o
    r_out = logic(f64)
    if control is None:
        p1 = checks.gather_pool(seg.pool1, idx)
        data = seg.splat_data[:, idx]
    else:
        p1 = logic(control)
        data = torch.cat([p1.splat_rgb.T, p1.splat[None].to(control)])
    lane_ok = checks.shade_compare(r_out, p1, data, seg.pixel_ok(idx))
    out["shade_bad"] = float((~lane_ok[keep]).float().mean()) \
        if keep.any() else 1.0

    # the admission and the film, over every lane and pixel
    tried = seg.splat_data[3] > 0.5
    pixel = seg.pool0.pixel_index
    take = admitted(tried, pixel, seg.spp0, target)
    film = lambda dt: film_after(seg.film0, pixel, seg.splat_data, take, dt)
    out["splat_err"] = checks.splat_error(
        seg.film1 if control is None else film(control), film(f64))
    out["admit_bad"] = admit_bad(seg, target)
    out["ring_bad"] = ring_bad(seg, idx)
    return out
