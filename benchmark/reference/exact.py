"""One captured segment of the exact-spp job (``render_single``: the
wavefront under fluctus's CHECK_SPP cap, wf_logic.cl:76-84, with the
denoiser's guide features on), followed from the program's own pool as
``checks`` follows a free-running one, with what the cap and the
features add:

- the cap's admission: each lane reads its pixel's sample count as K8
  does (the lane's group's block of the padded count table, at the
  pixel's place in that block); a lane whose pixel has reached the job's
  target ends its path there, held idle, and splats nothing;
- K7's capped splat: each pixel admits, of the segment's splat records
  in lane order, only as many as it lacks of the target, and the film
  after the segment is the film before plus those records, summed in
  float64;
- the guide features: each live lane's first hit writes its camera-space
  shading normal, and its first non-singular hit its albedo (Kd with its
  map, raised to 2.2), one 8-channel record a lane (wf_logic.cl:214-237),
  scattered onto the feature film as K4 does.

The logic of a lane is ``lanes.segment_lanes``; the cap enters it as the
termination it forces (the lane is given a zero pdf, which ends its path
at the same step and with the same draws) and then takes the held lane's
splat record away, so that file stays as the free-running cells check
it. Roulette is off in every exact job, as fluctus turns it off there."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import checks
from .lanes import segment_lanes
from .shading import IDEAL_DIELECTRIC, dot, material_params, pick, \
    shading_normal


def pixel_spp(spp0, pixel_index, groups: int, pk: int):
    """Each lane's pixel count as K8 reads it: lane i of group g = i // S
    reads ``spp0[g * pk + pixel_index % pk]``."""
    n = pixel_index.shape[0]
    g = torch.arange(n, device=pixel_index.device) // (n // groups)
    return spp0[g * pk + pixel_index.long().remainder(pk)]


def held_lanes(seg, target: int):
    """The lanes whose pixel had reached ``target`` before the segment."""
    spp0 = seg.spp0
    return pixel_spp(spp0, seg.pool0.pixel_index, seg.groups, seg.pk) \
        >= target


def lane_ranks(key):
    """Each entry's rank among the entries of equal ``key`` before it."""
    n = key.shape[0]
    skey, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=key.device)
    new = torch.ones(n, dtype=torch.bool, device=key.device)
    new[1:] = skey[1:] != skey[:-1]
    start = torch.cummax(torch.where(new, pos, 0), 0).values
    return torch.empty_like(pos).scatter_(0, order, pos - start)


def capped_splat(film0, local_col, data, groups, pk, spp0, target, dtype):
    """The film after one capped segment: ``film0`` [4, P] plus, at each
    pixel, its first ``max(target - spp0, 0)`` splat records of ``data``
    [4, n] in lane order, summed in ``dtype``."""
    pix = checks.ring_pixels(local_col, groups, pk)
    take = pix >= 0
    rank = lane_ranks(torch.where(take, pix, -1))
    budget = (target - spp0.long()).clamp_min(0)
    take &= rank < budget[pix.clamp_min(0)]
    acc = film0.to(dtype).clone()
    acc.index_add_(1, pix[take], data[:, take].to(dtype))
    return acc


def _gather(pool, idx):
    p = checks.gather_pool(pool, idx)
    p.first_diffuse_hit = pool.first_diffuse_hit[idx]
    return p


def feature_records(p0, hit, out, scene, params, dt):
    """The lanes' guide-feature records [k, 8] (albedo rgb and its weight,
    camera-space normal and its weight) and their new first-diffuse
    flags, computed in ``dt`` from the lanes' pool ``p0``, hit records
    ``hit`` and segment outcome ``out``."""
    mp = material_params(scene, hit.mat_id, hit.u.to(dt), hit.v.to(dt), dt)
    n = shading_normal(scene, hit.N.to(dt), hit.i, hit.u.to(dt),
                       hit.v.to(dt), mp.map_n, dt)
    n = pick(dot(n, p0.dir.to(dt)) > 0, -n, n)
    alive = ~out.terminate
    singular = mp.type == IDEAL_DIELECTRIC
    first = p0.first_diffuse_hit
    am = alive & ~singular & ~first
    nm = alive & (p0.path_len + 1 == 1)
    cam = params.camera
    cs = torch.stack([dot(n, cam.right.to(dt)), dot(n, cam.up.to(dt)),
                      -dot(n, cam.dir.to(dt))], 1)
    zero = torch.zeros_like(cs)
    rec = torch.cat([pick(am, mp.kd, zero), am.to(dt)[:, None],
                     pick(nm, cs, zero), nm.to(dt)[:, None]], 1)
    return rec, ~out.terminate & (first | (alive & ~singular))


def exact_segment_numbers(seg, ref, cfg, k, seed, target, control=None):
    """``trace_bad``, ``resolve_bad``, ``shade_bad``, ``splat_err`` and
    ``feature_err`` of the captured exact segment ``seg`` (a
    ``capture.Segment`` with ``spp0``, the count table before the
    segment, and ``features``: the feature films before and after and the
    segment's records) on ``k`` lanes drawn from ``seed``, under the
    job's ``target``. With ``control`` the reference computed in that
    lower type takes the program's place at every stage, as in
    ``checks.segment_numbers``.

    ``feature_err`` is the larger of the share of compared lanes whose
    feature record or new first-diffuse flag differs from the
    reference's (masks exactly, values as ``shade_bad`` holds them) and
    the largest relative gap of the feature film after the segment
    against the film before plus a float64 scatter of the records."""
    dev = ref.device
    f64 = torch.float64
    n = seg.pool0.seed.shape[0]
    idx = checks.sample_lanes(n, k, seed, dev)
    p0 = _gather(seg.pool0, idx)
    params = seg.ref_params
    light = params.light
    held = held_lanes(seg, target)[idx]

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
    true_pix = seg.true_pixel(seg.pool1.pixel_index[idx])

    def logic(dt):
        o = segment_lanes(capped, hit_l, occ_p, true_pix, ref, params, cfg,
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

    splat = lambda dt: capped_splat(seg.film0, seg.splat_local,
                                    seg.splat_data, seg.groups, seg.pk,
                                    seg.spp0, target, dt)
    ref_film = splat(f64)
    out["splat_err"] = checks.splat_error(
        seg.film1 if control is None else splat(control), ref_film)

    # the guide features
    f = seg.features
    rec_r, first_r = feature_records(p0, hit_l, r_out, ref, params, f64)
    if control is None:
        rec_p = f["data"][:, idx].T
        first_p = seg.pool1.first_diffuse_hit[idx]
    else:
        rec_p, first_p = feature_records(p0, hit_l, p1, ref, params,
                                         control)
    masks = [3, 7]
    vals = [0, 1, 2, 4, 5, 6]
    f_ok = (rec_p[:, masks] > 0.5).eq(rec_r[:, masks] > 0.5).all(1)
    a, b = rec_p[:, vals].double(), rec_r[:, vals].double()
    f_ok &= ((a - b).abs() <= checks.S_RTOL * b.abs()
             + checks.S_ATOL).all(1)
    f_ok &= first_p == first_r
    lanes_bad = float((~f_ok[keep]).float().mean()) if keep.any() else 1.0
    scatter = lambda dt: checks.splat_reference(
        f["film0"], f["local"], f["data"], seg.groups, seg.pk, dt)
    film_gap = checks.splat_error(
        f["film1"] if control is None else scatter(control), scatter(f64))
    out["feature_err"] = max(lanes_bad, film_gap)
    return out


def spp_gap(weight, target: int) -> int:
    """The samples by which the job's film misses its target, summed over
    the true pixels (the film's weights, true pixel layout)."""
    return int((weight.double() - target).abs().sum())
