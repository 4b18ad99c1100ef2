"""The pixel ring: which pixel each lane of the wavefront pool renders
next, and where its samples land. The only module that knows which of
the two rings runs.

The block ring (``config.block_ring``, the renderer's default) splits the
pool into G groups of S lanes. Group g renders the true pixels
[g*P, g*P + len_g) through its own ring cursor, and its splats land in
film block g (core/block_splat.py: K4, K7 under the spp cap, and K8 for
the cap's per-pixel fetch). Film, spp and guide features live in the
padded [G*Pk] layout (``pad_pixels`` / ``unpad_pixels``); a dead slot's
spp is parked at 2^29, so the cap never waits on it.

The flat ring is the reference's own (wf_raygen.cl:25): film, spp and
features in true pixel order, one global raygen cursor (a 0-d tensor)
whose ranks are an exclusive prefix count over the whole pool
(``exclusive_rank``). Terminated paths splat by a scatter-add into
``num_pixels + 1`` buckets, the last one the overflow bucket of lanes
that do not splat (``scatter_pixels``). Under the spp cap a segment reads
the spp by a gather and admits exactly each pixel's remaining budget,
ranking a pixel's splatting lanes by a stable sort (``run_ranks``).

A segment's ring (``segment_ring``) covers the film slice
``[pixel_base, pixel_base + num_pixels)``: the whole film, or one rank's
slice under ``parallel.mesh``. ``pixel_base`` counts padded pixels on the
block ring (a multiple of Pk) and true pixels on the flat one.

Both rings mark their work with the same spans (``profiling.span``,
no-ops off the profiler): ``flt::ring.fetch`` (the cap's spp read: K8,
or the gather), ``flt::ring.admit`` (the cap's admission: the remaining
budgets K7 reads, or the flat ring's ranking), ``flt::ring.scatter``
(the film, spp and feature splats: K4/K7, or the scatter-adds) and
``flt::ring.raygen`` (the raygen ranks computed in torch: the flat ring's
prefix count, or the block ring's plain raygen; on the card the block
ring's raygen runs inside csrc/surface_shade.cu).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geom import RenderConfig
from ..profiling import span
from . import block_splat as bs

DEAD_SPP = 1 << 29      # a padded dead slot's spp: past every target


def geometry(config: RenderConfig, num_tasks: int = 0):
    """The block ring's geometry: (S lanes a group, P true pixels a group,
    Pk = P padded to a multiple of 128). P = ceil(pixels / groups), so a
    short or empty tail of groups is possible; their rings are clamped to
    length >= 1. Raises on a pool of ``num_tasks`` lanes the groups do
    not divide (0, the default, asks for P and Pk alone)."""
    g = config.groups
    if num_tasks % g:
        raise ValueError(f"num_tasks {num_tasks} % groups {g} != 0")
    if g > config.num_pixels:
        raise ValueError(f"groups {g} > {config.num_pixels} pixels")
    p = -(-config.num_pixels // g)          # ceil
    return num_tasks // g, p, -(-p // 128) * 128


def choose(config: RenderConfig, num_tasks: int) -> RenderConfig:
    """The config that runs a pool of ``num_tasks`` lanes: the block ring
    when the config asks for it and its groups divide the pool, else the
    flat ring (the reference's renderer.py:436-437 and 622-623)."""
    if config.block_ring and num_tasks % config.groups:
        return config.replace(block_ring=False)
    return config


def padded_to_true_pid(config: RenderConfig, idx):
    """Padded pixel index (group g, slot k -> g*Pk + k) to the true pixel
    id (g*P + k). The identity on the flat ring."""
    if not config.block_ring:
        return idx
    _, p_true, pk = geometry(config)
    return torch.div(idx, pk, rounding_mode="floor") * p_true \
        + torch.remainder(idx, pk)


def unpad_pixels(arr, config: RenderConfig):
    """Padded per-pixel array [G*Pk(, C)] -> true layout [num_pixels(, C)].
    The identity on the flat ring."""
    if not config.block_ring:
        return arr
    _, p_true, pk = geometry(config)
    g = arr.shape[0] // pk
    tail = tuple(arr.shape[1:])
    return arr.reshape((g, pk) + tail)[:, :p_true].reshape(
        (g * p_true,) + tail)[:config.num_pixels]


def pad_pixels(arr, config: RenderConfig, fill=0):
    """True per-pixel array [num_pixels(, C)] -> padded block layout
    [G*Pk(, C)] (inverse of unpad_pixels); ``fill`` lands in dead slots.
    The identity on the flat ring."""
    if not config.block_ring:
        return arr
    _, p_true, pk = geometry(config)
    g = config.groups
    total = g * p_true
    tail = tuple(arr.shape[1:])
    if total > arr.shape[0]:
        arr = torch.cat([arr, torch.full((total - arr.shape[0],) + tail,
                                         fill, dtype=arr.dtype,
                                         device=arr.device)])
    m = arr.reshape((g, p_true) + tail)
    pad = torch.full((g, pk - p_true) + tail, fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([m, pad], dim=1).reshape((g * pk,) + tail)


def reset(config: RenderConfig, num_tasks: int, *, device):
    """The ring's part of wf_reset: (film length, spp, cursor(s)). The
    block ring (its geometry checked against the pool) parks its padded
    dead pixels' spp at 2^29 and has a cursor a group; the flat ring has
    zero spp over the true pixels and one 0-d cursor."""
    if not config.block_ring:
        npix = config.num_pixels
        return (npix, torch.zeros(npix, dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
    _, p_true, pk = geometry(config, num_tasks)
    npix = config.groups * pk
    gi = torch.arange(npix, dtype=torch.int32, device=device) // pk
    li = torch.arange(npix, dtype=torch.int32, device=device) % pk
    live = li < torch.clamp(config.num_pixels - gi * p_true, 1, p_true)
    spp0 = torch.where(live, 0, DEAD_SPP).to(torch.int32)
    return (npix, spp0,
            torch.zeros(config.groups, dtype=torch.int32, device=device))


def shard_cursors(curr_pixel, k: int, d: int):
    """Shard k of d's ring cursor(s) from a whole state's: G/D of the block
    ring's [G] group cursors, or the flat ring's one cursor started at 0
    (each shard runs its own ring over its slice)."""
    if curr_pixel.ndim == 0:
        return torch.zeros((), dtype=torch.int32, device=curr_pixel.device)
    g = curr_pixel.shape[0]
    if g % d:
        raise ValueError(f"groups ({g}) must divide the mesh size ({d})")
    m = g // d
    return curr_pixel[k * m:(k + 1) * m].contiguous()


def exclusive_rank(mask):
    """Exclusive prefix count of a bool [n] mask in int32, and its total:
    the flat ring's raygen ranks (the reference's ``exclusive_rank``
    computes the same counts by triangular matmuls, a TPU workaround)."""
    m = mask.to(torch.int32)
    incl = torch.cumsum(m, 0, dtype=torch.int32)
    return incl - m, incl[-1]


def run_ranks(key):
    """Each lane's rank among the lanes of equal ``key`` [n], in lane
    order (int64): a stable sort by key, each run's start by cummax, and
    the ranks scattered back to lane order (the reference sorts them back,
    its second ``lax.sort``, integrator_wf.py:462-470)."""
    n = key.shape[0]
    skey, slane = torch.sort(key, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=key.device)
    newrun = torch.ones(n, dtype=torch.bool, device=key.device)
    newrun[1:] = skey[1:] != skey[:-1]
    runstart = torch.cummax(torch.where(newrun, pos, 0), 0).values
    return torch.empty_like(pos).scatter_(0, slane, pos - runstart)


def scatter_pixels(seg, data, num_pixels: int):
    """The flat ring's film scatter: the rows of ``data`` [m, C] summed by
    pixel ``seg`` [m] into ``num_pixels + 1`` buckets, the last one the
    overflow bucket of lanes that do not splat; returns [num_pixels, C].
    This is the reference's own semantics for the flat ring (its
    ``segment_sum``), so it stays one ``index_add_``, not a kernel: on the
    CPU it adds in lane order, as XLA's CPU scatter does; on CUDA it adds
    by atomics in no fixed order, so float sums are not bit-reproducible
    there (whole-number weights and int32 counts are)."""
    acc = torch.zeros((num_pixels + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return acc.index_add_(0, seg, data)[:num_pixels]


class KernelRing(NamedTuple):
    """csrc/surface_shade.cu's ring arguments: the slice's groups (0 on
    the flat ring), S, Pk, P and first group; the flat ring's ranks and
    restarted count; the block ring's [2, groups] output (its cursors,
    then each group's restarted count)."""
    block: bool
    groups: int
    s: int
    pk: int
    p_true: int
    g0: int
    rank: Optional[torch.Tensor]
    n_regen: Optional[torch.Tensor]
    out: Optional[torch.Tensor]


class _Ring:
    """A segment's ring over the film slice [pixel_base, pixel_base +
    num_pixels) of ``config``'s film."""

    def __init__(self, config: RenderConfig, num_pixels: int,
                 pixel_base: int):
        self.config = config
        self.num_pixels = num_pixels
        self.pixel_base = pixel_base

    def local(self, pixel_index):
        """Each lane's pixel id within the slice (unsharded: the pixel id,
        without a device op)."""
        base = self.pixel_base
        return pixel_index - base if base else pixel_index


class _BlockRing(_Ring):
    def __init__(self, config, num_pixels, pixel_base):
        super().__init__(config, num_pixels, pixel_base)
        _, self.p_true, self.pk = geometry(config)
        self.groups = num_pixels // self.pk     # groups this slice owns

    def fetch_spp(self, lpid, spp):
        """Each lane's pixel's spp (K8)."""
        with span("flt::ring.fetch"):
            return bs.fetch(torch.remainder(lpid, self.pk).to(torch.int32),
                            spp.to(torch.float32)[None, :],
                            groups=self.groups).to(torch.int32)

    def splat(self, lpid, mask, rows, old, spp=None, cap=None,
              pix_spp=None):
        """The ``mask`` lanes' records ``rows`` (C channels of [n], masked)
        added to their pixels of ``old`` ([C, slice]): K4, or under the cap
        (``cap`` given; the film's channels, weight last) K7, which admits
        each pixel's remaining budget. Returns (new rows, new spp, the
        count splatted); the last two None without ``spp`` (the guide
        features, which keep no count)."""
        remaining = None
        if cap is not None:
            with span("flt::ring.admit"):
                remaining = torch.clamp_min(cap - spp, 0).to(
                    torch.float32)[None, :]
        with span("flt::ring.scatter"):
            data = torch.stack(rows, dim=0)
            local = torch.where(mask, torch.remainder(lpid, self.pk),
                                -1).to(torch.int32)
            new = bs.splat(local, data, old, groups=self.groups,
                           remaining=remaining)
            if cap is None:
                return new, spp, None if spp is None else mask.sum()
            # the weight deltas are whole numbers below 2^24, so rounding
            # them is exact
            delta_w = new[3] - old[3]
            return (new, spp + torch.round(delta_w).to(torch.int32),
                    torch.round(delta_w.sum()).to(torch.int32))

    def raygen(self, terminate, curr_pixel):
        """Each group's terminated lanes take its next pixels in lane
        order. Returns (each lane's new padded pixel, the cursors, the
        count restarted)."""
        n = terminate.shape[0]
        dev = terminate.device
        g, pk, p_true = self.groups, self.pk, self.p_true
        s = n // g
        with span("flt::ring.raygen"):
            lane_g = torch.arange(n, dtype=torch.int32, device=dev) // s
            term_i = terminate.to(torch.int32).view(g, s)
            rank2 = (torch.cumsum(term_i, dim=1) - term_i).to(torch.int32)
            n_term_g = term_i.sum(dim=1).to(torch.int32)
            n_regen = n_term_g.sum()
            # the slice's groups are g0.. of the whole film's
            g_row = self.pixel_base // pk + torch.arange(
                g, dtype=torch.int32, device=dev)
            len_g = torch.clamp(self.config.num_pixels - g_row * p_true, 1,
                                p_true)
            new_l = torch.remainder(curr_pixel[:, None] + rank2,
                                    len_g[:, None])
            new_pixel = (self.pixel_base + lane_g * pk
                         + new_l.reshape(n)).to(torch.int32)
            curr_out = torch.remainder(curr_pixel + n_term_g, len_g).to(
                torch.int32)
        return new_pixel, curr_out, n_regen

    def kernel_args(self, terminate) -> KernelRing:
        g = self.groups
        return KernelRing(
            True, g, terminate.shape[0] // g, self.pk, self.p_true,
            self.pixel_base // self.pk, None, None,
            torch.empty((2, g), dtype=torch.int32, device=terminate.device))

    def kernel_cursors(self, kr: KernelRing, curr_pixel):
        """(cursors, count restarted) after the kernel's raygen."""
        return kr.out[0], kr.out[1].sum()


class _FlatRing(_Ring):
    def fetch_spp(self, lpid, spp):
        """Each lane's pixel's spp by a gather. Pre-birth lanes (pixel 0
        from wf_reset) lie outside a slice that does not start at 0:
        clamped, they read a count they never use (they terminate without
        splatting)."""
        with span("flt::ring.fetch"):
            idx = (torch.clamp(lpid, 0, self.num_pixels - 1)
                   if self.pixel_base else lpid)
            return spp[idx.long()]

    def splat(self, lpid, mask, rows, old, spp=None, cap=None,
              pix_spp=None):
        """The ``mask`` lanes' records added to their pixels of ``old`` by
        one scatter (see ``_BlockRing.splat``). Under the cap each pixel
        admits exactly its remaining budget (integrator_wf.py:453-471):
        its splatting lanes ranked in lane order; a lane not admitted goes
        to the overflow bucket, with the lanes that do not splat."""
        num_pixels = self.num_pixels
        if cap is not None:
            with span("flt::ring.admit"):
                rank = run_ranks(torch.where(mask, lpid, 0x7FFFFFFF))
                mask = mask & (rank < (cap - pix_spp))
        with span("flt::ring.scatter"):
            seg = torch.where(mask, lpid, num_pixels).to(torch.int32)
            n_splatted = None if spp is None else mask.sum()
            new = old + scatter_pixels(seg, torch.stack(rows, dim=1),
                                       num_pixels).T
            if cap is not None:
                spp = torch.minimum(spp + scatter_pixels(
                    seg, mask.to(torch.int32), num_pixels), cap)
        return new, spp, n_splatted

    def raygen(self, terminate, curr_pixel):
        """The terminated lanes take the next pixels of the one ring, in
        lane order (see ``_BlockRing.raygen``)."""
        with span("flt::ring.raygen"):
            rank, n_regen = exclusive_rank(terminate)
            new_pixel = (self.pixel_base + torch.remainder(
                curr_pixel + rank, self.num_pixels)).to(torch.int32)
            curr_out = torch.remainder(curr_pixel + n_regen,
                                       self.num_pixels).to(torch.int32)
        return new_pixel, curr_out, n_regen

    def kernel_args(self, terminate) -> KernelRing:
        with span("flt::ring.raygen"):
            rank, n_regen = exclusive_rank(terminate)
        return KernelRing(False, 0, 0, 0, 0, 0, rank, n_regen, None)

    def kernel_cursors(self, kr: KernelRing, curr_pixel):
        return (torch.remainder(curr_pixel + kr.n_regen,
                                self.num_pixels).to(torch.int32),
                kr.n_regen)


def segment_ring(config: RenderConfig, num_pixels: int,
                 pixel_base: int = 0) -> _Ring:
    """The ring a segment runs over its film slice of ``num_pixels``
    (padded on the block ring) starting at ``pixel_base``."""
    ring = _BlockRing if config.block_ring else _FlatRing
    return ring(config, num_pixels, pixel_base)
