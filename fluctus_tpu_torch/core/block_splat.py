"""Dense per-group film splat and per-pixel fetch for the block-bound path
pool (the reference package's core/block_splat.py).

The pool is partitioned into ``G`` groups of ``S`` lanes; group ``g`` owns
the ``P`` true pixels ``[g*P, g*P + len_g)``, padded to ``Pk`` in the film.
A lane only carries paths of its group's pixels, so a segment's splats
from group ``g`` land in film block ``g`` (the geometry and the ring are
core/pixel_ring.py's). Channel-major throughout:
data ``[C, n]``, film ``[C, G*Pk]``.

On CUDA tensors ``splat`` launches K4 (``csrc/block_splat.cu``; up to 8
channels: the film's 4, the denoiser's guide features' 8), or K7
(``csrc/block_splat_capped.cu``; up to 4) when given a per-pixel budget —
one counting sort per group, ``csrc/splat_sort.cuh``, serves both — and
``fetch`` launches K8 (``csrc/fetch.cu``). On CPU tensors each runs its
plain PyTorch version: ``splat_plain``, ``splat_capped_plain`` (the same
lane-ordered sums and counts, vectorized over groups) and ``fetch_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernel_build as kb

K4 = kb.Kernel("block_splat", "block_splat.cu", "block_splat_launch",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)
K7 = kb.Kernel("block_splat_capped", "block_splat_capped.cu",
               "block_splat_capped_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
K8 = kb.Kernel("fetch", "fetch.cu", "fetch_launch",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def splat_plain(local, data, film, groups: int):
    """Plain PyTorch K4: per group, add each lane's record to its pixel in
    lane order (a running sum from 0), then add the sums to the film."""
    K4.plain_runs += 1
    g = groups
    c, n = data.shape
    s = n // g
    pk = film.shape[1] // g
    loc = torch.where(local >= 0, local, pk).view(g, s).long()
    dat = data.view(c, g, s)
    acc = torch.zeros(c, g, pk + 1, dtype=torch.float32, device=data.device)
    gi = torch.arange(g, device=data.device)
    for lane in range(s):
        p = loc[:, lane]
        acc[:, gi, p] = acc[:, gi, p] + dat[:, :, lane]
    return film + acc[:, :, :pk].reshape(c, g * pk)


def splat_capped_plain(local, data, film, groups: int, remaining):
    """Plain PyTorch K7: K4 where each pixel admits only its first
    min(count, remaining) candidates in lane order — a candidate's rank,
    the count of earlier same-pixel lanes of its group, is compared in f32
    with the pixel's budget."""
    K7.plain_runs += 1
    g = groups
    c, n = data.shape
    s = n // g
    pk = film.shape[1] // g
    dev = data.device
    loc = torch.where(local >= 0, local, pk).view(g, s).long()
    dat = data.view(c, g, s)
    rem = torch.cat([remaining.view(g, pk),
                     torch.zeros((g, 1), dtype=torch.float32, device=dev)], 1)
    rank = torch.zeros((g, pk + 1), dtype=torch.int32, device=dev)
    acc = torch.zeros(c, g, pk + 1, dtype=torch.float32, device=dev)
    gi = torch.arange(g, device=dev)
    for lane in range(s):
        p = loc[:, lane]
        ok = rank[gi, p].to(torch.float32) < rem[gi, p]
        acc[:, gi, p] = acc[:, gi, p] + torch.where(ok, dat[:, :, lane], 0.0)
        rank[gi, p] += 1
    return film + acc[:, :, :pk].reshape(c, g * pk)


def splat(local, data, film, groups: int, remaining=None):
    """Accumulate splat records into the padded channel-major film.

    local: [n] int32 — pixel index within the lane's group block (0..Pk),
           -1 = no splat this segment.
    data:  [C, n] f32 — channels, pre-masked: rgbw (C = 4), or the
           guide features (C = 8); K4 takes C <= 8, K7 C <= 4.
    film:  [C, G*Pk] f32 padded accumulator.
    remaining: optional [1, G*Pk] f32 per-pixel budget; when given, each
           pixel admits exactly its first min(count, budget) candidates
           in lane order (K7), else every candidate (K4).
    Returns the new [C, G*Pk] film."""
    capped = remaining is not None
    if film.device.type == "cpu":
        return (splat_capped_plain(local, data, film, groups, remaining)
                if capped else splat_plain(local, data, film, groups))
    name = "block_splat_capped" if capped else "block_splat"
    tensors = (local, data, film) + ((remaining,) if capped else ())
    kb.check_cuda(name, *tensors, dtypes=(torch.int32,) + (torch.float32,)
                  * (len(tensors) - 1))
    c, n = data.shape
    if c > (4 if capped else 8) or n % groups or film.shape[1] % groups or (
            capped and remaining.shape != (1, film.shape[1])):
        raise ValueError(f"{name}: bad shapes {tuple(data.shape)}, "
                         f"{tuple(film.shape)} for {groups} groups")
    out = torch.empty_like(film)
    dims = (c, n, groups, n // groups, film.shape[1] // groups)
    if capped:
        K7(kb.ptr(local), kb.ptr(data), kb.ptr(remaining), kb.ptr(film),
           kb.ptr(out), *dims)
    else:
        K4(kb.ptr(local), kb.ptr(data), kb.ptr(film), kb.ptr(out), *dims,
           variant=c)
    return out


def fetch_plain(local, table, groups: int):
    """Plain PyTorch K8: out[i] = table[0, (i // S) * Pk + local[i]] for
    0 <= local[i] < Pk, else 0."""
    K8.plain_runs += 1
    n = local.shape[0]
    s = n // groups
    pk = table.shape[1] // groups
    lane = torch.arange(n, dtype=torch.int64, device=local.device)
    ok = (local >= 0) & (local < pk)
    pid = (lane // s) * pk + torch.where(ok, local, 0)
    return torch.where(ok, table[0, pid], 0.0)


def fetch(local, table, groups: int):
    """Per-lane read of a padded per-pixel f32 row (see ``fetch_plain``).
    local: [n] int32 in-block pixel index; table: [1, G*Pk] f32.
    Returns [n] f32."""
    if table.device.type == "cpu":
        return fetch_plain(local, table, groups)
    kb.check_cuda("fetch", local, table, dtypes=(torch.int32, torch.float32))
    n = local.shape[0]
    if n % groups or table.shape[0] != 1 or table.shape[1] % groups:
        raise ValueError(f"fetch: bad shapes {n}, {tuple(table.shape)} for "
                         f"{groups} groups")
    out = torch.empty(n, dtype=torch.float32, device=table.device)
    K8(kb.ptr(local), kb.ptr(table), kb.ptr(out), n, n // groups,
       table.shape[1] // groups)
    return out
