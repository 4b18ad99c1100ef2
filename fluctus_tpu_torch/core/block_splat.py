"""Dense per-group film splat for the block-bound path pool (the reference
package's core/block_splat.py, free-running form).

The pool is partitioned into ``G`` groups of ``S`` lanes; group ``g`` owns
the ``P`` true pixels ``[g*P, g*P + len_g)``, padded to ``Pk`` in the film.
A lane only carries paths of its group's pixels, so a segment's splats
from group ``g`` land in film block ``g``. Channel-major throughout:
data ``[C, n]``, film ``[C, G*Pk]``.

``splat`` launches K4 (``csrc/block_splat.cu``) on CUDA tensors and runs
``splat_plain`` — the same lane-ordered sums, vectorized over groups — on
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernel_build as kb

K4 = kb.Kernel("block_splat", "block_splat.cu", "block_splat_launch",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)


def plan(num_pixels: int, num_tasks: int, groups: int):
    """Static geometry: (S lanes/group, P true pixels/group, Pk padded to a
    multiple of 128). P = ceil(pixels/groups), so a short or empty tail of
    groups is possible; the integrator clamps their ring length to >= 1."""
    if num_tasks % groups:
        raise ValueError(f"num_tasks {num_tasks} % groups {groups} != 0")
    if groups > num_pixels:
        raise ValueError(f"groups {groups} > {num_pixels} pixels")
    s = num_tasks // groups
    p = -(-num_pixels // groups)          # ceil
    pk = -(-p // 128) * 128
    return s, p, pk


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


def splat(local, data, film, groups: int):
    """Accumulate splat records into the padded channel-major film.

    local: [n] int32 — pixel index within the lane's group block (0..Pk),
           -1 = no splat this segment.
    data:  [C, n] f32 — rgbw channels (C <= 4), pre-masked.
    film:  [C, G*Pk] f32 padded accumulator.
    Returns the new [C, G*Pk] film."""
    if film.device.type == "cpu":
        return splat_plain(local, data, film, groups)
    kb.check_cuda("block_splat", local, data, film,
                  dtypes=(torch.int32, torch.float32, torch.float32))
    c, n = data.shape
    if c > 4 or n % groups or film.shape[1] % groups:
        raise ValueError(f"block_splat: bad shapes {tuple(data.shape)}, "
                         f"{tuple(film.shape)} for {groups} groups")
    out = torch.empty_like(film)
    K4(kb.ptr(local), kb.ptr(data), kb.ptr(film), kb.ptr(out), c, n, groups,
       n // groups, film.shape[1] // groups)
    return out
