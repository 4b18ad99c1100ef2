"""Counter-based per-path RNG: Bob Jenkins' ("Burtle") integer hash
(src/random.cl:7-22) plus the exponent-bit-splice uniform of the
reference package (rng.py:18-42), bit for bit.

Seeds are carried as int64 tensors holding values in [0, 2^32): torch has
no logical right shift on uint32 for every device, and every product here
stays below 2^63, so masking to 32 bits after each multiply reproduces
uint32 wrap-around exactly.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def burtle_hash(seed: torch.Tensor) -> torch.Tensor:
    """Bob Jenkins integer hash (src/random.cl:7-15); int64 in, int64 out."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    seed = seed ^ (seed >> 15)
    return seed


def rand(seed: torch.Tensor):
    """Advance seed, return (u, new_seed) with u in [0, 1): the hash's top
    23 bits spliced into the mantissa of 1.0, minus 1."""
    seed = burtle_hash(seed)
    mant = (seed >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return u, seed


def rand_n(seed: torch.Tensor, n: int):
    """Draw n sequential values; returns (list of tensors, new_seed)."""
    outs = []
    for _ in range(n):
        u, seed = rand(seed)
        outs.append(u)
    return outs, seed
