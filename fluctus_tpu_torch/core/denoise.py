"""Denoiser (the reference package's core/denoise.py, its stand-in for the
original renderer's OptiX AI denoiser, src/denoiser/OptixDenoiser.cpp): an
edge-aware a-trous wavelet filter (Dammertz et al. 2010) over the HDR
film, guided by the auxiliary feature buffers the original renderer feeds
OptiX (first-hit albedo and camera-space normal, wf_logic.cl:214-237),
with the same blend control (DenoiserOptix::setBlend).

Plain tensor code on the film's device: the reference's is jnp code that
reaches no Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

from typing import Optional

import torch

# 5-tap B3-spline kernel of the a-trous wavelet (dyadic: the products of
# two taps are exact in float32)
_B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def _shift2d(img, dy, dx):
    """2D shift of an [H, W, C] image that wraps at the edges (torch.roll,
    as the reference's jnp.roll)."""
    return torch.roll(img, shifts=(dy, dx), dims=(0, 1))


def atrous_denoise(color: torch.Tensor, albedo: Optional[torch.Tensor] = None,
                   normal: Optional[torch.Tensor] = None, iterations: int = 2,
                   sigma_color: float = 4.0, sigma_albedo: float = 0.2,
                   sigma_normal: float = 0.3, blend: float = 1.0):
    """color: [H, W, 3] HDR radiance (albedo, normal: [H, W, 3] guides, or
    None). Returns the denoised [H, W, 3] on color's device.

    Each iteration (step 1, 2, 4, ...) weighs the 5x5 taps by the B3
    spline and by exp(-|difference|^2 / sigma^2) of the colour and of each
    guide. blend: 0 = the input, 1 = fully denoised (the reference's
    denoiser blend, read as strength)."""
    out = color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out[..., :1])
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                nb = _shift2d(out, dy, dx)
                wt = torch.full_like(wacc, _B3[ky] * _B3[kx])
                dc = torch.sum((nb - out) ** 2, dim=-1, keepdim=True)
                wt = wt * torch.exp(-dc / (sigma_color * sigma_color))
                if albedo is not None:
                    da = torch.sum((_shift2d(albedo, dy, dx) - albedo) ** 2,
                                   dim=-1, keepdim=True)
                    wt = wt * torch.exp(-da / (sigma_albedo * sigma_albedo))
                if normal is not None:
                    dn = torch.sum((_shift2d(normal, dy, dx) - normal) ** 2,
                                   dim=-1, keepdim=True)
                    wt = wt * torch.exp(-dn / (sigma_normal * sigma_normal))
                acc = acc + nb * wt
                wacc = wacc + wt
        out = acc / torch.clamp_min(wacc, 1e-8)
    return color * (1.0 - blend) + out * blend
