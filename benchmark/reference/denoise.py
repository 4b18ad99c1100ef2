"""The job's denoised frame, worked out again from the program's own
accumulations: the mean HDR image and the two guide images of the film
and feature film, the edge-aware a-trous wavelet filter of Dammertz et
al. 2010 over them, and the 8-bit frame of the result by the reference's
tonemap (``shading.tonemap``).

The filter as the program runs it, in place of fluctus's OptiX denoiser
(OptixDenoiser.cpp), which is closed and not reproduced: ``iterations``
passes with taps 1, 2, 4, ... pixels apart; each of the 5 x 5 taps is
weighed by the B3 spline's 1/16, 1/4, 3/8, 1/4, 1/16 in each axis and by
exp(-|difference|^2 / sigma^2) of the colour (the pass's input) and of
each guide (the first hit's albedo and camera-space normal), and the
pass's output is the weighted mean; ``blend`` mixes it with the input.
Departures from the paper, as the program has them:

- the guides are the first hit's albedo and normal, where the paper
  takes the normal and the position;
- each buffer keeps one sigma in every pass (colour 4.0, albedo 0.2,
  normal 0.3 in the cell);
- a tap past the image's edge wraps around to the opposite edge (the
  program's ``_shift2d`` is a roll, as the JAX package's is, whose
  docstring says it clamps).

Pixels with no sample of a guide (a sky pixel's normal) read 0, as the
program's mean over a zero weight does."""

from __future__ import annotations

import numpy as np
import torch

from .checks import frame_levels

B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)
FLOOR = 1e-3            # denoise_err: the relative gap's floor


def mean_image(channels, weight, height, width, dtype):
    """The [H, W, 3] top-first mean of three accumulated channels (bottom
    scanline first, [n] each) over their weight, in ``dtype``."""
    w = weight.to(dtype).clamp_min(1e-30)
    img = torch.stack([c.to(dtype) / w for c in channels], -1)
    return torch.flip(img.reshape(height, width, 3), (0,))


def _tap(img, dy, dx):
    return torch.roll(img, shifts=(dy, dx), dims=(0, 1))


def atrous(color, albedo, normal, iterations, sigma_color, sigma_albedo,
           sigma_normal, blend):
    """The filtered [H, W, 3] image, in the inputs' type."""
    out = color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros_like(out[..., 0])
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                nb = _tap(out, dy, dx)
                expo = ((nb - out) ** 2).sum(-1) / sigma_color ** 2
                expo = expo + ((_tap(albedo, dy, dx) - albedo) ** 2).sum(-1) \
                    / sigma_albedo ** 2
                expo = expo + ((_tap(normal, dy, dx) - normal) ** 2).sum(-1) \
                    / sigma_normal ** 2
                w = B3[ky] * B3[kx] * torch.exp(-expo)
                acc = acc + nb * w[..., None]
                wsum = wsum + w
        out = acc / wsum.clamp_min(1e-8)[..., None]
    return color * (1.0 - blend) + out * blend


def denoised(film, features, height, width, p, dtype):
    """The reference's denoised image of the program's ``film`` and
    ``features`` (true pixel layout), computed in ``dtype``; ``p`` the
    cell's denoise parameters."""
    m = lambda c, w: mean_image(c, w, height, width, dtype)
    return atrous(m(film.color, film.weight),
                  m(features.albedo, features.albedo_w),
                  m(features.normal, features.normal_w), p["iterations"],
                  p["sigma_color"], p["sigma_albedo"], p["sigma_normal"],
                  p["blend"])


def denoise_error(img, ref) -> float:
    """The largest relative gap of an image against the reference's."""
    a, b = img.double(), ref.double()
    return float(((a - b).abs() / (b.abs() + FLOOR)).max())


def levels(img, exposure, operator):
    """The 8-bit [H, W, 3] frame of a top-first [H, W, 3] image, each
    pixel one sample (weight 1), by the reference's tonemap."""
    h, w = img.shape[:2]
    flat = torch.flip(img, (0,)).reshape(h * w, 3)
    one = torch.ones(h * w, dtype=img.dtype, device=img.device)
    return frame_levels(flat.unbind(1), one, w, h, exposure, operator,
                        img.dtype)


def frame_off(levels_p: np.ndarray, levels_r: np.ndarray) -> float:
    """The share of pixels with a channel more than one 8-bit step from
    the reference's."""
    if levels_p.shape != levels_r.shape:
        return 1.0
    gap = np.abs(levels_p.astype(np.int16) - levels_r.astype(np.int16))
    return float((gap > 1).any(-1).mean())
