"""Camera ray generation (src/wf_raygen.cl:23-65): jittered-AA pinhole with
the horizontal aspect fix, fov scale = tan(fov/2), and thin-lens depth of
field scaled by worldRadius * apertureSize. Like the reference, the
vertical pixel coordinate is ``pixelIdx * (1/width)`` — a fractional row
index (wf_raygen.cl:31)."""

from __future__ import annotations

import torch

from ..geom import Camera
from ..rng import rand
from ..sampling import uniform_sample_disk
from ..vec import Vec3, normalize, where as vwhere


def generate_camera_rays(pixel_idx, cam: Camera, width: int, height: int,
                         world_radius, seed):
    """pixel_idx: int32 [N]. Returns (orig Vec3, dir Vec3, seed)."""
    w1 = 1.0 / width
    h1 = 1.0 / height
    x = torch.remainder(pixel_idx, width).to(torch.float32)
    y = pixel_idx.to(torch.float32) * w1                # wf_raygen.cl:31

    u1, seed = rand(seed)
    u2, seed = rand(seed)
    x = x + u1
    y = y + u2

    ndc_x = x * w1
    ndc_y = y * h1
    scr_x = ndc_x + ndc_x - 1.0
    scr_y = ndc_y + ndc_y - 1.0
    scr_x = scr_x * (width * h1)          # aspect fix, horizontal
    scr_x = scr_x * cam.fov_scale
    scr_y = scr_y * cam.fov_scale

    orig = Vec3(cam.pos.x.expand(x.shape), cam.pos.y.expand(x.shape),
                cam.pos.z.expand(x.shape))
    target = orig + cam.right * scr_x + cam.up * scr_y + cam.dir
    d = normalize(target - orig)

    # Depth of field (wf_raygen.cl:58-65), evaluated unconditionally and
    # selected so the RNG sequence length stays fixed.
    rx, ry, seed_dof = uniform_sample_disk(seed)
    fp = orig + d * cam.focal_dist
    orig_dof = orig + (cam.right * rx + cam.up * ry) * (
        world_radius * cam.aperture_size)
    d_dof = normalize(fp - orig_dof)

    use_dof = cam.aperture_size > 0.0
    orig = vwhere(use_dof, orig_dof, orig)
    d = vwhere(use_dof, d_dof, d)
    seed = torch.where(use_dof, seed_dof, seed)
    return orig, d, seed
