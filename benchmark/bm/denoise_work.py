"""The least work of the job's denoise, counted from the frame's size
alone, so that the count stays the same whatever implements the filter:
an a-trous pass of 5 x 5 taps, guided by two images, over an image of
three colour channels (``reference.denoise``).

Bytes: the colour and the two guides read once (9 floats a pixel) and
the filtered colour written once (3 floats); a pass's output may stay on
chip for the next one, so the passes add no bytes.

Operations (float32, an exp counted as one): a tap's weight is shared by
its two pixels, so each pixel works out 12 of its 24 off-centre weights
a pass: three squared distances of 3-vectors (3 differences, 3 products
and 2 sums each: 24), their scaled sum (3 products, 2 sums), the exp
and the spline's factor (2): 31. It then sums its 24 off-centre taps
and the centre (3 fused multiply-adds for the colour, 6 operations, and
1 for the weight: 7 each) and divides 3 channels: 12 x 31 + 25 x 7 + 3
= 550 a pass. The blend: 3 channels x 3 operations, once."""

from .roofline import F32

BYTES_PER_PIXEL = (9 + 3) * F32
OPS_PER_PIXEL_PASS = 12 * 31 + 25 * 7 + 3
OPS_PER_PIXEL_BLEND = 9


def denoise_bytes(width: int, height: int) -> int:
    return width * height * BYTES_PER_PIXEL


def denoise_ops(width: int, height: int, iterations: int) -> int:
    return width * height * (iterations * OPS_PER_PIXEL_PASS
                             + OPS_PER_PIXEL_BLEND)
