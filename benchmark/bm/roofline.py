"""The yardstick's fixed arithmetic: the card's published peaks and the
least bytes a wavefront segment's trace phase has to move, counted from
the cell's inputs alone, so that the count stays the same whatever
implements the trace."""

PEAK_BYTES_S = 3.35e12      # NVIDIA H100 SXM HBM3, data sheet
PEAK_FP32_S = 67e12         # NVIDIA H100 SXM FP32 outside the tensor cores

F32 = 4


def trace_phase_bytes(lanes: int, triangles: int) -> int:
    """The trace phase reads each lane's extension ray (origin and
    direction, 6 floats) and shadow ray (origin, direction and length, 7
    floats) once, writes each lane's hit (distance and a 32-bit hit id)
    and occlusion flag (1 byte) once, and reads every triangle (three
    vertices, 9 floats) once."""
    return lanes * ((6 + 7) * F32 + 2 * F32 + 1) + triangles * 9 * F32


def least_seconds(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)
