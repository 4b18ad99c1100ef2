"""The byte count behind ``trace_roofline.wf``, worked by hand."""

from benchmark.bm import roofline


def test_trace_phase_bytes_by_hand():
    # 4 lanes: extension ray 6 floats + shadow ray 7 floats read (52 B),
    # hit distance and id written (8 B), occlusion flag (1 B): 61 B each;
    # 2 triangles of 9 floats (36 B each)
    assert roofline.trace_phase_bytes(4, 2) == 4 * 61 + 2 * 36 == 316


def test_least_seconds_is_the_larger_bound():
    assert roofline.least_seconds(3.35e12) == 1.0
    assert roofline.least_seconds(0.0, 67e12) == 1.0
