"""The share, in %, of the window's lane-segments that the capped ring
held idle: the program's counter of lanes whose pixel had reached the
job's target (``Renderer.capped_stats``, read once a job and summed by
the traffic) over the jobs' segments times the pool's lanes. None where
the program has no such counter."""


def read(s):
    w = s.window
    if not w.get("lane_segments"):
        return None
    return 100.0 * w["held_lanes"] / w["lane_segments"]
