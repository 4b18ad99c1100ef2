"""The band imbalance of a sharded run: the busiest rank's device-busy
seconds in its traced window over the least busy rank's, each without
its NCCL kernels (the collective spins while it waits for the slowest
rank, which would even the ranks out). None on one card."""


def read(s):
    busy = getattr(s, "rank_busy", None)
    ops = getattr(s, "rank_traces", None)
    if not busy or not ops:
        return None
    work = [b - sum(v for k, v in o if "nccl" in k.lower())
            for b, o in zip(busy, ops)]
    if min(work) <= 0:
        return None
    return max(work) / min(work)
