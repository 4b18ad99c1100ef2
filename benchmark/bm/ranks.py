"""A cell on N > 1 cards: one process a card, each a rank of one
``torch.distributed`` group, as a user's ``torchrun`` script runs the
port's multi-card path (``parallel/distributed.py``).

``launch`` starts the N ranks of the benchmark's own command and waits
for them. Each rank's standard output and error go to files; only when
every rank has exited with 0 does it hand them back: the other ranks'
errors first, then rank 0's, and rank 0's standard output, whose last
line is the result. A rank that exits with another code, or ranks still
running at the deadline, end the run: the launcher kills every rank and
hands back the reason and the end of what each wrote on standard error,
and no standard output.

``distinct_devices`` decides the device report: the number of distinct
cards that did work, and a run that used fewer than its cell's chips, or
two ranks on one card, fails."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import tempfile
import time

RANK_ENV = "BM_T_START"     # set in each rank: the launcher's start time
TAIL = 4000                 # characters kept of a failed rank's stderr


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, t_start: float) -> dict:
    """A rank's environment: torchrun's variables for ``env://`` and
    ``FLT_MULTIHOST=1`` (``parallel.distributed.init_distributed``)."""
    env = dict(os.environ)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), FLT_MULTIHOST="1",
               **{RANK_ENV: repr(t_start)})
    return env


def _kill(procs):
    """SIGTERM to each rank's process group (the rank and whatever it
    started), then, after a grace, SIGKILL to what is left of them; waits
    for every rank."""
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 30.0)):
        for p in procs:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:      # the group has ended
                pass
        end = time.monotonic() + grace
        while any(p.poll() is None for p in procs) and \
                time.monotonic() < end:
            time.sleep(0.05)


def _read(path):
    with open(path, errors="replace") as f:
        return f.read()


def launch(cmd, world: int, deadline_s: float, t_start: float,
           poll_s: float = 0.2):
    """Run ``cmd`` as ranks 0..world-1 and wait for them (see the module's
    docstring). Returns (code, standard output, standard error): code 0,
    or 1 where a rank failed or the deadline passed."""
    port = free_port()
    procs, files = [], []
    old = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    with tempfile.TemporaryDirectory(prefix="bm_ranks_") as tmp:
        try:
            signal.signal(signal.SIGTERM, on_term)
            for k in range(world):
                o = os.path.join(tmp, f"rank{k}.out")
                e = os.path.join(tmp, f"rank{k}.err")
                files.append((o, e))
                with open(o, "w") as fo, open(e, "w") as fe:
                    procs.append(subprocess.Popen(
                        cmd, stdout=fo, stderr=fe, stdin=subprocess.DEVNULL,
                        env=rank_env(k, world, port, t_start),
                        start_new_session=True))
            deadline = time.monotonic() + deadline_s
            reason = None
            while reason is None:
                codes = [p.poll() for p in procs]
                bad = [(k, c) for k, c in enumerate(codes)
                       if c not in (None, 0)]
                if bad:
                    reason = "rank(s) " + ", ".join(
                        f"{k} exited with {c}" for k, c in bad)
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    late = [k for k, c in enumerate(codes) if c is None]
                    reason = (f"rank(s) {late} still running after "
                              f"{deadline_s:.0f} s")
                else:
                    time.sleep(poll_s)
        finally:
            _kill(procs)
            signal.signal(signal.SIGTERM, old)
        if reason is not None:
            err = "".join(f"--- rank {k} stderr (end) ---\n"
                          f"{_read(e)[-TAIL:]}\n"
                          for k, (_, e) in enumerate(files))
            return 1, "", err + f"the run failed: {reason}; no result\n"
        err = "".join(_read(files[k][1])
                      for k in list(range(1, world)) + [0])
        return 0, _read(files[0][0]), err


def device_id(device) -> str:
    """The card's UUID; on the CPU (the tests' gloo ranks) the rank's own
    name."""
    import torch
    import torch.distributed as dist
    if device.type != "cuda":
        return f"cpu-rank{dist.get_rank()}"
    return str(torch.cuda.get_device_properties(device).uuid)


def distinct_devices(ids, chips: int) -> int:
    """The number of distinct cards among the ranks' ``ids``; raises
    ValueError where two ranks share a card or fewer than ``chips``
    cards did work."""
    seen = {}
    for k, i in enumerate(ids):
        if i in seen:
            raise ValueError(f"ranks {seen[i]} and {k} ran on one card "
                             f"({i})")
        seen[i] = k
    if len(seen) < chips:
        raise ValueError(f"{len(seen)} distinct card(s) did work; the cell "
                         f"needs {chips}")
    return len(seen)


def gather(obj):
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, obj)
    return parts
