"""K2's tile queue (fluctus_tpu_torch/csrc/trace_rol.cu) checked on the CPU,
where no CUDA kernel runs:

  (a) its plain twin ``tile_queue_plain`` is a permutation of the tiles,
      heaviest first by K1's live-candidate count, ties in tile index
      order, tiles with no live candidate last;
  (b) the queue kernel's algorithm — the count by bisection of K1's -1
      suffix, the descending exclusive scan of the counts' histogram, the
      stable scatter 32 tiles at a time by warp match — modelled step for
      step equals ``tile_queue_plain``;
  (c) K2's wrapper, which meets the tiles in the queue's order and writes
      each result at the tile's own index, gives the index-order plain walk
      ``trace_rol_plain``'s t (as bits), columns and visits, closest-hit
      and any-hit, on the luxball wavefront's recorded calls;
  (d) the queue's counters (``Renderer.trace_stats``) read zeros on the CPU.
"""

import os

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu_torch.accel import mxu_trace as tmt
from fluctus_tpu_torch.renderer import Renderer
from fluctus_tpu_torch.settings import Settings

LUXBALL = os.path.join(os.path.dirname(__file__), "..", "data", "luxball",
                       "luxball.obj")


@pytest.fixture(scope="module")
def wavefront(tmp_path_factory):
    """A luxball renderer at 128x72 with 8,192 paths on the CPU, and K2's
    two recorded calls of its third segment (bounce rays, sorted)."""
    s = Settings()
    s.camera.pos, s.camera.dir = (0.0, 1.6, 4.5), (0.0, -0.12, -1.0)
    r = Renderer(128, 72, settings=s, device="cpu",
                 data_dir=str(tmp_path_factory.mktemp("data")))
    r.load_scene(LUXBALL)
    r.init_wavefront(1 << 13)
    r.render_wavefront(2)
    calls = []
    orig = tmt.trace_rol

    def rec(*args):
        calls.append(args)
        return orig(*args)
    tmt.trace_rol = rec
    try:
        r.render_wavefront(1)
    finally:
        tmt.trace_rol = orig
    assert [bool(a[-1]) for a in calls] == [False, True]
    return r, calls


def _lists(counts, ncl_pad, seed):
    """K1-shaped candidate lists [nt, ncl_pad] with ``counts`` live slots
    each (cluster ids from a seed, then the -1 suffix)."""
    rng = np.random.default_rng(seed)
    nt = len(counts)
    order = np.full((nt, ncl_pad), -1, np.int32)
    for k, n in enumerate(counts):
        order[k, :n] = rng.permutation(ncl_pad)[:n]
    return torch.from_numpy(order)


SYNTHETIC = {
    "ties_and_empty": ([3, 0, 3, 7, 0, 1, 7, 3, 8, 8, 0, 2], 8),
    "one_tile": ([5], 8),
    "all_empty": ([0] * 40, 16),
    "all_full": ([24] * 70, 24),
    "many_warps": (list(np.random.default_rng(3).integers(0, 97, 2048)),
                   96),
}


def _cases(wavefront):
    _, calls = wavefront
    out = {k: _lists(c, n, seed=len(c)) for k, (c, n) in SYNTHETIC.items()}
    for args in calls:
        out[f"luxball any_hit={bool(args[-1])}"] = args[2]
    return out


def _check_queue(order, q):
    counts = tmt.live_counts(order)
    nt = order.shape[0]
    assert sorted(q.tolist()) == list(range(nt))            # a permutation
    c = counts[q]
    assert bool((c[:-1] >= c[1:]).all())                    # heaviest first
    same = c[:-1] == c[1:]
    assert bool((q[:-1][same] < q[1:][same]).all())         # ties by index
    empty = int((counts == 0).sum())
    if empty:
        assert bool((counts[q[nt - empty:]] == 0).all())    # empty tiles last


@pytest.mark.parametrize("case", list(SYNTHETIC) + [
    "luxball any_hit=False", "luxball any_hit=True"])
def test_queue_plain_heaviest_first(wavefront, case):
    order = _cases(wavefront)[case]
    _check_queue(order, tmt.tile_queue_plain(order))


def _queue_kernel_model(order):
    """tile_queue_kernel in numpy, step for step (one CTA; warp 0 scans and
    scatters)."""
    order = order.numpy()
    nt, ncl_pad = order.shape
    count = np.zeros(nt, np.int64)
    base = np.zeros(ncl_pad + 1, np.int64)
    for k in range(nt):                     # bisection of the -1 suffix
        lo, hi = 0, ncl_pad
        while lo < hi:
            mid = (lo + hi) >> 1
            if order[k, mid] < 0:
                hi = mid
            else:
                lo = mid + 1
        count[k] = lo
        base[lo] += 1
    run = 0                                 # the descending exclusive scan
    for top in range(ncl_pad, -1, -32):
        v = top - np.arange(32)
        x = np.where(v >= 0, base[np.maximum(v, 0)], 0)
        inc = np.cumsum(x)
        for lane in range(32):
            if v[lane] >= 0:
                base[v[lane]] = run + inc[lane] - x[lane]
        run += inc[31]
    queue = np.full(nt, -1, np.int64)
    for k0 in range(0, nt, 32):             # the stable warp scatter
        k = k0 + np.arange(32)
        v = np.where(k < nt, count[np.minimum(k, nt - 1)], -1)
        at = np.zeros(32, np.int64)
        for lane in range(32):
            if k[lane] < nt:
                below = v[:lane] == v[lane]
                at[lane] = base[v[lane]] + int(below.sum())
        for lane in range(32):
            if k[lane] < nt:
                queue[at[lane]] = k[lane]
                if not (v[:lane] == v[lane]).any():
                    base[v[lane]] += int((v == v[lane]).sum())
    return torch.from_numpy(queue)


@pytest.mark.parametrize("case", list(SYNTHETIC) + [
    "luxball any_hit=False", "luxball any_hit=True"])
def test_queue_kernel_model_matches_plain(wavefront, case):
    order = _cases(wavefront)[case]
    q = _queue_kernel_model(order)
    _check_queue(order, q)
    assert torch.equal(q, tmt.tile_queue_plain(order))


@pytest.mark.parametrize("any_hit", [False, True])
def test_wrapper_matches_index_order_walk(wavefront, any_hit):
    _, calls = wavefront
    args = calls[int(any_hit)]
    q = tmt.tile_queue_plain(args[2])
    nt = args[0].shape[0]
    assert not torch.equal(q, torch.arange(nt))     # the queue reorders
    got = tmt.trace_rol(*args)
    ref = tmt.trace_rol_plain(*args)
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])
    assert int(ref[2].sum()) > 0                      # clusters were swept


def test_trace_stats_zero_on_cpu(wavefront):
    r, _ = wavefront
    assert r.trace_stats() == tmt.TraceStats(0, 0)
    assert tmt.trace_stats("cpu") == (0, 0)
