"""The port's profiling.py on the CPU: with no device events the report is
empty, as the reference's off its TPU, and print_profile prints its
header."""

import torch

# one intra-op thread: the suite runs several test processes at once,
# and torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from fluctus_tpu import profiling as jprofiling

from fluctus_tpu_torch import profiling


def work():
    torch.ones(4096).cumsum(0).sum()


def test_no_device_ops_on_the_cpu(tmp_path):
    """A CPU function: [] in both packages; with trace_dir the port
    writes its Chrome trace there."""
    assert profiling.profile_device_ops(work) == []
    assert jprofiling.profile_device_ops(work) == []
    assert profiling.profile_device_ops(work, trace_dir=str(tmp_path)) == []
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_print_profile_header(capsys):
    assert profiling.print_profile(work, top=5) == []
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"{'ms total':>10} {'count':>6}  op"
