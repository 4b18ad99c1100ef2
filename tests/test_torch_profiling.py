"""The port's profiling.py on the CPU: with no device events the report is
empty, as the reference's off its TPU, and print_profile prints its
headers and, by span, counts and host ms with no device time."""

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


SPAN_HEADER = (f"{'count':>6} {'host ms':>10} {'device ms':>10} "
               f"{'launches':>9}  span")


def test_print_profile_header(capsys):
    """Both tables' headers: device time by op, then by span (none here)."""
    assert profiling.print_profile(work, top=5) == []
    assert capsys.readouterr().out.splitlines() == [
        f"{'ms total':>10} {'count':>6}  op", SPAN_HEADER]


def test_print_profile_spans_on_the_cpu(capsys):
    """A span's row: its count and host ms; no device time or launches
    without a CUDA device."""
    def spanned():
        for _ in range(2):
            with profiling.span("flt::test"):
                work()

    assert profiling.print_profile(spanned) == []
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == SPAN_HEADER
    count, host_ms, device_ms, launches, name = out[-1].split()
    assert (count, device_ms, launches, name) == ("2", "-", "-",
                                                  "flt::test")
    assert float(host_ms) > 0


def test_device_rows_leave_out_span_ranges():
    """On the card a span also has a device-side range in key_averages();
    the device-op rows (and the tools that sum them) leave it out, or they
    would count its operations twice."""
    from types import SimpleNamespace
    cuda = torch.autograd.DeviceType.CUDA
    row = lambda key, us, dev=cuda: SimpleNamespace(
        key=key, device_type=dev, self_device_time_total=us)
    assert profiling.is_device_op(row("void k<1>(float*)", 5.0))
    assert not profiling.is_device_op(row("flt::segment", 5.0))
    assert not profiling.is_device_op(row("void k<1>(float*)", 0.0))
    assert not profiling.is_device_op(
        row("aten::add", 5.0, torch.autograd.DeviceType.CPU))
