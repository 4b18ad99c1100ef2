"""A cell on several cards, on the CPU: two gloo ranks at ``tiny.py``'s
size run the harness's rank path (the sharded wavefront, each rank's
check of its own segment, rank 0's worst of each number), and a fault
planted on rank 1 alone, or the counters' exchange left out, comes out
not correct; the control fails the cell's numbers where the program
passes; the device report refuses shared or missing cards; and the
launcher ends a run whose rank fails or hangs with no result line."""

import sys
import time

import pytest
import torch

from benchmark.bm import harness, ranks

import ranks_body
import tiny

torch.set_num_threads(1)

FAULTS = ["pixel_base_off", "state_unchanged", "half_batch", "splat_altered",
          "exchange_left_out"]
SCENARIOS = ["sound", "traced", "control"] + FAULTS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks_body.launch(2, tmp_path_factory.mktemp("ranks"), SCENARIOS,
                             timeout=600)


def limits():
    return harness.load_json(harness.BENCH, "workloads",
                             f"{ranks_body.NAME}.json")["check"]["limits"]


def test_sharded_capture_of_every_rank_passes(runs):
    res, lines, setup = runs[0]["sound"]
    assert res["correct"], lines
    assert runs[1]["sound"][0] is None          # rank 0 alone reports
    assert res["device"]["count"] == 2
    assert setup["device_ids"] == ["cpu-rank0", "cpu-rank1"]
    assert {"msamples_s", "setup_s"} <= set(res["metrics"])
    assert res["attempted"] >= 1 and res["failed"] == 0
    lim = limits()
    assert len(setup["rank_checks"]) == 2
    for nums in setup["rank_checks"]:
        assert set(nums) == set(lim)
        assert all(nums[k] <= lim[k] for k in lim)
    assert setup["window"]["count_gap"] == 0
    assert setup["window"]["lanes"] == 2 * tiny.SCALE[2]


def test_traced_sharded_run_reports_the_window(runs):
    res, lines, setup = runs[0]["traced"]
    assert res["correct"], lines
    assert res["metrics"]["mrays_s.wf"]["value"] > 0
    assert "breakdown" in res and "busy_s" in res["device"]
    assert len(setup["ranks"]) == 2


def test_control_fails_where_the_program_passes(runs):
    row = runs[0]["control"][0]
    lim = limits()
    assert len(row["ranks"]) == 2
    assert all(row["program"][k] <= lim[k] for k in row["program"])
    assert any(row["control"][k] > lim[k] for k in row["control"])
    assert runs[1]["control"] == []


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_on_one_rank_is_not_correct(runs, fault):
    res, lines, setup = runs[0][fault]
    assert not res["correct"], lines
    lim = limits()
    if fault != "exchange_left_out":
        r0, r1 = setup["rank_checks"]
        assert all(r0[k] <= lim[k] for k in lim), r0
        assert any(r1[k] is None or r1[k] > lim[k] for k in lim), r1
    else:
        assert setup["window"]["count_gap"] > 0


@pytest.mark.parametrize("ids, ok", [
    (["a", "b", "c", "d"], True),
    (["a", "b", "a", "d"], False),          # two ranks on one card
    (["a", "b", "c"], False),               # fewer cards than chips
])
def test_device_report_needs_a_card_a_rank(ids, ok):
    if ok:
        assert ranks.distinct_devices(ids, 4) == 4
    else:
        with pytest.raises(ValueError):
            ranks.distinct_devices(ids, 4)


RANK = """
import os, sys, time
rank = int(os.environ["RANK"])
mode = {mode!r}
print("rank", rank, "says", file=sys.stderr)
if rank == 1 and mode == "raises":
    raise RuntimeError("planted")
if rank == 1 and mode == "hangs":
    time.sleep(600)
if rank == 0 and mode == "raises":
    time.sleep(600)
if rank == 0:
    print('{{"correct": true}}')
"""


@pytest.mark.parametrize("mode", ["passes", "raises", "hangs"])
def test_launcher_ends_a_failed_run_without_a_result(mode):
    t0 = time.monotonic()
    code, out, err = ranks.launch(
        [sys.executable, "-c", RANK.format(mode=mode)], 2, deadline_s=20,
        t_start=time.perf_counter())
    assert time.monotonic() - t0 < 90
    if mode == "passes":
        assert code == 0 and out.strip() == '{"correct": true}'
        assert err.index("rank 1 says") < err.index("rank 0 says")
    else:
        assert code != 0 and out == "" and '"correct"' not in err
        assert ("exited with 1" if mode == "raises"
                else "still running") in err
