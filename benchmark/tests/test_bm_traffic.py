"""Each traffic kind end to end at a tiny size on the program's CPU path
(plain PyTorch kernels): set-up, window, the check against the
reference, and the result's keys; with ``--trace 1`` the per-layer
metrics that a CPU trace can give."""

import pytest
import torch

from benchmark.bm import harness

import tiny

torch.set_num_threads(1)

CELLS = ["luxball_prod.wavefront", "luxball_prod.preview"]


def run(name, tmp_path, trace=False, seed=3000000007):
    b = harness.BENCH
    return harness.run_cell(name, seed, tiny.SECONDS[name], trace,
                            device="cpu",
                            scale=tiny.SCALE, params=tiny.PARAMS,
                            cell=tiny.cell(b, name),
                            cfg=tiny.config(b, str(tmp_path / "scene")))


@pytest.mark.parametrize("name", CELLS)
def test_traffic_kind_runs_and_checks(name, tmp_path):
    res, lines, setup, found = run(name, tmp_path)
    assert res["correct"], lines
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert len(res["metrics"]) == 2
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert found == []
    assert setup["cache_hit"]


def test_traced_run_reports_host_metrics(tmp_path):
    res, lines, _, _ = run("luxball_prod.preview", tmp_path, trace=True)
    assert res["correct"], lines
    assert res["metrics"]["frame_ms.ui"]["value"] > 0
    assert "breakdown" in res and "busy_s" in res["device"]


def test_seed_salts_the_pool(tmp_path):
    from benchmark.bm.probe import salt32
    assert salt32(1) != salt32(2) and salt32(2**31 + 5) > 0
    a = run("luxball_prod.wavefront", tmp_path, seed=11)[0]
    b = run("luxball_prod.wavefront", tmp_path, seed=12)[0]
    assert a["correct"] and b["correct"]
