"""The command itself on a CUDA device: every cell for a short window,
with ``correct`` true and the result line last. Skips without a card
(decided inside the test, never at import)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.bm import harness


def _cells():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", _cells())
def test_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
