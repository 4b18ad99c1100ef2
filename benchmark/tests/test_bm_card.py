"""The command itself on a CUDA device: every cell for a short window,
with ``correct`` true and the result line last; a cell on several cards
reports each of them, and fails with no result where fewer cards are
visible. Skips without a card, or without as many cards as a cell needs
(decided inside the test, never at import)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.bm import harness


def _cells():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return {w["name"]: w["chips"] for w in json.load(f)["workloads"]}


def _run(name, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
        env=env)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(_cells()))
def test_cell_runs_on_the_card(name):
    import torch
    chips = _cells()[name]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    out = _run(name)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips


@pytest.mark.card
def test_cell_with_too_few_cards_fails_without_a_result():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name = next(n for n, c in sorted(_cells().items()) if c > 1)
    out = _run(name, env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
