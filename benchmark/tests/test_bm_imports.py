"""No module that a cell's run loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``fluctus_tpu`` (compared whole: the port's
``fluctus_tpu_torch`` begins with ``fluctus_tpu``), and the reference
loads nothing of the program either."""

import json
import os
import subprocess
import sys

from benchmark.bm import harness

RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
import tiny
from benchmark.bm import harness
b = harness.BENCH
cell = tiny.cell(b, "luxball_prod.wavefront")
cfg = tiny.config(b, {scene!r})
res, lines, setup, found = harness.run_cell(
    "luxball_prod.wavefront", 3000000019, 0.05, False, device="cpu",
    scale=tiny.SCALE, params=tiny.PARAMS, cell=cell, cfg=cfg)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(found=found, tops=tops, correct=res["correct"])))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.checks, benchmark.reference.scene_ref
import benchmark.reference.lanes, benchmark.reference.intersect
import benchmark.reference.shading, benchmark.reference.scene_files
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

TESTS = os.path.dirname(os.path.abspath(__file__))


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_run_loads_no_jax(tmp_path):
    got = _run(RUN.format(root=harness.ROOT, tests=TESTS,
                          scene=str(tmp_path / "scene")))
    assert got["found"] == []
    assert not set(got["tops"]) & harness.FORBIDDEN
    assert "fluctus_tpu_torch" in got["tops"]
    assert got["correct"]


def test_reference_loads_nothing_of_the_program():
    tops = set(_run(REF.format(root=harness.ROOT)))
    assert not tops & (harness.FORBIDDEN | {"fluctus_tpu_torch"})


def test_reference_sources_name_no_program_module():
    ref = os.path.join(harness.BENCH, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(("import ", "from ")):
                            assert "fluctus" not in s and "jax" not in s, s
