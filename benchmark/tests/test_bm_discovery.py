"""A cell is found by its name alone: a workload file added in a copy of
the benchmark's folder is found without editing any other file, and the
command, in a directory that holds only BENCHMARK.json and the
benchmark's folder, exits with an error and prints no result."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.bm import harness


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dst)
    return dst


def test_added_workload_file_is_found(tmp_path):
    dst = _copy(tmp_path)
    cell = json.loads((dst / "benchmark" / "workloads" /
                       "luxball_prod.wavefront.json").read_text())
    cell["params"]["chunk_segments"] = 8
    (dst / "benchmark" / "workloads" / "luxball_prod.added.json").write_text(
        json.dumps(cell))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from benchmark.bm import harness as h;"
        "c = h.load_json(h.BENCH, 'workloads', 'luxball_prod.added.json');"
        "cfg = h.load_json(h.BENCH, 'configs', c['config'] + '.json');"
        "t = h.load_module('traffic', c['traffic']);"
        "print(h.BENCH, c['params']['chunk_segments'], cfg['width'],"
        " t.run.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bench, chunk, width, fn = out.stdout.split()
    assert bench == str(dst / "benchmark")
    assert (chunk, width, fn) == ("8", "1920", "run")


def test_metric_reader_is_found_by_name(tmp_path):
    dst = _copy(tmp_path)
    (dst / "benchmark" / "metrics" / "added.wf.py").write_text(
        "def read(s):\n    return 42.0\n")
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.bm import harness as h;"
            "print(h.load_module('metrics', 'added.wf').read(None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "42.0"


def test_without_the_program_the_command_fails(tmp_path):
    dst = _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "luxball_prod.wavefront", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=dst, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
