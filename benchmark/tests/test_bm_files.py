"""Every configuration and cell file parses, and BENCHMARK.json names
only what the benchmark's folder holds."""

import json
import os
import re

import pytest

from benchmark.bm import harness

BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, kind))
                  if f.endswith(".json"))


@pytest.mark.parametrize("name", names("configs"))
def test_config_parses(name):
    cfg = harness.load_json(BENCH, "configs", f"{name}.json")
    for k in ("source", "scene", "width", "height", "wfBufferSize",
              "maxPathDepth", "useEnvMap", "camera", "areaLight", "triangles", "assumed",
              "reduced"):
        assert k in cfg, k
    assert 1 <= len(cfg["source"]) <= 200 and "\n" not in cfg["source"]
    if cfg["scene"]["kind"] == "file":
        assert os.path.exists(os.path.join(BENCH, cfg["scene"]["file"]))
    if cfg.get("env_map"):
        assert os.path.exists(os.path.join(BENCH, cfg["env_map"]))


@pytest.mark.parametrize("name", names("workloads"))
def test_cell_parses(name):
    cell = harness.load_json(BENCH, "workloads", f"{name}.json")
    assert os.path.exists(os.path.join(BENCH, "configs",
                                       f"{cell['config']}.json"))
    assert os.path.exists(os.path.join(BENCH, "traffic",
                                       f"{cell['traffic']}.py"))
    assert cell["check"]["lanes"] > 0 and cell["check"]["limits"]
    assert 1 <= len(cell["why"]) <= 200


def test_benchmark_json_matches_the_folder():
    b = bench()
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert sorted(cells) == names("workloads")
    for w in b["workloads"]:
        cell = harness.load_json(BENCH, "workloads", f"{w['name']}.json")
        assert (w["config"], w["traffic"], w["why"]) == (
            cell["config"], cell["traffic"], cell["why"])
        assert w["chips"] in (1, 4)
    # four-card cells: at most a quarter of the cells, rounded down, or one
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(cells) // 4)
    for c in b["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"])
        for cell in m.get("workloads", []):
            assert cell in cells
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for cell in cells:
        e2e, layer = harness.cell_metrics(b, cell)
        assert len(e2e) >= 2 and layer
