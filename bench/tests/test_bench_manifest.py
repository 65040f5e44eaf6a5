"""BENCHMARK.json against the contract's shape: names, units and cell
lists resolve to the files the harness finds them by."""

import json
import re
import subprocess
import sys

import bench_tiny  # noqa: F401  (paths)
import pytest

from benchlib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = common.manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"]
    assert M["command"] == ["python3", "bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_configs_resolve():
    for c in M["configs"]:
        assert NAME.match(c["name"])
        path = common.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        data = common.load_json(path)
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_cells_resolve():
    names = [w["name"] for w in M["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    for w in M["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert common.config_file(w["config"]).is_file()
        mix = common.load_json(common.traffic_file(w["traffic"]))
        assert (common.BENCH / "traffic" / f"{mix['kind']}.py").is_file()


def test_metrics_resolve():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (common.BENCH / "e2e" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (common.BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in cells
            assert c in moved.get("workloads", cells)
    for c in cells:
        mine = [m for m in M["end_to_end"] if c in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(c in m["workloads"] for m in M["per_layer"])


def test_layers_are_perf_md_layers():
    """Every ``layer`` is one line, named as PERF.md's list of layers
    names it."""
    perf = (common.ROOT / "PERF.md").read_text()
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_run_refuses_without_a_card(tmp_path):
    """On a machine without CUDA the command exits non-zero and prints no
    result (this sandbox's torch has no CUDA)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    cell = M["workloads"][0]["name"]
    out = subprocess.run([sys.executable, str(common.BENCH / "run.py"),
                          "--workload", cell, "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
