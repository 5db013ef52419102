"""Every configuration, traffic mix and metric of BENCHMARK.json is found
by name, and the file keeps the benchmark's contract."""
import json
import os
import re

import pytest

from bench_port import core

BENCH = core.load_json(core.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][1] == "bench_port/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"bench_port/configs/{cfg['name']}.json"
    data = core.load_json(core.ROOT, cfg["file"])
    assert len(data["source"]) <= 200
    assert set(cfg["reduced"]) == set(data["reduced"])
    assert not set(cfg["reduced"]) & set(data["assumed"])
    core.program_config(data["runtime"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_loads_by_name(cell):
    spec = core.cell_spec(cell["name"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    wl = spec.workload
    for kind in (f"traffic/{wl['traffic']['kind']}.py", f"entries/{wl['entry']['kind']}.py"):
        assert os.path.exists(os.path.join(core.HERE, kind))
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    assert set(wl["check"]["limits"]) >= {"beats_moved_pct", "bpm_mae", "answers_failed"}
    assert os.path.exists(os.path.join(core.HERE, "reference", "answers",
                                       f"{wl['traffic']['pool']}.npz"))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric["name"] != "setup_s":
        assert callable(core.reader(metric["name"]))
    if "layer" in metric:
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert metric["source"] in ("host_clock", "device_trace") and 0 < metric["bound"] <= 0.25
