"""Every cell's files are found by name from ``BENCHMARK.json``, and the
file keeps the contract's shape."""

import json
import os
import re

import pytest

from conftest import ROOT

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.find_cell(BENCH, cell)
    assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    config = harness.load_json("configs", w["config"] + ".json")
    traffic = harness.load_json("traffic", w["traffic"] + ".json")
    assert os.path.exists(os.path.join(harness.HERE, "loads",
                                       traffic["kind"] + ".py"))
    limits = harness.load_json("limits", cell + ".json")
    assert limits and all(v >= 0 for v in limits.values())
    harness.radar_config(config["radar"])
    for trace in (False, True):
        for m in harness.cell_metrics(BENCH, cell, trace):
            if trace:
                assert hasattr(harness.load_module("metrics", m["name"]),
                               "read")


def test_names_units_and_metrics():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "trials_per_s", "frames_per_s",
                        "frame_ms_p95"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:
        got = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


def test_config_files_rebuild_the_ports_configs():
    from radar_tpu_torch.config.params import full_config

    want = {"exact16": full_config()}
    for c in BENCH["configs"]:
        conf = harness.load_json("configs", c["name"] + ".json")
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert conf["reduced"] == c["reduced"] == []
        assert harness.radar_config(conf["radar"]) == want[c["name"]]


def test_traffic_files_are_data():
    for w in BENCH["workloads"]:
        path = os.path.join(harness.HERE, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            json.load(f)
