"""``BENCHMARK.json`` against the benchmark's contract, and every file a cell
is found by."""
import json
import os
import re

import pytest

from perfbench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e["name"]
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher") and e["source"] in SOURCES
        assert e["name"] not in names
        names.add(e["name"])
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cell = cells.cell(BENCH, w["name"])
        used.add(w["config"])
        assert w["config"] in configs and w["chips"] == 1
        mine = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in mine, (w["name"], m["name"])
    assert used == configs


def test_files_a_cell_is_found_by():
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        f = json.load(open(os.path.join(cells.ROOT, c["file"])))
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert cells.traffic(w["traffic"])["kind"]
        lim = cells.run_limits(w["name"])
        assert lim, w["name"]
        for name, v in lim.items():
            assert v["lower"] < v["limit"] < v["upper"], (w["name"], name)
    for m in BENCH["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(cells.ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"`{layer}`" in perf or layer in perf, layer


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_workload_name_is_config_dot_traffic(w):
    e = [x for x in BENCH["workloads"] if x["name"] == w][0]
    assert w == f"{e['config']}.{e['traffic']}"
