"""Cells, configurations, traffic mixes and metrics are found by name, and
BENCHMARK.json keeps to the benchmark's contract."""
import json
import re

import pytest

import perfbench_tiny
from perfbench import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = cells.load(cell)
    assert c.config["name"] == c.spec["config"]
    assert c.traffic["loop"] in ("closed", "open")
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert set(c.spec["limits"]) and all(
        v > 0 for v in c.spec["limits"].values())


def test_names_units_and_keys():
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    assert set(BENCH) == top
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((perfbench_tiny.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert data["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


def test_a_missing_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")
    with pytest.raises(ValueError):
        cells.reader("../run")
