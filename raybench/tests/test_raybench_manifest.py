"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

from __future__ import annotations

import json
import re

import pytest

from raybench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = core.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_keys():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names["configs"].add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        names["workloads"].add(w["name"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])
        assert set(m["workloads"]) <= names["workloads"] if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        mine = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def test_every_moves_names_an_end_to_end_metric_of_each_listed_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in target.get("workloads", CELLS), (m["name"], cell)


def test_each_config_used_and_its_file_holds_the_source():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        body = core.read_json(core.root() / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = core.load_cell(cell)
    assert (core.PKG / "drivers" / f"{c.traffic['entry']}.py").is_file()
    assert hasattr(c.driver(), "Run")
    assert c.limits["limits"] and all(v >= 0 for v in c.limits["limits"].values())
    for m in c.metrics:
        reader = core.load_module(core.PKG / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_metric_readers_match_the_manifest():
    files = {p.stem for p in (core.PKG / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
