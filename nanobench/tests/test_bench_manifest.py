"""BENCHMARK.json against the files it names and the rules of its format."""

import json
import re

import pytest

from nanobench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "nanobench.run"] and len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["nanobench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_one_line_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for text in [c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [x["name"] for x in metrics]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    for name in ("setup", "unit", "work", "finish", "check", "control"):
        assert callable(getattr(c.driver, name)), name
    assert callable(getattr(c.driver, "end_to_end", None)) or c.driver.END_TO_END in {m["name"] for m in c.end_to_end}
    assert "limits" in c.traffic
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, m
        assert callable(harness.reader(m["name"]))


def test_every_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("nanobench/") and c["reduced"] == []
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] == c["name"]


def test_per_layer_metrics_name_their_cells():
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:
            assert any(cell in e.get("workloads", CELLS) and e["name"] == m["moves"] for e in BENCH["end_to_end"])
