"""``BENCHMARK.json`` against the rules its checker applies, and every piece it names."""

import json
import re

import pytest

from cudabench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cudabench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_names_units_and_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        keys = set(e) - {"workloads"} if section in ("end_to_end", "per_layer") else set(e)
        assert keys == ENTRY_KEYS[section]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_and_reports_enough(workload):
    cell = spec.resolve(workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    assert NAME.match(cell.config_name) and NAME.match(cell.traffic_name)
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
        assert callable(cell.layer_reader(m["name"]).read)
    assert cell.chips in (1, 4) and cell.chips == cell.traffic.get("ranks", 1)


def test_configs_and_cells_are_used_and_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("cudabench/") and (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_per_layer_workloads_name_cells_that_report_their_moves():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in cells, (m["name"], w)


def test_command_names_only_files_under_paths():
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert word.startswith("cudabench/") and (spec.ROOT / word).is_file()


def test_every_limit_is_a_number_and_each_config_has_limits():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["limits"] and all(isinstance(v, (int, float)) and v >= 0 for v in cfg["limits"].values())
