"""BENCHMARK.json against the benchmark's contract: names, units, the
files each entry points to, and which cells report which metrics."""

import json
import re

import pytest

from benchmark.harness import spec

SPEC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in SPEC["configs"]]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [w["traffic"] for w in SPEC["workloads"]]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = ({"name", "unit", "better", "bound", "source", "workloads"}
               if metric in SPEC["end_to_end"] else
               {"name", "unit", "better", "source", "layer", "moves",
                "workloads"})
    assert set(metric) <= allowed


def test_names_are_unique():
    for group in (METRICS, SPEC["configs"], SPEC["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_each_cell_reports(metric):
    for cell in metric["workloads"]:
        reported = [m["name"] for m in spec.load_cell(cell).end_to_end]
        assert metric["moves"] in reported, (cell, metric["moves"])


@pytest.mark.parametrize("workload", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(workload):
    cell = spec.load_cell(workload["name"])
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert workload["chips"] in (1, 4)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.load_reader(metric["name"]))


@pytest.mark.parametrize("workload", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_compared_number_has_a_limit(workload):
    cell = spec.load_cell(workload["name"])
    assert cell.traffic["limits"]
    assert all(v >= 0 for v in cell.traffic["limits"].values())


def test_configuration_files_lie_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(SPEC["paths"][0] + "/")
        assert json.loads((spec.ROOT / f).read_text())["name"] in [
            c["name"] for c in SPEC["configs"]]
