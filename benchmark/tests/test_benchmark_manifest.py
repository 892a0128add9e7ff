"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, which cell reports which metric, the files each entry names."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import manifest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TEXT_KEYS = ("why", "layer", "source")


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for path in MAN["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
        assert not path.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_budget_at_24_cells():
    seconds = MAN["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (seconds + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + metrics(), ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in TEXT_KEYS:
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", metrics(), ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MAN["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if metric["name"].split(".")[0].endswith("_roofline") \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_s_is_in_every_cell_at_a_quarter():
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    assert setup["unit"] == "s"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_enough(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    e2e, layer = manifest.metrics_of(MAN, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_a_metric_of_each_of_its_cells(metric):
    for workload in metric.get("workloads", [w["name"]
                                             for w in MAN["workloads"]]):
        e2e, _ = manifest.metrics_of(MAN, workload)
        assert metric["moves"] in {m["name"] for m in e2e}, workload
    assert (ROOT / "benchmark" / "metrics"
            / f"{metric['name']}.py").exists()


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_every_configuration_has_a_cell_and_a_file():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for config in MAN["configs"]:
        assert config["name"] in used
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        body = json.loads((ROOT / config["file"]).read_text())
        assert body["reduced"] == config["reduced"]
        assert len(config["reduced"]) <= 16
        for key in config["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size"))


def test_four_card_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    bench = ROOT / "benchmark"
    assert (bench / "traffic" / f"{cell['traffic']}.json").exists()
    limits = json.loads((bench / "limits" / f"{cell['name']}.json")
                        .read_text())["limits"]
    assert limits and all(isinstance(v, (int, float)) and math.isfinite(v)
                          for v in limits.values())
    loaded = manifest.cell(cell["name"])
    assert loaded.chips == cell["chips"]
    assert (bench / "drivers" / f"{loaded.traffic['driver']}.py").exists()
