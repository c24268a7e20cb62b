"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import importlib
import json
import os
import re

import pytest

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    bench, spec, cfg = run.cell_files(cell)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    assert spec["config"] == entry["config"] == cfg["name"]
    assert spec["traffic"] == entry["traffic"]
    assert spec["why"] == entry["why"]
    conf = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert conf["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert conf["reduced"] == cfg["reduced"]
    assert conf["source"] == cfg["source"]
    driver = importlib.import_module(f"benchmark.traffic.{spec['driver']}")
    for fn in ("setup_inputs", "setup", "unit", "release", "truth"):
        assert callable(getattr(driver, fn))
    importlib.import_module(f"benchmark.gen.{cfg['generator']}")
    e2e, per_layer = run.metrics_of(bench, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and spec["rate"] in names and len(names) >= 2
    assert per_layer
    assert set(spec["limits"]) == {"misplaced", "uncovered_pct", "id_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves_and_reads_nothing_from_nothing(metric):
    read = run.reader(metric)
    assert read({"units": [], "trace": None}) is None


def test_every_config_is_used_and_metrics_reach_their_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e, _ = run.metrics_of(BENCH, cell)
            assert m["moves"] in {x["name"] for x in e2e}
