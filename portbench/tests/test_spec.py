"""``BENCHMARK.json`` against the benchmark's contract: every name resolves
to its file, names and units use the allowed characters, and every cell
reports what it must."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys_and_names(kind, keys):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}
        assert spec.NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[text]), (e["name"], text)
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(spec.NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = spec.cell(BENCH, cell)
    assert w["chips"] == 1 and spec.NAME.match(w["traffic"])
    traffic = spec.traffic(w["traffic"])
    assert hasattr(spec.driver(traffic["driver"]), "Driver")
    e2e = [m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(BENCH, "per_layer", cell)
    assert layer
    for m in layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_metric_cells_exist_and_bounds():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_layers_named_in_perf_md():
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_files_under_paths_are_named_from_name_characters():
    for p in spec.PORTBENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_traffic_files_are_data():
    for p in (spec.PORTBENCH / "traffic").iterdir():
        assert p.suffix == ".json"
        json.loads(p.read_text())
