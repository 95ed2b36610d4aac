"""``BENCHMARK.json`` against the benchmark's contract: every name resolves
to its file, names and units use the allowed characters, every cell
reports what it must, and every configuration has its tiny size.

The checks take the benchmark (``bench``) and the checkout it lies in
(``root``) as fixtures, so that ``test_additions.py`` holds an addition
made in another directory to the same checks."""

from __future__ import annotations

import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
LINE = re.compile(r"^[^\t\n]{1,200}$")
#: The keys each kind of entry may have.
ENTRY_KEYS = [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
]


@pytest.fixture
def bench():
    return BENCH


@pytest.fixture
def root():
    return spec.ROOT


def test_top_level_keys_and_size(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_check_budget_fits_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind,keys", ENTRY_KEYS)
def test_entry_keys_and_names(bench, kind, keys):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}
        assert spec.NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[text]), (e["name"], text)
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_resolve_and_are_used(bench, root):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        cfg = spec.config(bench, c["name"], root)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(spec.NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("config", CONFIGS)
def test_every_config_has_a_tiny_size(bench, root, config):
    """``portbench/tiny/<config>.json``: an ``about`` line first, then keys
    of the configuration's own file, under its name."""
    try:
        tiny = spec.tiny_config(config, root)
    except FileNotFoundError as e:
        pytest.fail(f"{e}: the configuration cut to a size a CPU test holds, which the "
                    "benchmark's tiny runs, fault tests and tiny card runs run")
    assert list(tiny)[0] == "about"
    assert isinstance(tiny["about"], str) and "\n" not in tiny["about"]
    assert tiny["name"] == config
    assert set(tiny) <= set(spec.config(bench, config, root)), \
        sorted(set(tiny) - set(spec.config(bench, config, root)))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(bench, cell):
    w = spec.cell(bench, cell)
    assert w["chips"] == 1 and spec.NAME.match(w["traffic"])
    traffic = spec.traffic(w["traffic"])
    assert hasattr(spec.driver(traffic["driver"]), "Driver")
    e2e = [m["name"] for m in spec.metrics_of(bench, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(bench, "per_layer", cell)
    assert layer
    for m in layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_metric_cells_exist_and_bounds(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_layers_named_in_perf_md(bench, root):
    perf = (root / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_files_under_paths_are_named_from_name_characters(root):
    for p in (root / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(root).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_traffic_files_are_data(root):
    for p in (root / "portbench" / "traffic").iterdir():
        assert p.suffix == ".json"
        json.loads(p.read_text())
