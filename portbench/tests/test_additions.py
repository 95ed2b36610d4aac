"""A new configuration and a new cell are added by new files and new
entries alone: no file under ``portbench/`` is edited, and no entry of
``BENCHMARK.json`` changes but the end-to-end metric's ``workloads`` list,
which gains the cell's name.

The addition is made in a copy of the checkout's benchmark in a temporary
directory: there it passes every check of ``test_spec.py``, reports what
its entries give it, and its tiny run on the CPU is correct."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil

import pytest
import torch

import test_spec
from conftest import run_cell, tiny
from portbench.harness import spec

NAME = "cube_test"
CELL = f"{NAME}.align_within"
LAYER = "decode_ms_per_frame.cube"

#: A solvated protein ball in a cube: 2,000 atoms (200 + 3 x 598 + 6).
CONFIG = {
    "name": NAME,
    "source": "https://manual.gromacs.org/current/reference-manual/algorithms/periodic-boundary-conditions.html",
    "about": "A cube of water round a protein ball, only as large as a CPU test holds.",
    "atoms": 2000,
    "box": {"shape": "orthorhombic", "sides_nm": [2.8, 2.8, 2.8]},
    "composition": {"protein_atoms": 200, "waters": 598, "ions": [["NA", 3], ["CL", 3]]},
    "precision": "float32 coordinates and arithmetic, TF32 off",
    "structure_seed": 0,
    "trajectory": {"frames": 8, "sigma_nm": 0.02, "protein_rms_nm": 0.05, "xtc_precision": 1000},
    "reduced": [],
    "assumed": ["every size: a test's"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _digest(directory) -> str:
    """One hash of every file under ``directory`` (names and bytes), the
    interpreter's bytecode caches left out."""
    h = hashlib.sha256()
    for p in sorted(directory.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(p.relative_to(directory).as_posix().encode() + b"\0" + p.read_bytes())
    return h.hexdigest()


def _add(bench: dict) -> dict:
    """``bench`` with the configuration, its cell on the existing
    ``align_within`` traffic, the cell in ``fps``'s list and a per-layer
    metric of its own."""
    new = copy.deepcopy(bench)
    new["configs"].append({"name": NAME, "source": CONFIG["source"],
                           "file": f"portbench/configs/{NAME}.json", "reduced": [],
                           "why": "a cube, orthorhombic, at a test's size"})
    new["workloads"].append({"name": CELL, "config": NAME, "traffic": "align_within",
                             "chips": 1, "why": "fit + within in a cube: the ghost kernels"})
    fps = next(m for m in new["end_to_end"] if m["name"] == "fps")
    fps["workloads"] = [*fps["workloads"], CELL]
    new["per_layer"].append({"name": LAYER, "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "io.xtc codec", "moves": "fps",
                             "workloads": [CELL]})
    return new


@pytest.fixture
def added(tmp_path):
    """The copy with the addition made: (benchmark, checkout root, the
    digest of this checkout's ``portbench/`` before)."""
    before = _digest(spec.PORTBENCH)
    shutil.copy(spec.ROOT / "PERF.md", tmp_path)
    shutil.copytree(spec.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _add(spec.load_benchmark())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (tmp_path / "portbench" / "configs" / f"{NAME}.json").write_text(json.dumps(CONFIG))
    tiny_size = {"about": f"{NAME} as it is: already a test's size",
                 **{k: CONFIG[k] for k in ("name", "atoms", "box", "composition",
                                           "structure_seed", "trajectory")}}
    spec.tiny_file(NAME, tmp_path).write_text(json.dumps(tiny_size))
    return bench, tmp_path, before


def test_the_addition_changes_no_entry_but_the_list_it_joins():
    old, new = spec.load_benchmark(), _add(spec.load_benchmark())
    for key in ("command", "paths", "run_seconds"):
        assert new[key] == old[key]
    for kind, added in (("configs", 1), ("workloads", 1), ("end_to_end", 0), ("per_layer", 1)):
        assert len(new[kind]) == len(old[kind]) + added
        assert new[kind][:len(old[kind])] == [
            {**m, "workloads": [*m["workloads"], CELL]} if m["name"] == "fps" else m
            for m in old[kind]]


def test_the_spec_checks_hold(added):
    bench, root, _ = added
    test_spec.test_top_level_keys_and_size(bench, root)
    test_spec.test_check_budget_fits_24_cells(bench)
    for kind, keys in test_spec.ENTRY_KEYS:
        test_spec.test_entry_keys_and_names(bench, kind, keys)
    test_spec.test_configs_resolve_and_are_used(bench, root)
    for c in bench["configs"]:
        test_spec.test_every_config_has_a_tiny_size(bench, root, c["name"])
    for w in bench["workloads"]:
        test_spec.test_cell_resolves(bench, w["name"])
    test_spec.test_metric_cells_exist_and_bounds(bench)
    test_spec.test_layers_named_in_perf_md(bench, root)
    test_spec.test_files_under_paths_are_named_from_name_characters(root)
    test_spec.test_traffic_files_are_data(root)


def test_the_cell_reports_what_its_entries_give_it(added):
    bench, _, _ = added
    assert [m["name"] for m in spec.metrics_of(bench, "end_to_end", CELL)] == ["fps", "setup_s"]
    assert [m["name"] for m in spec.metrics_of(bench, "per_layer", CELL)] == [LAYER]
    for w in bench["workloads"][:-1]:
        assert LAYER not in [m["name"] for m in spec.metrics_of(bench, "per_layer", w["name"])]


def test_the_tiny_run_of_the_new_cell_is_correct_and_writes_nothing_here(added):
    bench, root, before = added
    res = run_cell(tiny(bench, root), CELL)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"fps", "setup_s"}
    assert _digest(spec.PORTBENCH) == before
