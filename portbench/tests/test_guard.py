"""What the harness loads and reads: no module of JAX or of the JAX package
(top-level names compared whole), no file of ``benchmarks/``, ``bench.py``
or ``chip_smoke.py``; and no result, and a non-zero exit, without a card
or outside a checkout that holds the program."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]

_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args
                 and isinstance(args[0], str) else None)
import torch
torch.set_num_threads(1)
from conftest import TINY, _with_orthorhombic
import copy, pathlib, tempfile
from portbench.harness import spec
from portbench import control, run
bench = _with_orthorhombic(copy.deepcopy(spec.load_benchmark()))
tmp = pathlib.Path(tempfile.mkdtemp())
for c in bench["configs"]:
    p = tmp / (c["name"] + ".json"); p.write_text(json.dumps(TINY[c["name"]])); c["file"] = str(p)
for m in bench["per_layer"]:
    spec.reader(m["name"])
for cell in [w["name"] for w in bench["workloads"]]:
    assert run.main(["--workload", cell, "--seed", "7", "--seconds", "0.5"], card_check=False,
                    bench=bench) == 0
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "opened": opened}}))
"""


@pytest.fixture(scope="module")
def probe():
    code = _PROBE.format(root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_jax_package(probe):
    assert not set(probe["modules"]) & set(run.FORBIDDEN)
    assert "molar_tpu_torch" in probe["modules"]


def test_reads_nothing_of_the_old_benchmarks(probe):
    for path in probe["opened"]:
        p = os.path.abspath(path)
        assert not p.startswith(str(ROOT / "benchmarks")), p
        assert os.path.basename(p) not in ("bench.py", "chip_smoke.py"), p


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "molar_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert "molar_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "molar_tpu.fake", sys)
    assert run.forbidden_modules() == ["molar_tpu"]


def _cli(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    """Here, without a card: non-zero, nothing on standard output, and no
    fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the check needs a machine without one")
    out = _cli(["--workload", "rnase_dodec.align_within", "--seed", "1", "--seconds", "1"], ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``portbench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(["--workload", "apoa1_92k.sasa", "--seed", "1", "--seconds", "1"], tmp_path)
    assert out.returncode != 0 and out.stdout == ""
