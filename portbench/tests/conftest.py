"""Fixtures of the benchmark's own CPU tests: the benchmark file with every
configuration cut to its tiny size (``portbench/tiny/<config>.json``, the
shapes kept: a protein ball in water, an orthorhombic box and a
dodecahedron), and the cells the tests run, read from ``BENCHMARK.json``."""

from __future__ import annotations

import copy
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402

#: The stream's traffic in the orthorhombic box (the ghost route's kernels),
#: which BENCHMARK.json has no cell of (PERF.md's open questions), added here
#: so that the fit + within driver is tested on both routes.
ORTHORHOMBIC = {"name": "apoa1_92k.align_within", "config": "apoa1_92k",
                "traffic": "align_within", "chips": 1, "why": "test"}


#: Every cell of ``BENCHMARK.json``, then the test-only orthorhombic stream:
#: the cells whose tiny runs, tiny card runs and controls the tests make.
CELLS = list(dict.fromkeys([w["name"] for w in spec.load_benchmark()["workloads"]]
                           + [ORTHORHOMBIC["name"]]))


def _with_orthorhombic(bench: dict) -> dict:
    """``bench`` with the orthorhombic stream's cell, reporting what the
    dodecahedron's stream reports."""
    if ORTHORHOMBIC["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(dict(ORTHORHOMBIC))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "rnase_dodec.align_within" in m.get("workloads", ()):
                m["workloads"] = [*m["workloads"], ORTHORHOMBIC["name"]]
    return bench


@pytest.fixture(scope="session")
def full_bench():
    """``BENCHMARK.json`` as it is, with the orthorhombic stream's cell added."""
    return _with_orthorhombic(copy.deepcopy(spec.load_benchmark()))


def tiny(bench: dict, root: pathlib.Path = spec.ROOT) -> dict:
    """A copy of ``bench`` whose configurations are their tiny sizes, found
    by name under the checkout ``root`` (this one by default). A
    configuration without one points at the file it lacks, so that only its
    own cells fail, on that name (and ``test_every_config_has_a_tiny_size``)."""
    bench = copy.deepcopy(bench)
    for c in bench["configs"]:
        c["file"] = str(spec.tiny_file(c["name"], root))
    return bench


@pytest.fixture(scope="session")
def tiny_bench():
    return _with_orthorhombic(tiny(spec.load_benchmark()))


def run_cell(bench, cell: str, seed: int = 2**31 + 17, seconds: float = 1.0):
    """One tiny run of ``cell`` on the CPU -> the printed result (dict)."""
    import contextlib
    import io

    from portbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], card_check=False, bench=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
