"""Fixtures of the benchmark's own CPU tests: the benchmark file with every
configuration cut to a size a CPU test holds (the shapes kept: a protein
ball in water, an orthorhombic box and a dodecahedron)."""

from __future__ import annotations

import copy
import json
import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "apoa1_92k": {"name": "apoa1_92k", "atoms": 3000,
                  "box": {"shape": "orthorhombic", "sides_nm": [3.2, 3.2, 3.0]},
                  "composition": {"protein_atoms": 300, "waters": 896,
                                  "ions": [["NA", 6], ["CL", 6]]},
                  "structure_seed": 0, "trajectory": {"frames": 12, "sigma_nm": 0.02,
                                 "protein_rms_nm": 0.05, "xtc_precision": 1000}},
    "rnase_dodec": {"name": "rnase_dodec", "atoms": 3000,
                    "box": {"shape": "dodecahedron", "image_distance_nm": 3.49},
                    "composition": {"protein_atoms": 200, "waters": 930,
                                    "ions": [["CL", 10]]},
                    "structure_seed": 0, "trajectory": {"frames": 12, "sigma_nm": 0.02,
                                  "protein_rms_nm": 0.05, "xtc_precision": 1000}},
}

#: The stream's traffic in the orthorhombic box (the ghost route's kernels),
#: which BENCHMARK.json has no cell of (PERF.md's open questions), added here
#: so that the fit + within driver is tested on both routes.
ORTHORHOMBIC = {"name": "apoa1_92k.align_within", "config": "apoa1_92k",
                "traffic": "align_within", "chips": 1, "why": "test"}


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
    from portbench.harness import spec

    return _with_orthorhombic(copy.deepcopy(spec.load_benchmark()))


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    from portbench.harness import spec

    bench = copy.deepcopy(spec.load_benchmark())
    tmp = tmp_path_factory.mktemp("configs")
    for c in bench["configs"]:
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(TINY[c["name"]]))
        c["file"] = str(path)
    return _with_orthorhombic(bench)


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
