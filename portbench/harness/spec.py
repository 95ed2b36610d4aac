"""``BENCHMARK.json`` and the files it names: each configuration, traffic mix
and per-layer metric is found by its name, in a file of its own.

* ``portbench/configs/<config>.json``: the system's sizes and source;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, with
  ``"driver"`` naming the general driver ``portbench/drivers/<driver>.py``
  that generates it, runs the timed window and checks it;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run) -> float | None``.

A metric named ``<quantity>.<group>`` is ``<quantity>`` in the cells of
that group: the same value, from the same reader, under a name of its own,
so that one group's spread does not set another's bound.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

PORTBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(PORTBENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def quantity(metric: str) -> str:
    """The quantity a metric name reports: the name before its first dot."""
    return metric.split(".")[0]


def reader(metric: str):
    """The module of a per-layer metric's reader: ``metrics/<metric>.py``, or
    else its quantity's (names may hold dots, so it is loaded by path)."""
    path = PORTBENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = PORTBENCH / "metrics" / f"{quantity(metric)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, kind: str, cell_name: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those whose
    ``workloads`` list it; for an end-to-end metric without the key, every
    cell; for a per-layer one without it, every cell that reports the
    end-to-end metric it moves."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end":
            out.append(m)
        elif any(e["name"] == m["moves"] for e in metrics_of(bench, "end_to_end", cell_name)):
            out.append(m)
    return out
