#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``molar_tpu_torch``, the PyTorch and
CUDA port, on one machine with its cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A new process a run: it makes the cell's inputs from ``--seed``, builds the
program and warms up every shape the cell uses (``setup_s``, from the start
of the process), measures for ``--seconds``, and then, with the program's
state freed, compares what the timed window produced with the plain
reference. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared and its limit);
the same numbers are the last lines of standard error. With ``--trace 0``
the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read under ``torch.profiler``.

It exits non-zero and prints no result without enough CUDA cards, outside
a checkout that holds the program, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that must not be loaded (compared whole: the port's
#: own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "molar_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def _card(torch) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or f"{torch.cuda.get_device_name(0)}, power.limit not read"


@contextlib.contextmanager
def _workdir():
    """Where the run's trajectories go: under the ``TMPDIR`` it is given."""
    path = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def main(argv=None, *, card_check: bool = True, bench: dict | None = None) -> int:
    """Run one cell; ``card_check=False`` (the CPU tests) drives the same run
    on the CPU; ``bench`` replaces ``BENCHMARK.json``."""
    args = _parse(argv)
    _caches()
    from portbench.harness import spec
    from portbench.harness.trace import Trace

    bench = bench if bench is not None else spec.load_benchmark()
    cell = spec.cell(bench, args.workload)

    import torch

    if card_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    cuda = device.type == "cuda"
    config = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    drivers = spec.driver(traffic["driver"])
    e2e = spec.metrics_of(bench, "end_to_end", cell["name"])
    per_layer = spec.metrics_of(bench, "per_layer", cell["name"])

    with _workdir() as workdir:
        drv = drivers.Driver(config, traffic, args.seed, device, workdir)
        drv.setup()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        with Trace(bool(args.trace) and cuda) as tr:
            with tr.window():
                win = drv.window(args.seconds, traced=bool(args.trace))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        metrics, notes = {}, list(win.notes)
        if args.trace:
            run = drv.layer_run()
            run.busy_s, run.traced_s = tr.busy_s, tr.window_s
            run.card = _card(torch) if cuda else "cpu"
            for m in per_layer:
                value = spec.reader(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            notes += run.notes
            del run
        else:
            values = {**win.e2e, "setup_s": setup_s}
            for m in e2e:
                value = values[spec.quantity(m["name"])]
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check()

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(win.attempted),
        "failed": int(win.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if args.trace and cuda:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr.device_ops],
                               "idle_gaps": [[k, v] for k, v in tr.idle_gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for line in notes:
        print(f"portbench: {line}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
