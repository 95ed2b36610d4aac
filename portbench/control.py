#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed in TF32
(float32 with its matrix products on the tensor cores, one step below the
float32 with TF32 off that the port pins), put in the program's place and
judged by the cell's own comparison against the float64 reference, on the
frames a run with that seed would check. It has to come out as not
correct. The benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed on standard output: each number compared, its limit,
and whether it passes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, *, bench: dict | None = None, device=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell's comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import spec
    from portbench.run import _workdir

    bench = bench if bench is not None else spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("portbench: the control runs on a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    traffic = spec.traffic(cell["traffic"])
    drivers = spec.driver(traffic["driver"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        with _workdir() as workdir:
            drv = drivers.Driver(spec.config(bench, cell["config"]), traffic, seed, device,
                                 workdir)
            drv.inputs()
            checks = drv.control()
        correct = all(c.ok for c in checks)
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
