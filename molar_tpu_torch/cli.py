"""``molar-torch``: the command-line entry point of the port.

Two subcommands, counterparts of ``molar_tpu.cli``'s:

* ``info`` — the package, torch and CUDA versions, each CUDA device's name
  and compute capability, and whether ``build/molar_tpu_torch/`` holds the
  built kernels and the XTC codec. Without a CUDA device it says so and
  exits 1: the CPU is never reported as the device.
* ``trjconv`` — stream an XTC and write a selection to DCD
  (:func:`molar_tpu_torch.io.trjconv.trjconv`), the structure file read by
  ``System.from_file`` (PDB, GRO or XYZ) and the selection evaluated by
  ``System.select_indices``. Host work, as in the JAX package.

The JAX CLI's host-only subcommands (``last``, ``rearrange``, ``solvate``,
``tip3to4``, ``membrane`` on the host ``Membrane``) are not yet ported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_info(args) -> int:
    import torch

    from . import __version__, build

    print(f"molar_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("error: no CUDA device is available (the port runs on the card)",
              file=sys.stderr)
        return 1
    count = torch.cuda.device_count()
    print(f"CUDA devices: {count}")
    for i in range(count):
        major, minor = torch.cuda.get_device_capability(i)
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}, compute capability {major}.{minor}")
    for label, out, sources in (
            ("kernels", build.BUILD_DIR / "libmolar_kernels.so", build.KERNEL_SOURCES),
            ("xtc codec", build.BUILD_DIR / "libxtc_codec.so", [build.CODEC_SOURCE])):
        state = ("not built" if not out.exists()
                 else "stale" if build._stale(out, sources) else "built")
        print(f"{label}: {state} ({out})")
    return 0


def cmd_trjconv(args) -> int:
    from .core.system import System
    from .io.trjconv import trjconv

    system = System.from_file(args.structure)
    idx = (system.select_indices(args.select) if args.select
           else np.arange(system.n_atoms))
    if len(idx) == 0:
        print(f"error: selection {args.select!r} matched no atoms", file=sys.stderr)
        return 1
    n = trjconv(args.input, args.output, idx, first=args.begin, last=args.end, step=args.skip)
    print(f"wrote {n} frames x {len(idx)} atoms to {args.output}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="molar-torch", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("info", help="print versions, CUDA devices and build state")

    p = sub.add_parser("trjconv",
                       help="convert a trajectory selection (XTC -> DCD, prefix-decode fast path)")
    p.add_argument("-s", "--structure", required=True,
                   help="structure file defining the topology (PDB, GRO, XYZ)")
    p.add_argument("-f", "--input", required=True, help="input XTC")
    p.add_argument("-o", "--output", required=True, help="output DCD")
    p.add_argument("--select", default=None, help="selection expression (default: all atoms)")
    p.add_argument("-b", "--begin", type=int, default=0, help="first frame index")
    p.add_argument("-e", "--end", type=int, default=None, help="stop frame index (exclusive)")
    p.add_argument("--skip", type=int, default=1, help="frame stride")

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    return {"info": cmd_info, "trjconv": cmd_trjconv}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
