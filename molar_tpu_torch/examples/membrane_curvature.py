"""Membrane per-lipid curvature/order analysis from a TOML options file.

    python -m molar_tpu_torch.examples.membrane_curvature -f system.gro traj.xtc \\
        --options membrane.toml

The host :class:`~molar_tpu_torch.membrane.Membrane` reads the options and
the lipids; ``MembraneDevice(membrane)`` runs the pipeline over windows of
the lipids' rows on the card and folds each window into the membrane's
groups, which ``finalize`` writes. ``--vmd out.tcl`` draws the last
frame's geometry, from the host pipeline on that frame. Options file (see
``MembraneOptions`` for the full schema):

    sel = "resname POPC"
    cutoff = 2.5
    order_type = "scdcorr"
    output_dir = "."
    groups = ["all"]

    [lipids.POPC]
    whole = "resname POPC"
    head = "name P"
    mid = "name C22"
    tails = ["C22-C23-C24-C25", "C32-C33-C34-C35"]
"""

from __future__ import annotations

import sys

from molar_tpu_torch import System
from molar_tpu_torch.membrane import Membrane, MembraneDevice, MembraneOptions
from molar_tpu_torch.tasks.trajectory import FrameSpec, TrajectoryReader, build_arg_parser
from molar_tpu_torch.workloads import MEMBRANE_WINDOW, last_frame_geometry, stream_membrane


def main(argv=None) -> int:
    parser = build_arg_parser("membrane curvature/order analysis")
    parser.add_argument("--options", required=True, help="TOML options file")
    parser.add_argument("--vmd", default=None, help="write VMD TCL visualization")
    args = parser.parse_args(argv)

    structure, *trajs = args.files
    system = System.from_file(structure)
    with open(args.options) as fh:
        opts = MembraneOptions.from_toml(fh.read())
    membrane = Membrane(system, opts)
    reader = TrajectoryReader(
        trajs or [structure],
        begin=FrameSpec.parse(args.begin),
        end=FrameSpec.parse(args.end),
        skip=args.skip,
    )
    n, _ = stream_membrane(MembraneDevice(membrane, device=system.device), reader,
                           args.window or MEMBRANE_WINDOW)
    membrane.finalize()
    if args.vmd:
        last_frame_geometry(membrane, reader)
        membrane.write_vmd_visualization(args.vmd)
    print(f"{n} frames -> {opts.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
