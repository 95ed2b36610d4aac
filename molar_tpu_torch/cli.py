"""``molar-torch``: the command-line entry point of the port.

The subcommands of ``molar_tpu.cli`` (reference: molar_bin/src/main.rs:30-100):

* ``info`` — the package, torch and CUDA versions, each CUDA device's name
  and compute capability, and whether ``build/molar_tpu_torch/`` holds the
  built kernels and the XTC codec. Without a CUDA device it says so and
  exits 1: the CPU is never reported as the device.
* ``trjconv`` — stream an XTC and write a selection to DCD
  (:func:`molar_tpu_torch.io.trjconv.trjconv`), the structure file read by
  ``System.from_file`` (any structure format) and the selection evaluated by
  ``System.select_indices``. Host work, as in the JAX package.
* ``last`` — extract the last trajectory frame (seek fast path, serial
  fallback; command_last.rs);
* ``rearrange`` — reorder atoms by selections placed at the beginning/end
  (command_rearrange.rs);
* ``solvate`` — tile a solvent box over the solute box, drop solvent
  residues outside the box or vdW-overlapping the solute
  (command_solvate.rs; default solvent $GMXDATA/top/spc216.gro);
* ``tip3to4`` — convert TIP3 waters to TIP4 by inserting the M dummy
  (command_tip3_to_tip4.rs; M at O + 0.01546 nm towards the H midpoint);
* ``membrane`` — the TOML-configured lipid membrane analysis, the host
  :class:`~molar_tpu_torch.membrane.Membrane` frame by frame.

Every subcommand but ``info`` is host work, with the JAX CLI's arguments,
messages and output files.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("molar")


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


def cmd_last(args) -> int:
    from .io import FileHandler

    files = args.files
    if len(files) == 1:
        trj = FileHandler(files[0])
        top = trj.handler.read_topology()
    else:
        try:
            top = FileHandler(files[0]).read_topology()
            trj = FileHandler(files[1])
        except Exception:
            top = FileHandler(files[1]).read_topology()
            trj = FileHandler(files[0])
    try:
        st = trj.seek_last()
        log.info("fast-forwarded to last frame")
    except Exception:
        log.info("fast-forward not possible; reading the whole trajectory")
        st = None
        for s in trj.iter_states():
            st = s
        if st is None:
            print("error: last frame can't be read", file=sys.stderr)
            return 1
    trj.close()
    with FileHandler(args.output, "w") as out:
        out.write(top, st)
    print(f"wrote last frame (t={st.time}) to {args.output}")
    return 0


def cmd_rearrange(args) -> int:
    from .core.system import System

    if not args.begin and not args.end:
        print("error: provide at least one selection", file=sys.stderr)
        return 1
    sys_ = System.from_file(args.input)
    begin_sels = [sys_.select(s) for s in args.begin]
    end_sels = [sys_.select(s) for s in args.end]
    used: set[int] = set()
    for sel in begin_sels + end_sels:
        for i in sel.indices:
            if int(i) in used:
                print(f"error: selections overlap at atom {i}", file=sys.stderr)
                return 1
            used.add(int(i))
    rest = np.array(
        [i for i in range(sys_.n_atoms) if i not in used], dtype=np.int64
    )
    order = np.concatenate(
        [s.indices for s in begin_sels]
        + [rest]
        + [s.indices for s in end_sels]
    ).astype(np.int64)
    from .io import FileHandler

    with FileHandler(args.output, "w") as fh:
        fh.write(sys_.topology, sys_.state, indices=order)
    print(f"rearranged {args.input} -> {args.output}")
    return 0


def cmd_solvate(args) -> int:
    from .core.system import System
    from .ops import neighbor_host
    from .core.pbc import PBC_FULL

    solute = System.from_file(args.input)
    if solute.box is None:
        print("error: can't solvate a system without a periodic box", file=sys.stderr)
        return 1
    solvent_file = args.solvent
    if solvent_file is None:
        gmx = os.environ.get("GMXDATA")
        if not gmx:
            print(
                "error: GMXDATA not set; use --solvent for an explicit solvent file",
                file=sys.stderr,
            )
            return 1
        solvent_file = os.path.join(gmx, "top", "spc216.gro")
    solvent = System.from_file(solvent_file)
    if solvent.box is None or solvent.box.is_triclinic:
        print("error: solvent must have an orthorhombic box", file=sys.stderr)
        return 1
    ext = solute.box.lab_extents()
    sext = solvent.box.box_extents()
    nbox = [max(int(np.ceil(ext[i] / sext[i])), 1) for i in range(3)]
    log.info("tiling solvent %s times", nbox)
    solvent.multiply_periodically(*nbox)

    # Keep only residues fully inside the solute box.
    inside_atom = solute.box.is_inside(solvent.state.coords)
    resindex = solvent.topology.resindex
    bad_res = np.unique(resindex[~inside_atom])
    keep = ~np.isin(resindex, bad_res)
    solvent.keep(np.nonzero(keep)[0])

    # Remove residues vdW-overlapping the solute (pbc full).
    combined_coords = np.concatenate([solvent.state.coords, solute.state.coords])
    n_solv = solvent.n_atoms
    vdw = np.concatenate([solvent.topology.vdw(), solute.topology.vdw()])
    max_cut = float(2 * vdw.max() + 1e-6)
    pairs, _ = neighbor_host.search_pairs(
        max_cut,
        combined_coords,
        np.arange(n_solv),
        np.arange(n_solv, len(combined_coords)),
        solute.box,
        PBC_FULL,
        vdw=vdw,
    )
    overlap_res = np.unique(solvent.topology.resindex[np.unique(pairs[:, 0])])
    log.info("%d overlapping solvent residues", len(overlap_res))
    keep = ~np.isin(solvent.topology.resindex, overlap_res)
    if keep.sum() == 0:
        print("error: no solvent left after overlap removal", file=sys.stderr)
        return 1
    solvent.keep(np.nonzero(keep)[0])

    solute.append_system(solvent)
    if args.exclude:
        solute.keep(solute.select(f"not ({args.exclude})").indices)
    solute.save(args.output)
    print(f"solvated system written to {args.output} ({solute.n_atoms} atoms)")
    return 0


def cmd_tip3to4(args) -> int:
    from .core.atom import Atom
    from .core.system import System
    from .core.state import State
    from .core.topology import Topology

    inp = System.from_file(args.input)
    water = inp.select("resname TIP3")
    w_first = int(water.indices[0])
    w_last = int(water.indices[-1])

    atoms: list[Atom] = []
    coords: list[np.ndarray] = []

    def emit(idx_range):
        for i in idx_range:
            atoms.append(inp.topology.atom(int(i)))
            coords.append(inp.state.coords[int(i)])

    emit(range(0, w_first))
    for mol in water.split_resindex():
        o, h1, h2 = mol.coords[0], mol.coords[1], mol.coords[2]
        hc = 0.5 * (h1 + h2)
        v = hc - o
        v = v / np.linalg.norm(v)
        m_pos = o + v * 0.01546
        for k, i in enumerate(mol.indices):
            a = inp.topology.atom(int(i))
            a.resname = "TIP4"
            atoms.append(a)
            coords.append(inp.state.coords[int(i)])
        m = inp.topology.atom(int(mol.indices[0]))
        m.name = "M"
        m.resname = "TIP4"
        atoms.append(m)
        coords.append(m_pos.astype(inp.state.coords.dtype))
    emit(range(w_last + 1, inp.n_atoms))

    top = Topology.from_atoms(atoms)
    top.assign_resindex()
    out = System(
        top,
        State(coords=np.asarray(coords), box=inp.box, time=inp.time),
    )
    out.save(args.output)
    print(f"converted {len(water.split_resindex())} waters; wrote {args.output}")
    return 0


def cmd_membrane(args) -> int:
    from .core.system import System
    from .membrane import Membrane, split_leaflets
    from .tasks.trajectory import FrameSpec, TrajectoryReader

    sys_ = System.from_file(args.files[0])
    memb = Membrane(sys_, open(args.params).read())
    # Leaflet auto-split when groups 'upper'/'lower' are configured.
    split_leaflets(memb)
    reader = TrajectoryReader(
        args.files[1:] or args.files,
        begin=FrameSpec.parse(args.begin),
        end=FrameSpec.parse(args.end),
        skip=args.skip,
    )
    n = 0
    for fr, st in reader.iter_states():
        sys_.set_state(st)
        memb.compute()
        n += 1
        if args.log_every and n % args.log_every == 0:
            log.info("frame %d done", fr)
    memb.finalize()
    if args.vmd:
        memb.write_vmd_visualization(args.vmd)
    print(f"membrane analysis over {n} frames -> {memb.options.output_dir}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=os.environ.get("MOLAR_LOG", "INFO"))
    parser = argparse.ArgumentParser(prog="molar-torch", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("info", help="print versions, CUDA devices and build state")

    p = sub.add_parser("last", help="extract the last trajectory frame")
    p.add_argument("-f", "--files", nargs="+", required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("rearrange", help="reorder atoms by selections")
    p.add_argument("-f", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-b", "--begin", nargs="*", default=[])
    p.add_argument("-e", "--end", nargs="*", default=[])

    p = sub.add_parser("solvate", help="solvate a system")
    p.add_argument("-f", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-s", "--solvent", default=None)
    p.add_argument("-x", "--exclude", default=None)

    p = sub.add_parser("tip3to4", help="convert TIP3 waters to TIP4")
    p.add_argument("-f", "--input", required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("trjconv",
                       help="convert a trajectory selection (XTC -> DCD, prefix-decode fast path)")
    p.add_argument("-s", "--structure", required=True,
                   help="structure file defining the topology")
    p.add_argument("-f", "--input", required=True, help="input XTC")
    p.add_argument("-o", "--output", required=True, help="output DCD")
    p.add_argument("--select", default=None, help="selection expression (default: all atoms)")
    p.add_argument("-b", "--begin", type=int, default=0, help="first frame index")
    p.add_argument("-e", "--end", type=int, default=None, help="stop frame index (exclusive)")
    p.add_argument("--skip", type=int, default=1, help="frame stride")

    p = sub.add_parser("membrane", help="lipid membrane analysis (TOML-configured)")
    p.add_argument("-f", "--files", nargs="+", required=True,
                   help="structure file then trajectory file(s)")
    p.add_argument("-p", "--params", required=True, help="TOML options file")
    p.add_argument("-b", "--begin", default=None)
    p.add_argument("-e", "--end", default=None)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--log", type=int, default=100, dest="log_every")
    p.add_argument("--vmd", default=None, help="write VMD TCL visualization")

    args = parser.parse_args(argv)
    handlers = {
        "info": cmd_info,
        "last": cmd_last,
        "rearrange": cmd_rearrange,
        "solvate": cmd_solvate,
        "tip3to4": cmd_tip3to4,
        "trjconv": cmd_trjconv,
        "membrane": cmd_membrane,
    }
    if args.command is None:
        parser.print_help()
        return 1
    return handlers[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
