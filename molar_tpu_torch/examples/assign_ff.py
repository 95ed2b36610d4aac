"""Chemical perception + GAFF atom types + espaloma partial charges.

    python -m molar_tpu_torch.examples.assign_ff molecule.sdf [--ff gaff2] [-o typed.sdf]

The SDF must carry bond orders (V2000). Perception and typing are host
work; the charges come from the bundled espaloma model's GNN on the card.
"""

from __future__ import annotations

import argparse
import sys

from molar_tpu_torch import System


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("molecule")
    ap.add_argument("--ff", default="gaff", choices=["gaff", "gaff2"])
    ap.add_argument("-o", "--out", default=None, help="save typed/charged copy")
    args = ap.parse_args(argv)

    system = System.from_file(args.molecule)
    info = system.perceive()  # rings + aromaticity (perception.rs)
    types = system.apply_ff(args.ff)
    charges = system.apply_charges()
    sel = system.select_all()
    print(f"{system.n_atoms} atoms, {len(info.rings)} rings, "
          f"total charge {charges.sum():+.3f}")
    for name, t, q in zip(sel.names, types, charges):
        print(f"{name:>4} {t:>4} {q:+.4f}")
    if args.out:
        system.save(args.out)
        print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
