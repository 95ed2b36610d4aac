"""The reference README's tutorial, line for line, in molar_tpu_torch.

MolAR's README (reference README.md "Tutorial") builds a tip3to4
converter: read a system containing TIP3P waters, add the TIP4P dummy
particle M on the H-O-H bisector 0.01546 nm from the oxygen, and save the
result. Each step below quotes the tutorial's step with the same API calls
(the CLI ships the production version as ``molar-torch tip3to4``).

Usage: python -m molar_tpu_torch.examples.tip3to4_tutorial in.gro out.gro
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from molar_tpu_torch import SelectionError, System


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 2:
        print(__doc__)
        return 1

    # "Reading an input file": the file type is recognized by extension.
    src = System(args[0])

    # "Making selections": empty selections raise, as in the reference —
    # an all-water box simply has no non-water part to carry over.
    try:
        water = src("resname TIP3")
    except SelectionError:
        print(f"no TIP3 waters in {args[0]}; nothing to convert")
        return 1

    # "Constructing output system": start from an empty System and add the
    # non-water part unchanged.
    out = System()
    try:
        out.append(src("not resname TIP3"))
    except SelectionError:
        pass

    # "Looping over individual water molecules" via split_resindex, and
    # "Working with coordinates" for the dummy-particle geometry.
    for mol in water.split_resindex():
        o_pos = mol.coords[0]  # TIP3 is arranged O->H->H
        h1_pos = mol.coords[1]
        h2_pos = mol.coords[2]
        hc = 0.5 * (h1_pos + h2_pos)
        v = hc - o_pos
        v = v / np.linalg.norm(v)
        m_pos = o_pos + v * 0.01546
        # Atom::from(first_atom).with_name("M").with_resname("TIP4")
        m_at = dataclasses.replace(
            mol[0].atom, name="M", resname="TIP4", mass=0.0, atomic_number=0
        )
        added = out.append_atoms(
            [*mol.iter_atoms(), m_at],
            np.concatenate([mol.coords, m_pos[None]]),
        )
        # append_atoms returns the added selection, as in the reference
        added.set_same_resname("TIP4")

    # "Writing the output file": carry the periodic box over, then save.
    out.topology.assign_resindex()
    out.set_box_from(src)
    out.save(args[1])
    print(f"wrote {out.n_atoms} atoms "
          f"({len(water.split_resindex())} waters converted) to {args[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
