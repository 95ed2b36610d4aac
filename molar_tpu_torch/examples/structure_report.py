"""Single-structure report: SASA and volume, COM, gyration, secondary
structure, surface mesh.

    python -m molar_tpu_torch.examples.structure_report protein.pdb [--obj out.obj]

The measures and SASA run on the card (``Sel``'s device); DSSP and the SES
mesh are host work.
"""

from __future__ import annotations

import argparse
import sys

from molar_tpu_torch import System
from molar_tpu_torch.ops.surface import dedupe_mesh, mesh_area, write_obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("structure")
    ap.add_argument("--sel", default="protein")
    ap.add_argument("--obj", default=None, help="write the SES mesh here")
    args = ap.parse_args(argv)

    system = System.from_file(args.structure)
    sel = system(args.sel)
    print(f"atoms: {len(sel)} / {system.n_atoms}")
    print(f"center of mass: {sel.com()}")
    print(f"radius of gyration: {sel.gyration():.4f} nm")
    sasa = sel.sasa(with_volume=True)
    print(f"SASA: {sasa.total_area():.2f} nm^2   volume: {sasa.total_volume():.2f} nm^3")
    print(f"DSSP: {sel.dssp()}")
    if args.obj:
        v, t = sel.ses_mesh(spacing=0.05)
        v, t = dedupe_mesh(v, t)
        write_obj(args.obj, v, t)
        print(f"SES mesh: {len(v)} verts, {len(t)} tris, {mesh_area(v, t):.2f} nm^2 -> {args.obj}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
