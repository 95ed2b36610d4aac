"""Atoms within a cutoff of a target selection, per frame (PBC cell grid).

A window function over whole windows: on the card one ``cell_bins`` and
one ``within_ghost`` launch a window (``ops.neighbor.within_mask_window``),
the cell capacities sized from the structure file's frame with headroom; a
window whose overflow flag is set stops the run. An orthorhombic box. Run:

    python -m molar_tpu_torch.examples.contacts -f structure.pdb traj.xtc \\
        --target "resname LIG" --cutoff 0.5
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from molar_tpu_torch.ops import neighbor
from molar_tpu_torch.tasks.trajectory import WindowAnalysisTask


class WindowContacts(WindowAnalysisTask):
    task_name = "windowed contact counts"

    def add_args(self, parser) -> None:
        parser.add_argument("--target", required=True)
        parser.add_argument("--cutoff", type=float, default=0.5)

    def build(self, system):
        cutoff = self.args.cutoff
        box = system.state.require_box()
        tgt = system(self.args.target).indices
        dims = neighbor.grid_dims_for(box, cutoff)
        # Fixed-capacity contract: caps from the first frame with headroom;
        # the overflow flag catches a frame that outgrows them.
        cap, tcap, _ = neighbor.estimate_caps(system.state.coords, box.inv, dims, tgt,
                                              margin=1.5)
        tgt_t = torch.from_numpy(tgt).to(self.device)
        self.lines = []

        def window_fn(coords, boxes, invs):
            masks, overflow = neighbor.within_mask_window(coords, None, tgt_t, cutoff, boxes,
                                                          invs, dims, cap, tcap)
            return masks.sum(dim=1), overflow

        return window_fn

    def accumulate(self, frame_ids, results) -> None:
        count, overflow = (r.cpu().numpy() for r in results)
        if overflow.any():
            raise RuntimeError("cell capacity overflow: raise the margin and rerun")
        self.lines += [f"{f}\t{int(n)}" for f, n in zip(np.asarray(frame_ids), count)]


def main(argv=None) -> int:
    task = WindowContacts()
    task.run(argv)
    print("\n".join(task.lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
