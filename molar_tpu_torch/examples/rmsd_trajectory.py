"""Per-frame RMSD of a selection after the mass-weighted fit.

The window shape of the reference's RMSD example: frames stream into (B, R,
3) windows of the selection's rows, and one window function fits every
frame of a window on the card (``ops.measure.fit_rmsd``). Run:

    python -m molar_tpu_torch.examples.rmsd_trajectory -f structure.pdb traj.xtc --sel protein
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from molar_tpu_torch.ops import measure
from molar_tpu_torch.tasks.trajectory import WindowAnalysisTask


class WindowRmsd(WindowAnalysisTask):
    task_name = "windowed RMSD"

    def add_args(self, parser) -> None:
        parser.add_argument("--sel", default="protein")

    def build(self, system):
        sel = system(self.args.sel)
        self.subset = sel.indices
        ref = torch.from_numpy(sel.coords).to(self.device)
        masses = torch.from_numpy(sel.masses).to(self.device)
        self.frames, self.rmsd = [], []

        def window_fn(coords, boxes, invs):
            return measure.fit_rmsd(coords, ref, masses)[0]

        return window_fn

    def accumulate(self, frame_ids, results) -> None:
        self.frames.append(np.asarray(frame_ids))
        self.rmsd.append(results.cpu().numpy())


def main(argv=None) -> int:
    task = WindowRmsd()
    task.run(argv)
    for f, r in zip(np.concatenate(task.frames), np.concatenate(task.rmsd)):
        print(f"{f}\t{r:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
