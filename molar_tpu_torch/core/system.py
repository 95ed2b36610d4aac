"""A minimal ``System``: a topology and one state, read from a structure
file, and selections on it.

The counterpart of the parts of ``molar_tpu.core.system.System`` that
:class:`~molar_tpu_torch.tasks.trajectory.WindowAnalysisTask` needs: GRO is
the structure file a GROMACS XTC comes with. Other formats, ``Sel`` and
system editing are not ported.
"""

from __future__ import annotations

import os

import numpy as np

from .state import State
from .topology import Topology


class System:
    def __init__(self, topology: Topology, state: State):
        if topology.n_atoms != state.n_atoms:
            raise ValueError(f"topology has {topology.n_atoms} atoms, state {state.n_atoms}")
        self.topology = topology
        self.state = state

    @staticmethod
    def from_file(path: str) -> "System":
        """Read a structure file; only GRO is ported."""
        ext = os.path.splitext(str(path))[1].lower()
        if ext != ".gro":
            raise NotImplementedError(f"only GRO structure files are ported, got {ext or path!r}")
        from ..io.gro import read_gro

        return System(*read_gro(str(path)))

    @property
    def n_atoms(self) -> int:
        return self.topology.n_atoms

    def select_indices(self, text: str) -> np.ndarray:
        """Sorted atom indices of a selection on the current state (host
        evaluator)."""
        from ..selection import SelectionExpr

        return SelectionExpr(text).apply(self.topology, self.state)
