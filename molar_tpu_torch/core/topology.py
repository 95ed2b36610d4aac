"""Columnar topology: structure-of-arrays atoms and bonds.

The port's copy of ``molar_tpu.core.topology.Topology`` with the same columns
(numpy only), cut to what the selection language reads: construction from
``Atom`` rows or from plain arrays (:func:`molar_tpu_torch.convert.topology_from_numpy`),
the decoded name columns, vdW radii, residue indices and bonds (no bond
orders). String columns
are int32 codes into a :class:`~.interner.NamePool`. The editing operations
of the JAX package (subset, removal, concatenation, optional columns) are
not ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..config import NP_INDEX as INDEX
from . import periodic_table as pt
from .atom import Atom
from .interner import NamePool


class TopologyError(ValueError):
    pass


class Topology:
    """SoA atoms + bonds."""

    def __init__(self, n_atoms: int = 0):
        self.name_pool = NamePool()
        self.resname_pool = NamePool()
        self.name = np.zeros(n_atoms, INDEX)
        self.resname = np.zeros(n_atoms, INDEX)
        self.resid = np.ones(n_atoms, np.int64)
        self.resindex = np.zeros(n_atoms, INDEX)
        self.atomic_number = np.zeros(n_atoms, np.int16)
        self.mass = np.zeros(n_atoms, FLOAT)
        self.charge = np.zeros(n_atoms, FLOAT)
        self.chain = np.full(n_atoms, " ", dtype="U1")
        self.bfactor = np.zeros(n_atoms, FLOAT)
        self.occupancy = np.zeros(n_atoms, FLOAT)
        self.bonds = np.zeros((0, 2), INDEX)

    @staticmethod
    def from_atoms(atoms: Sequence[Atom]) -> "Topology":
        top = Topology(len(atoms))
        top.name = top.name_pool.intern_all([a.name for a in atoms])
        top.resname = top.resname_pool.intern_all([a.resname for a in atoms])
        top.resid = np.array([a.resid for a in atoms], np.int64)
        top.resindex = np.array([a.resindex for a in atoms], INDEX)
        top.atomic_number = np.array([a.atomic_number for a in atoms], np.int16)
        top.mass = np.array([a.mass for a in atoms], FLOAT)
        top.charge = np.array([a.charge for a in atoms], FLOAT)
        top.chain = np.array([a.chain or " " for a in atoms], dtype="U1")
        top.bfactor = np.array([a.bfactor for a in atoms], FLOAT)
        top.occupancy = np.array([a.occupancy for a in atoms], FLOAT)
        return top

    @property
    def n_atoms(self) -> int:
        return self.name.shape[0]

    def __len__(self) -> int:
        return self.n_atoms

    def names(self, indices=None) -> np.ndarray:
        codes = self.name if indices is None else self.name[indices]
        return self.name_pool.decode(codes)

    def resnames(self, indices=None) -> np.ndarray:
        codes = self.resname if indices is None else self.resname[indices]
        return self.resname_pool.decode(codes)

    def vdw(self) -> np.ndarray:
        """Per-atom vdW radius in nm (clipped table lookup; 0.15 nm default
        happens via index 0)."""
        z = np.clip(self.atomic_number, 0, pt.NUM_ELEMENTS - 1)
        return pt.ELEMENT_VDW_NM[z]

    def assign_resindex(self) -> None:
        """0-based index incremented at every contiguous-run boundary of resid
        (topology.rs:81-91) — not a sort, not unique-per-resid."""
        if self.n_atoms == 0:
            return
        changes = np.empty(self.n_atoms, dtype=bool)
        changes[0] = False
        changes[1:] = self.resid[1:] != self.resid[:-1]
        self.resindex = np.cumsum(changes).astype(INDEX)

    def set_bonds(self, bonds) -> None:
        b = np.asarray(bonds, dtype=INDEX).reshape(-1, 2)
        if b.size and (b.min() < 0 or b.max() >= self.n_atoms):
            raise TopologyError("bond index out of range")
        if b.size and np.any(b[:, 0] == b[:, 1]):
            raise TopologyError("self-bond")
        self.bonds = b

    def check_sizes(self) -> None:
        n = self.n_atoms
        for col in ("resname", "resid", "resindex", "atomic_number", "mass", "charge", "chain",
                    "bfactor", "occupancy"):
            if getattr(self, col).shape[0] != n:
                raise TopologyError(f"column {col} length mismatch")
