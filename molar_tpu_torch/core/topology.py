"""Columnar topology: structure-of-arrays atoms, bonds, molecules.

The port's copy of ``molar_tpu.core.topology`` (numpy only). String columns
are int32 codes into a :class:`~.interner.NamePool`; the optional columns
(``type_name``/``type_id``/``formal_charge``/``flags``) materialize on first
write with "unset" defaults, per column not per atom (atom_storage.rs:14-20);
``bond_orders`` is None until a format or a caller sets it. Editing
(``subset``, ``remove_atoms``, ``concat``) rebuilds the columns, renumbering
bonds and dropping the cached adjacency (topology.rs:54-77).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..config import NP_INDEX as INDEX
from . import periodic_table as pt
from .atom import Atom
from .interner import NamePool


class TopologyError(ValueError):
    pass


@dataclass
class Adjacency:
    """CSR bond adjacency cached on the topology; invalidated by structural
    change but surviving order writes (reference: bond_storage.rs:193,326)."""

    offsets: np.ndarray  # int32[N+1]
    neighbors: np.ndarray  # int32[2*nbonds], sorted within each row

    def of(self, i: int) -> np.ndarray:
        return self.neighbors[self.offsets[i] : self.offsets[i + 1]]

    def degree(self) -> np.ndarray:
        return np.diff(self.offsets)


def _build_adjacency(n_atoms: int, bonds: np.ndarray) -> Adjacency:
    if bonds.size == 0:
        return Adjacency(np.zeros(n_atoms + 1, INDEX), np.zeros(0, INDEX))
    ends = np.concatenate([bonds[:, 0], bonds[:, 1]])
    other = np.concatenate([bonds[:, 1], bonds[:, 0]])
    order = np.lexsort((other, ends))
    ends, other = ends[order], other[order]
    counts = np.bincount(ends, minlength=n_atoms)
    offsets = np.zeros(n_atoms + 1, INDEX)
    np.cumsum(counts, out=offsets[1:])
    return Adjacency(offsets, other.astype(INDEX))


class Topology:
    """SoA atoms + bonds + molecules."""

    def __init__(self, n_atoms: int = 0):
        self.name_pool = NamePool()
        self.resname_pool = NamePool()
        self.type_pool = NamePool()
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
        # Optional columns: None until first written (atom_storage.rs:14-20).
        self.type_name: Optional[np.ndarray] = None  # codes into type_pool
        self.type_id: Optional[np.ndarray] = None
        self.formal_charge: Optional[np.ndarray] = None
        self.flags: Optional[np.ndarray] = None
        # Bonds.
        self.bonds = np.zeros((0, 2), INDEX)
        self.bond_orders: Optional[np.ndarray] = None  # uint8, per bond
        # Molecules: inclusive [first, last] ranges (TPR only; topology.rs:15).
        self.molecules = np.zeros((0, 2), INDEX)
        self._adjacency: Optional[Adjacency] = None

    # -- construction ---------------------------------------------------------

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
        if any(a.type_name is not None for a in atoms):
            top.type_name = top.type_pool.intern_all([a.type_name or "" for a in atoms])
        if any(a.type_id is not None for a in atoms):
            top.type_id = np.array([a.type_id or 0 for a in atoms], INDEX)
        if any(a.formal_charge is not None for a in atoms):
            top.formal_charge = np.array([a.formal_charge or 0 for a in atoms], np.int8)
        if any(a.flags is not None for a in atoms):
            top.flags = np.array([a.flags or 0 for a in atoms], np.uint8)
        return top

    @property
    def n_atoms(self) -> int:
        return self.name.shape[0]

    @property
    def n_bonds(self) -> int:
        return self.bonds.shape[0]

    def __len__(self) -> int:
        return self.n_atoms

    # -- per-atom access (slow path; for tests, IO writers, repr) -------------

    def atom(self, i: int) -> Atom:
        return Atom(
            name=self.name_pool.lookup(int(self.name[i])),
            resname=self.resname_pool.lookup(int(self.resname[i])),
            resid=int(self.resid[i]),
            resindex=int(self.resindex[i]),
            atomic_number=int(self.atomic_number[i]),
            mass=float(self.mass[i]),
            charge=float(self.charge[i]),
            chain=str(self.chain[i]),
            bfactor=float(self.bfactor[i]),
            occupancy=float(self.occupancy[i]),
            type_name=(
                self.type_pool.lookup(int(self.type_name[i]))
                if self.type_name is not None
                else None
            ),
            type_id=int(self.type_id[i]) if self.type_id is not None else None,
            formal_charge=(
                int(self.formal_charge[i]) if self.formal_charge is not None else None
            ),
            flags=int(self.flags[i]) if self.flags is not None else None,
        )

    def names(self, indices=None) -> np.ndarray:
        codes = self.name if indices is None else self.name[indices]
        return self.name_pool.decode(codes)

    def resnames(self, indices=None) -> np.ndarray:
        codes = self.resname if indices is None else self.resname[indices]
        return self.resname_pool.decode(codes)

    def type_names(self, indices=None) -> Optional[np.ndarray]:
        if self.type_name is None:
            return None
        codes = self.type_name if indices is None else self.type_name[indices]
        return self.type_pool.decode(codes)

    def vdw(self) -> np.ndarray:
        """Per-atom vdW radius in nm (clipped table lookup; 0.15 nm default
        happens via index 0)."""
        z = np.clip(self.atomic_number, 0, pt.NUM_ELEMENTS - 1)
        return pt.ELEMENT_VDW_NM[z]

    # -- optional-column materialization --------------------------------------

    def ensure_type_name(self) -> np.ndarray:
        if self.type_name is None:
            self.type_pool.intern("")  # code 0 = unset
            self.type_name = np.zeros(self.n_atoms, INDEX)
        return self.type_name

    def ensure_type_id(self) -> np.ndarray:
        if self.type_id is None:
            self.type_id = np.zeros(self.n_atoms, INDEX)
        return self.type_id

    def ensure_formal_charge(self) -> np.ndarray:
        if self.formal_charge is None:
            self.formal_charge = np.zeros(self.n_atoms, np.int8)
        return self.formal_charge

    def ensure_flags(self) -> np.ndarray:
        if self.flags is None:
            self.flags = np.zeros(self.n_atoms, np.uint8)
        return self.flags

    # -- residues / molecules --------------------------------------------------

    def assign_resindex(self) -> None:
        """0-based index incremented at every contiguous-run boundary of resid
        (topology.rs:81-91) — not a sort, not unique-per-resid."""
        if self.n_atoms == 0:
            return
        changes = np.empty(self.n_atoms, dtype=bool)
        changes[0] = False
        changes[1:] = self.resid[1:] != self.resid[:-1]
        self.resindex = np.cumsum(changes).astype(INDEX)

    # -- bonds ------------------------------------------------------------------

    def set_bonds(
        self,
        bonds: np.ndarray | Sequence[Sequence[int]],
        orders: Optional[np.ndarray | Sequence[int]] = None,
    ) -> None:
        b = np.asarray(bonds, dtype=INDEX).reshape(-1, 2)
        if b.size and (b.min() < 0 or b.max() >= self.n_atoms):
            raise TopologyError("bond index out of range")
        if b.size and np.any(b[:, 0] == b[:, 1]):
            raise TopologyError("self-bond")
        self.bonds = b
        if orders is not None:
            o = np.asarray(orders, dtype=np.uint8)
            if o.shape[0] != b.shape[0]:
                raise TopologyError("bond order column length mismatch")
            self.bond_orders = o
        else:
            self.bond_orders = None
        self._adjacency = None

    def add_bonds(
        self, bonds: np.ndarray | Sequence[Sequence[int]], orders=None
    ) -> None:
        b = np.asarray(bonds, dtype=INDEX).reshape(-1, 2)
        if b.size and (b.min() < 0 or b.max() >= self.n_atoms):
            raise TopologyError("bond index out of range")
        if orders is not None or self.bond_orders is not None:
            old = (
                self.bond_orders
                if self.bond_orders is not None
                else np.zeros(self.n_bonds, np.uint8)
            )
            new = (
                np.asarray(orders, np.uint8)
                if orders is not None
                else np.zeros(b.shape[0], np.uint8)
            )
            self.bond_orders = np.concatenate([old, new])
        self.bonds = np.concatenate([self.bonds, b])
        self._adjacency = None

    @property
    def adjacency(self) -> Adjacency:
        if self._adjacency is None:
            self._adjacency = _build_adjacency(self.n_atoms, self.bonds)
        return self._adjacency

    def set_bond_orders(self, orders: np.ndarray) -> None:
        """Order writes keep the cached adjacency (bond_storage.rs:193)."""
        o = np.asarray(orders, np.uint8)
        if o.shape[0] != self.n_bonds:
            raise TopologyError("bond order column length mismatch")
        self.bond_orders = o

    # -- editing -----------------------------------------------------------------

    def subset(self, indices: np.ndarray) -> "Topology":
        """New topology with the given atoms (in the given order); bonds with
        both ends inside are kept and renumbered, molecules are dropped."""
        idx = np.asarray(indices, dtype=np.int64)
        out = Topology(len(idx))
        # Re-intern names so subset pools are compact.
        out.name = out.name_pool.intern_all(list(self.names(idx)))
        out.resname = out.resname_pool.intern_all(list(self.resnames(idx)))
        out.resid = self.resid[idx].copy()
        out.resindex = self.resindex[idx].copy()
        out.atomic_number = self.atomic_number[idx].copy()
        out.mass = self.mass[idx].copy()
        out.charge = self.charge[idx].copy()
        out.chain = self.chain[idx].copy()
        out.bfactor = self.bfactor[idx].copy()
        out.occupancy = self.occupancy[idx].copy()
        if self.type_name is not None:
            tn = self.type_names(idx)
            out.type_pool.intern("")
            out.type_name = out.type_pool.intern_all(list(tn))
        if self.type_id is not None:
            out.type_id = self.type_id[idx].copy()
        if self.formal_charge is not None:
            out.formal_charge = self.formal_charge[idx].copy()
        if self.flags is not None:
            out.flags = self.flags[idx].copy()
        if self.n_bonds:
            remap = np.full(self.n_atoms, -1, np.int64)
            remap[idx] = np.arange(len(idx))
            b = remap[self.bonds]
            keep = (b >= 0).all(axis=1)
            out.bonds = b[keep].astype(INDEX)
            if self.bond_orders is not None:
                out.bond_orders = self.bond_orders[keep].copy()
        return out

    def remove_atoms(self, indices: np.ndarray) -> "Topology":
        """New topology without the given atoms (keeps order of the rest);
        bonds renumbered, dangling bonds dropped (topology.rs:54-77)."""
        mask = np.ones(self.n_atoms, dtype=bool)
        mask[np.asarray(indices, dtype=np.int64)] = False
        return self.subset(np.nonzero(mask)[0])

    def concat(self, other: "Topology") -> "Topology":
        """New topology = self atoms then other atoms; other's bonds shifted."""
        n1 = self.n_atoms
        out = self.subset(np.arange(n1))
        out.name = np.concatenate(
            [out.name, out.name_pool.intern_all(list(other.names()))]
        )
        out.resname = np.concatenate(
            [out.resname, out.resname_pool.intern_all(list(other.resnames()))]
        )
        for col in (
            "resid",
            "resindex",
            "atomic_number",
            "mass",
            "charge",
            "chain",
            "bfactor",
            "occupancy",
        ):
            setattr(out, col, np.concatenate([getattr(out, col), getattr(other, col)]))
        n2 = other.n_atoms
        for col, ensure in (
            ("type_id", Topology.ensure_type_id),
            ("formal_charge", Topology.ensure_formal_charge),
            ("flags", Topology.ensure_flags),
        ):
            if getattr(out, col) is not None or getattr(other, col) is not None:
                ensure(out)
                a = getattr(out, col)
                b = getattr(other, col)
                if b is None:
                    b = np.zeros(n2, a.dtype)
                setattr(out, col, np.concatenate([a, b[:n2]]))
        if out.type_name is not None or other.type_name is not None:
            out.ensure_type_name()
            if other.type_name is not None:
                codes = out.type_pool.intern_all(list(other.type_names()))
            else:
                codes = np.zeros(n2, INDEX)
            out.type_name = np.concatenate([out.type_name, codes])
        if other.n_bonds:
            shifted = other.bonds + n1
            orders = other.bond_orders
            out.add_bonds(shifted, orders)
        out._adjacency = None
        return out

    def check_sizes(self) -> None:
        n = self.n_atoms
        for col in (
            "resname",
            "resid",
            "resindex",
            "atomic_number",
            "mass",
            "charge",
            "chain",
            "bfactor",
            "occupancy",
        ):
            if getattr(self, col).shape[0] != n:
                raise TopologyError(f"column {col} length mismatch")
