"""Multi-frame XYZ reader/writer (reference: molar/src/io/xyz_handler.rs).

Count line, comment line, then ``symbol x y z`` per atom; coordinates are
Angstrom on disk and nm in memory. Atoms get name=symbol, resname "MOL",
resid 1, chain 'A', element guessed from the symbol. The writer emits the
element symbol when known, else the atom name.

The port's copy of ``molar_tpu.io.xyz``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.atom import Atom
from ..core.periodic_table import element_symbol
from ..core.state import State
from ..core.topology import Topology
from .base import (
    EmptyFileError,
    FormatHandler,
    MalformedFileError,
    NotWritableError,
    apply_indices,
)


class XyzHandler(FormatHandler):
    can_read_topology = True
    can_read_state = True
    can_write = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._fh = open(path, mode)
        self._read_any = False
        self._stored_topology: Optional[Topology] = None
        self._stored_state: Optional[State] = None

    def close(self) -> None:
        self._fh.close()

    def _read_frame(self) -> Optional[tuple[Topology, State]]:
        line = self._fh.readline()
        if not line or not line.strip():
            if self._read_any:
                return None
            raise EmptyFileError(f"xyz file is empty: {self.path}")
        try:
            natoms = int(line.strip())
        except ValueError as e:
            raise MalformedFileError(f"malformed atom count line: {line!r}") from e
        self._fh.readline()  # comment line
        atoms: list[Atom] = []
        coords = np.empty((natoms, 3), dtype=FLOAT)
        for i in range(natoms):
            toks = self._fh.readline().split()
            if len(toks) < 4:
                raise MalformedFileError(f"truncated atom line {i}")
            try:
                coords[i] = [float(toks[1]), float(toks[2]), float(toks[3])]
            except ValueError as e:
                raise MalformedFileError(f"malformed coordinate on atom line {i}") from e
            atoms.append(
                Atom(name=toks[0], resname="MOL", resid=1, chain="A").guess_element_and_mass()
            )
        coords *= FLOAT(0.1)
        top = Topology.from_atoms(atoms)
        top.assign_resindex()
        self._read_any = True
        return top, State(coords=coords)

    def read(self) -> tuple[Topology, State]:
        out = self._read_frame()
        if out is None:
            raise EOFError("end of xyz trajectory")
        return out

    def read_topology(self) -> Topology:
        if self._stored_topology is not None:
            t, self._stored_topology = self._stored_topology, None
            return t
        top, st = self.read()
        if self._stored_state is None:
            self._stored_state = st
        return top

    def read_state(self) -> Optional[State]:
        if self._stored_state is not None:
            s, self._stored_state = self._stored_state, None
            return s
        out = self._read_frame()
        if out is None:
            return None
        top, st = out
        if self._stored_topology is None:
            self._stored_topology = top
        return st

    def write(self, topology: Topology, state: State, indices=None) -> None:
        if "w" not in self.mode and "a" not in self.mode:
            raise NotWritableError("xyz handler opened read-only")
        top, st = apply_indices(topology, state, indices)
        w = self._fh
        w.write(f"{top.n_atoms}\n\n")
        names = top.names()
        coords = np.asarray(st.coords, dtype=np.float64) * 10.0
        for i in range(top.n_atoms):
            sym = element_symbol(int(top.atomic_number[i])).upper() or str(names[i])
            w.write(
                "%s %12.6f %12.6f %12.6f\n" % (sym, coords[i, 0], coords[i, 1], coords[i, 2])
            )
