"""SDF / MOL (V2000) reader/writer.

The port's own copy of ``molar_tpu.io.sdf`` (no JAX).

Behavioral contract (reference: molar/src/io/sdf_handler.rs): 4-line header
with counts line (fixed 3-wide fields), V3000 rejected; atom block
``x y z symbol`` (Angstrom -> nm, explicit element symbol resolved directly —
never name-guessed); bond block 1-based fixed 3-wide columns with orders
(2=double, 3=triple, 4=aromatic, else single) — the only reader that
populates bond orders; ``M  CHG`` supersedes the deprecated atom-block charge
column; ``$$$$`` separates records (multi-molecule sdf). Writer mirrors the
layout, 8 charge pairs per ``M  CHG`` line, ``$$$$`` only for .sdf/.sd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.atom import Atom, BondOrder
from ..core.periodic_table import (
    atomic_number_from_symbol,
    element_symbol,
    mass_of,
)
from ..core.state import State
from ..core.topology import Topology
from .base import (
    EmptyFileError,
    FormatHandler,
    MalformedFileError,
    NotWritableError,
    apply_indices,
)


def _int_field(line: str, start: int, width: int) -> int:
    field = line[start : start + width].strip()
    return int(field) if field else 0


class SdfHandler(FormatHandler):
    can_read_topology = True
    can_read_state = True
    can_write = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._fh = open(path, mode)
        self._sdf = path.lower().endswith((".sdf", ".sd"))
        self._read_any = False
        self._stored_topology: Optional[Topology] = None
        self._stored_state: Optional[State] = None

    def close(self) -> None:
        self._fh.close()

    # -- reading ---------------------------------------------------------------

    def _read_record(self) -> Optional[tuple[Topology, State]]:
        header = []
        saw_content = False
        for _ in range(4):
            line = self._fh.readline()
            if not line:
                if saw_content:
                    raise MalformedFileError("truncated molfile header")
                if self._read_any:
                    return None
                raise EmptyFileError(f"sdf/mol file is empty: {self.path}")
            saw_content |= bool(line.strip())
            header.append(line)
        counts = header[3]
        if "V3000" in counts:
            raise MalformedFileError("V3000 molfiles are not supported (only V2000)")
        natoms = _int_field(counts, 0, 3)
        nbonds = _int_field(counts, 3, 3)
        if natoms == 0:
            raise MalformedFileError(f"malformed counts line: {counts!r}")

        atoms: list[Atom] = []
        coords = np.empty((natoms, 3), dtype=FLOAT)
        for i in range(natoms):
            line = self._fh.readline()
            toks = line.split()
            if len(toks) < 4:
                raise MalformedFileError(f"truncated atom block at atom {i}")
            try:
                coords[i] = [float(toks[0]), float(toks[1]), float(toks[2])]
            except ValueError as e:
                raise MalformedFileError(f"malformed number in atom {i}") from e
            elem = toks[3]
            a = Atom(name=elem, resname="MOL", resid=1, chain="A")
            z = atomic_number_from_symbol(elem)
            if z:
                a.atomic_number = z
                a.mass = mass_of(z)
            else:
                a = a.guess_element_and_mass()
            atoms.append(a)
        coords *= FLOAT(0.1)

        bonds = []
        orders = []
        order_map = {2: BondOrder.DOUBLE, 3: BondOrder.TRIPLE, 4: BondOrder.AROMATIC}
        for i in range(nbonds):
            line = self._fh.readline()
            if not line:
                raise MalformedFileError(f"truncated bond block at bond {i}")
            try:
                a1 = _int_field(line, 0, 3)
                a2 = _int_field(line, 3, 3)
                ty = _int_field(line, 6, 3)
            except ValueError as e:
                raise MalformedFileError(f"malformed index/order in bond {i}") from e
            if not (1 <= a1 <= natoms and 1 <= a2 <= natoms):
                raise MalformedFileError(f"bond {i} index out of range")
            bonds.append((a1 - 1, a2 - 1))
            orders.append(int(order_map.get(ty, BondOrder.SINGLE)))

        # Properties: M CHG supersedes the atom-block charge column.
        while True:
            line = self._fh.readline()
            if not line:
                break
            s = line.rstrip()
            if s == "$$$$":
                break
            if s.startswith("M  CHG"):
                toks = s[6:].split()
                try:
                    count = int(toks[0])
                except (IndexError, ValueError):
                    count = 0
                for k in range(count):
                    try:
                        idx = int(toks[1 + 2 * k])
                        chg = int(toks[2 + 2 * k])
                    except (IndexError, ValueError):
                        break
                    if 1 <= idx <= natoms:
                        atoms[idx - 1].formal_charge = chg

        top = Topology.from_atoms(atoms)
        if bonds:
            top.set_bonds(bonds, orders)
        top.assign_resindex()
        self._read_any = True
        return top, State(coords=coords)

    def read(self) -> tuple[Topology, State]:
        out = self._read_record()
        if out is None:
            raise EOFError("end of sdf records")
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
        out = self._read_record()
        if out is None:
            return None
        top, st = out
        if self._stored_topology is None:
            self._stored_topology = top
        return st

    # -- writing ---------------------------------------------------------------

    def write(self, topology: Topology, state: State, indices=None) -> None:
        if "w" not in self.mode and "a" not in self.mode:
            raise NotWritableError("sdf handler opened read-only")
        top, st = apply_indices(topology, state, indices)
        w = self._fh
        w.write("\n  molar\n\n")
        w.write(f"{top.n_atoms:>3}{top.n_bonds:>3}  0  0  0  0  0  0  0  0999 V2000\n")
        names = top.names()
        coords = np.asarray(st.coords, dtype=np.float64) * 10.0
        for i in range(top.n_atoms):
            sym = element_symbol(int(top.atomic_number[i])) or str(names[i])
            w.write(
                "%10.4f%10.4f%10.4f %-3s 0  0  0  0  0  0  0  0  0  0  0  0\n"
                % (coords[i, 0], coords[i, 1], coords[i, 2], sym)
            )
        order_map = {
            int(BondOrder.DOUBLE): 2,
            int(BondOrder.TRIPLE): 3,
            int(BondOrder.AROMATIC): 4,
        }
        for k in range(top.n_bonds):
            ty = 1
            if top.bond_orders is not None:
                ty = order_map.get(int(top.bond_orders[k]), 1)
            w.write(f"{top.bonds[k, 0] + 1:>3}{top.bonds[k, 1] + 1:>3}{ty:>3}  0  0  0  0\n")
        if top.formal_charge is not None:
            charged = [
                (i + 1, int(c)) for i, c in enumerate(top.formal_charge) if c != 0
            ]
            for s in range(0, len(charged), 8):
                chunk = charged[s : s + 8]
                w.write(f"M  CHG{len(chunk):>3}")
                for idx, chg in chunk:
                    w.write(f"{idx:>4}{chg:>4}")
                w.write("\n")
        w.write("M  END\n")
        if self._sdf:
            w.write("$$$$\n")
