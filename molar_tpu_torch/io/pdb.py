"""PDB reader/writer.

Behavioral contract (reference: molar/src/io/pdb_handler.rs):

* fixed columns — name 12:16, resname 17:20, chain 21, resid 22:26,
  xyz 30:38/38:46/46:54 (Angstrom -> nm), occupancy 54:60 (default 1.0),
  bfactor 60:66 (default 0.0);
* element column 76:78 is authoritative when present; fall back to name
  guessing otherwise (pdb_handler.rs:188-200; a cysteine's SG would otherwise
  guess as seaborgium);
* CRYST1 -> box via lengths*0.1 + angles; an invalid CRYST1 silently yields no
  box (``.ok()`` in the reference);
* CONECT partners resolved through a serial->index map so TER-induced serial
  gaps don't shift bonds (pdb_handler.rs:152-155); unknown serials dropped;
  pairs sorted + deduped; order Unspecified;
* multi-model files are read model-by-model (MODEL/ENDMDL/END semantics of
  pdb_handler.rs:220-240); EOF after >=1 model ends iteration, empty file is
  an error;
* writer emits ``(i % 99999)+1`` serials, ``resid % 9999``, 4-char resname
  field, PDB name convention (<4-char names get a leading space).

The port's copy of ``molar_tpu.io.pdb``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.atom import Atom
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.periodic_table import atomic_number_from_symbol, element_symbol, mass_of
from ..core.state import State
from ..core.topology import Topology
from .base import EmptyFileError, FormatHandler, NotWritableError, apply_indices


def _field_f(line: str, a: int, b: int, default: float = 0.0) -> float:
    try:
        return float(line[a:b])
    except ValueError:
        return default


def _field_i(line: str, a: int, b: int) -> Optional[int]:
    try:
        return int(line[a:b])
    except ValueError:
        return None


def _format_atom_name(name: str) -> str:
    """PDB name convention: >=4 chars flush-left in 4 cols, shorter names get a
    leading space (pdb_handler.rs:83-89)."""
    if len(name) >= 4:
        return f"{name[:4]:<4}"
    return f" {name:<3}"


class PdbHandler(FormatHandler):
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

    # -- reading ---------------------------------------------------------------

    def read(self) -> tuple[Topology, State]:
        out = self._read_model()
        if out is None:
            if self._read_any:
                raise EOFError("end of pdb trajectory")
            raise EmptyFileError(f"pdb file has no atoms: {self.path}")
        return out

    def _read_model(self) -> Optional[tuple[Topology, State]]:
        atoms: list[Atom] = []
        coords: list[tuple[float, float, float]] = []
        # CRYST1 is a file-level header that applies to EVERY model (it is
        # written once, before MODEL 1); carry the last seen box into
        # subsequent models instead of resetting to None per model.
        box: Optional[PeriodicBox] = getattr(self, "_last_box", None)
        serial_to_index: dict[int, int] = {}
        conect: list[tuple[int, int]] = []
        has_atoms = False

        while True:
            pos = self._fh.tell()
            line = self._fh.readline()
            if not line:
                break
            rec = line[:6]
            if rec == "ATOM  " or rec == "HETATM":
                has_atoms = True
                x = _field_f(line, 30, 38)
                y = _field_f(line, 38, 46)
                z = _field_f(line, 46, 54)
                coords.append((x * 0.1, y * 0.1, z * 0.1))
                serial = _field_i(line, 6, 11)
                if serial is not None:
                    serial_to_index[serial] = len(atoms)
                name = line[12:16].strip()
                resname = line[17:20].strip()
                chain = line[21:22] or " "
                resid = _field_i(line, 22, 26) or 0
                occupancy = _field_f(line, 54, 60, default=1.0)
                bfactor = _field_f(line, 60, 66, default=0.0)
                a = Atom(
                    name=name,
                    resname=resname,
                    resid=resid,
                    chain=chain,
                    occupancy=occupancy,
                    bfactor=bfactor,
                )
                zn = atomic_number_from_symbol(line[76:78])
                if zn:
                    a.atomic_number = zn
                    a.mass = mass_of(zn)
                else:
                    a = a.guess_element_and_mass()
                atoms.append(a)
            elif line.startswith("CRYST1"):
                a_ = _field_f(line, 6, 15)
                b_ = _field_f(line, 15, 24)
                c_ = _field_f(line, 24, 33)
                al = _field_f(line, 33, 40, 90.0)
                be = _field_f(line, 40, 47, 90.0)
                ga = _field_f(line, 47, 54, 90.0)
                try:
                    box = PeriodicBox.from_vectors_angles(
                        a_ * 0.1, b_ * 0.1, c_ * 0.1, al, be, ga
                    )
                except PeriodicBoxError:
                    box = None
                self._last_box = box
            elif line.startswith("MODEL"):
                if has_atoms:
                    # New MODEL starts; previous model had no ENDMDL. Rewind so
                    # the next read starts at this MODEL line.
                    self._fh.seek(pos)
                    break
            elif line.startswith("ENDMDL"):
                break
            elif line.startswith("CONECT"):
                a_serial = _field_i(line, 6, 11)
                if a_serial is not None:
                    for s, e in ((11, 16), (16, 21), (21, 26), (26, 31)):
                        b_serial = _field_i(line, s, e)
                        if b_serial is not None and b_serial != a_serial:
                            conect.append(
                                (min(a_serial, b_serial), max(a_serial, b_serial))
                            )
            elif line.startswith("END") and not line.startswith("ENDMDL"):
                break

        if not has_atoms:
            return None

        bonds = sorted(
            {
                (serial_to_index[a], serial_to_index[b])
                for a, b in conect
                if a in serial_to_index and b in serial_to_index
            }
        )
        bonds = [tuple(sorted(p)) for p in bonds]
        top = Topology.from_atoms(atoms)
        if bonds:
            top.set_bonds(sorted(set(bonds)))
        top.assign_resindex()
        self._read_any = True
        state = State(coords=np.asarray(coords, dtype=FLOAT), box=box)
        return top, state

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
        out = self._read_model()
        if out is None:
            return None
        top, st = out
        if self._stored_topology is None:
            self._stored_topology = top
        return st

    # -- writing ---------------------------------------------------------------

    def write(self, topology: Topology, state: State, indices=None) -> None:
        if "w" not in self.mode and "a" not in self.mode:
            raise NotWritableError("pdb handler opened read-only")
        top, st = apply_indices(topology, state, indices)
        w = self._fh
        if st.box is not None:
            lengths, angles = st.box.to_vectors_angles()
            w.write(
                "CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1\n"
                % (
                    lengths[0] * 10.0,
                    lengths[1] * 10.0,
                    lengths[2] * 10.0,
                    angles[0],
                    angles[1],
                    angles[2],
                )
            )
        names = top.names()
        resnames = top.resnames()
        coords = np.asarray(st.coords, dtype=np.float64) * 10.0
        for i in range(top.n_atoms):
            w.write(
                "ATOM  %5d %s %-4.4s%1s%4d    %8.3f%8.3f%8.3f%6.2f%6.2f          %2s\n"
                % (
                    (i % 99999) + 1,
                    _format_atom_name(str(names[i])),
                    str(resnames[i]),
                    str(top.chain[i]) or " ",
                    int(top.resid[i]) % 9999,
                    coords[i, 0],
                    coords[i, 1],
                    coords[i, 2],
                    float(top.occupancy[i]),
                    float(top.bfactor[i]),
                    element_symbol(int(top.atomic_number[i])).upper(),
                )
            )
        w.write("END\n")
