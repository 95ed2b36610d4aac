"""GROMACS .itp topology reader (+ minimal writer).

The port's own copy of ``molar_tpu.io.itp`` (no JAX).

Reads ``[ moleculetype ] -> [ atoms ]`` (nr, type, resid, resname, name,
cgnr, charge, mass), guessing elements from names (reference:
molar/src/io/itp_handler.rs:29-95), plus — as an extension over the reference
— the ``[ bonds ]`` section when present (first two columns, 1-based).
Topology-only: no coordinates live in an itp.
"""

from __future__ import annotations

import re

import numpy as np

from ..core.atom import Atom
from ..core.topology import Topology
from .base import FormatHandler, MalformedFileError, NotWritableError

_SECTION = re.compile(r"\[\s*(\w+)\s*\]")


class ItpHandler(FormatHandler):
    can_read_topology = True
    can_write = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._fh = open(path, mode)
        self._already_read = False

    def close(self) -> None:
        self._fh.close()

    def read_topology(self) -> Topology:
        if self._already_read:
            raise EOFError("itp already read")
        self._already_read = True
        section = None
        atoms: list[Atom] = []
        bonds: list[tuple[int, int]] = []
        saw_moleculetype = False
        for raw in self._fh:
            line = raw.split(";")[0].strip()
            if not line:
                continue
            m = _SECTION.match(line)
            if m:
                section = m.group(1).lower()
                if section == "moleculetype":
                    saw_moleculetype = True
                continue
            if section == "atoms":
                fields = line.split()
                if len(fields) < 8:
                    continue
                atoms.append(
                    Atom(
                        name=fields[4],
                        resname=fields[3],
                        type_name=fields[1],
                        resid=int(fields[2]),
                        charge=float(fields[6]),
                        mass=float(fields[7]),
                    ).guess_element()
                )
            elif section == "bonds":
                fields = line.split()
                if len(fields) >= 2:
                    bonds.append((int(fields[0]) - 1, int(fields[1]) - 1))
        if not saw_moleculetype:
            raise MalformedFileError(f"no [ moleculetype ] in {self.path}")
        if not atoms:
            raise MalformedFileError(f"no [ atoms ] in {self.path}")
        top = Topology.from_atoms(atoms)
        if bonds:
            top.set_bonds(bonds)
        top.assign_resindex()
        return top

    def write(self, topology: Topology, state=None, indices=None) -> None:
        if "w" not in self.mode:
            raise NotWritableError("itp handler opened read-only")
        top = topology if indices is None else topology.subset(np.asarray(indices))
        w = self._fh
        w.write("[ moleculetype ]\n; name  nrexcl\nMOL  3\n\n[ atoms ]\n")
        names = top.names()
        resnames = top.resnames()
        type_names = top.type_names()
        for i in range(top.n_atoms):
            tname = str(type_names[i]) if type_names is not None else str(names[i])
            w.write(
                f"{i + 1:>6} {tname:>6} {int(top.resid[i]):>6} {str(resnames[i]):>6} "
                f"{str(names[i]):>6} {i + 1:>6} {float(top.charge[i]):>10.4f} "
                f"{float(top.mass[i]):>10.4f}\n"
            )
        if top.n_bonds:
            w.write("\n[ bonds ]\n")
            for a, b in top.bonds:
                w.write(f"{a + 1:>6} {b + 1:>6}  1\n")
