"""GRO reader/writer (fixed-column GROMACS coordinate files).

The port's copy of ``molar_tpu.io.gro`` (reference:
molar/src/io/gro_handler.rs):

* columns — resid 0:5, resname 5:10, name 10:15, (atom number 15:20 ignored),
  x/y/z 20:28/28:36/36:44, optional vx/vy/vz 44:52/52:60/60:68 (nm, nm/ps);
* velocity presence detected once from the first atom line's length (>= 68);
* title's trailing ``t=<time>`` parsed as the frame time (rfind);
* box line: 3 numbers = diagonal, 9 numbers in GROMACS row order
  v1x v2y v3z v1y v1z v2x v2z v3x v3y mapped into the column-vector matrix
  (gro_handler.rs:155-186); a zero diagonal gives ``box=None``, which
  matches the writer's "no box -> 0.0 0.0 0.0" round trip;
* elements guessed from names (once a distinct (name, resname) pair, the
  guess of ``Atom.guess_element_and_mass``); resindex assigned;
* multi-frame .gro trajectories supported (EOF after >=1 frame ends iteration);
* writer: ``%5d%-5s%5s%5d%8.3f...`` with (i % 99999)+1 atom numbering and
  resid % 99999, velocities written iff present, 4-decimal box line.

:func:`read_gro` / :func:`write_gro` are one-frame shorthands over
:class:`GroHandler`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..convert import topology_from_numpy
from ..core import periodic_table as pt
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from ..core.topology import Topology
from .base import (
    EmptyFileError,
    FormatHandler,
    MalformedFileError,
    NotWritableError,
    apply_indices,
)


class GroHandler(FormatHandler):
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

    def _read_frame(self) -> Optional[tuple[Topology, State]]:
        title = self._fh.readline()
        if not title:
            if self._read_any:
                return None
            raise EmptyFileError(f"gro file is empty: {self.path}")
        t = 0.0
        i = title.rfind("t=")
        if i >= 0:
            try:
                t = float(title[i + 2:].strip().split()[0])
            except (ValueError, IndexError):
                t = 0.0
        nline = self._fh.readline()
        try:
            natoms = int(nline.strip())
        except ValueError as e:
            raise MalformedFileError(f"bad atom count line in {self.path}: {nline!r}") from e

        lines = [self._fh.readline() for _ in range(natoms)]
        if not lines or len(lines[-1]) == 0:
            raise MalformedFileError(f"truncated gro frame in {self.path}")
        has_vels = len(lines[0].rstrip("\n")) >= 68

        resids, resnames, names = [], [], []
        coords = np.empty((natoms, 3), dtype=FLOAT)
        vels = np.empty((natoms, 3), dtype=FLOAT) if has_vels else None
        try:
            for i, line in enumerate(lines):
                resids.append(int(line[0:5]))
                resnames.append(line[5:10].strip())
                names.append(line[10:15].strip())
                coords[i] = (float(line[20:28]), float(line[28:36]), float(line[36:44]))
                if has_vels:
                    vels[i] = (float(line[44:52]), float(line[52:60]), float(line[60:68]))
        except (ValueError, IndexError) as e:
            raise MalformedFileError(f"atom {i} has corrupted entry in {self.path}") from e

        box_line = self._fh.readline()
        vals = [float(v) for v in box_line.split()]
        if len(vals) < 3:
            raise MalformedFileError(f"bad box line in {self.path}: {box_line!r}")
        m = np.zeros((3, 3), dtype=FLOAT)
        m[0, 0], m[1, 1], m[2, 2] = vals[0], vals[1], vals[2]
        if len(vals) == 9:
            m[1, 0], m[2, 0] = vals[3], vals[4]
            m[0, 1], m[2, 1] = vals[5], vals[6]
            m[0, 2], m[1, 2] = vals[7], vals[8]
        box: Optional[PeriodicBox]
        try:
            box = PeriodicBox(m)
        except PeriodicBoxError:
            box = None  # "0.0 0.0 0.0" no-box line

        guess = {key: pt.guess_element_from_name(*key) for key in set(zip(names, resnames))}
        z = np.array([guess[key] for key in zip(names, resnames)], dtype=np.int16)
        top = topology_from_numpy(names, resnames, resids, np.zeros(natoms), [" "] * natoms,
                                  pt.ELEMENT_MASSES[z], np.zeros(natoms), np.zeros(natoms),
                                  np.zeros(natoms), z)
        top.assign_resindex()
        self._read_any = True
        return top, State(coords=coords, velocities=vels, time=t, box=box)

    def read(self) -> tuple[Topology, State]:
        out = self._read_frame()
        if out is None:
            raise EOFError("end of gro trajectory")
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

    # -- writing ---------------------------------------------------------------

    def write(self, topology: Topology, state: State, indices=None) -> None:
        if "w" not in self.mode and "a" not in self.mode:
            raise NotWritableError("gro handler opened read-only")
        top, st = apply_indices(topology, state, indices)
        names = top.names()
        resnames = top.resnames()
        coords = np.asarray(st.coords, dtype=np.float64)
        vels = None if st.velocities is None else np.asarray(st.velocities, np.float64)
        out = [f"Created by molar_tpu, t= {st.time:.3f}", f"{top.n_atoms}"]
        for i in range(top.n_atoms):
            line = "%5d%-5.5s%5.5s%5d%8.3f%8.3f%8.3f" % (
                int(top.resid[i]) % 99999, str(resnames[i]), str(names[i]), (i % 99999) + 1,
                coords[i, 0], coords[i, 1], coords[i, 2])
            if vels is not None:
                line += "%8.4f%8.4f%8.4f" % (vels[i, 0], vels[i, 1], vels[i, 2])
            out.append(line)
        if st.box is not None:
            m = st.box.matrix
            line = "%10.4f %10.4f %10.4f" % (m[0, 0], m[1, 1], m[2, 2])
            if st.box.is_triclinic:
                line += " %10.4f %10.4f %10.4f %10.4f %10.4f %10.4f" % (
                    m[1, 0], m[2, 0], m[0, 1], m[2, 1], m[0, 2], m[1, 2])
            out.append(line)
        else:
            out.append("0.0 0.0 0.0")
        self._fh.write("\n".join(out) + "\n")


def read_gro(path: str) -> tuple[Topology, State]:
    """The first frame of a GRO file -> (topology, state)."""
    with GroHandler(str(path)) as h:
        return h.read()


def write_gro(path: str, topology: Topology, state: State, indices=None) -> None:
    """Write one frame (the atoms ``indices``, None: all) to a new GRO file."""
    with GroHandler(str(path), "w") as h:
        h.write(topology, state, indices)
