"""GRO reader and writer (fixed-column GROMACS coordinate files): the port's
counterpart of ``molar_tpu.io.gro``, first frame only.

Columns: resid 0:5, resname 5:10, name 10:15 (atom number 15:20 ignored),
x/y/z 20:28/28:36/36:44 nm, optional velocities 44:68 (present when the first
atom line is 68 characters or longer); the title's trailing ``t=<time>`` is
the frame time. Box line: 3 numbers = diagonal, 9 in GROMACS row order
``v1x v2y v3z v1y v1z v2x v2z v3x v3y``; a zero box gives no box. Elements
and masses are guessed from the names, residue indices assigned. The writer
uses ``%5d%-5s%5s%5d%8.3f%8.3f%8.3f`` with (i % 99999) + 1 atom numbers and
resid % 99999, and a 4-decimal box line; it writes no velocities.
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


class GroError(ValueError):
    pass


def read_gro(path: str) -> tuple[Topology, State]:
    """The first frame of a GRO file -> (topology, state)."""
    with open(path) as fh:
        title = fh.readline()
        if not title:
            raise GroError(f"gro file is empty: {path}")
        t = 0.0
        i = title.rfind("t=")
        if i >= 0:
            try:
                t = float(title[i + 2:].strip().split()[0])
            except (ValueError, IndexError):
                t = 0.0
        nline = fh.readline()
        try:
            natoms = int(nline.strip())
        except ValueError as e:
            raise GroError(f"bad atom count line in {path}: {nline!r}") from e
        lines = [fh.readline() for _ in range(natoms)]
        box_line = fh.readline()
    if natoms and not lines[-1]:
        raise GroError(f"truncated gro frame in {path}")
    has_vels = bool(lines) and len(lines[0].rstrip("\n")) >= 68
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
        raise GroError(f"atom {i} has a corrupted entry in {path}") from e
    vals = [float(v) for v in box_line.split()]
    if len(vals) < 3:
        raise GroError(f"bad box line in {path}: {box_line!r}")
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
    # The element guess of ``Atom.guess_element_and_mass``, once a distinct
    # (name, resname) pair.
    guess = {key: pt.guess_element_from_name(*key) for key in set(zip(names, resnames))}
    z = np.array([guess[key] for key in zip(names, resnames)], dtype=np.int16)
    top = topology_from_numpy(names, resnames, resids, np.zeros(natoms), [" "] * natoms,
                              pt.ELEMENT_MASSES[z], np.zeros(natoms), np.zeros(natoms),
                              np.zeros(natoms), z)
    top.assign_resindex()
    return top, State(coords=coords, velocities=vels, time=t, box=box)


def write_gro(path: str, topology: Topology, state: State) -> None:
    """Write one frame of every atom (coordinates and box; velocities are
    not written)."""
    names, resnames = topology.names(), topology.resnames()
    coords = np.asarray(state.coords, dtype=np.float64)
    out = [f"Created by molar_tpu_torch, t= {state.time:.3f}", f"{topology.n_atoms}"]
    for i in range(topology.n_atoms):
        line = "%5d%-5.5s%5.5s%5d%8.3f%8.3f%8.3f" % (
            int(topology.resid[i]) % 99999, resnames[i], names[i], (i % 99999) + 1,
            coords[i, 0], coords[i, 1], coords[i, 2])
        out.append(line)
    if state.box is not None:
        m = state.box.matrix
        line = "%10.4f %10.4f %10.4f" % (m[0, 0], m[1, 1], m[2, 2])
        if state.box.is_triclinic:
            line += " %10.4f %10.4f %10.4f %10.4f %10.4f %10.4f" % (
                m[1, 0], m[2, 0], m[0, 1], m[2, 1], m[0, 2], m[1, 2])
        out.append(line)
    else:
        out.append("0.0 0.0 0.0")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
