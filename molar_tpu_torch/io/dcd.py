"""DCD trajectories (CHARMM/NAMD Fortran-record binary): the writer that
trjconv streams into, and a reader for checking what was written.

The port of ``molar_tpu.io.dcd.DcdHandler`` (reference:
molar/src/io/dcd_handler.rs): random access by frame, the facade's
``read_state`` / seeks, and the writer trjconv streams into. Fortran
records (i32 byte-count fore and aft); endianness from the first record
length (84); a 'CORD' header with icntrl ints: n_frames @4, istart @8,
nsavc @12, n_fixed @32, delta @36 (f32 if the CHARMM flag @76 is set, f64
otherwise), the per-frame unit-cell flag @40, the 4-dims flag @44; a title
record; the natoms record; per frame an optional 48-byte unit cell (6 f64:
[A, cos(g)|g_deg, B, cos(b)|b_deg, cos(a)|a_deg, C], a cosine iff |v| <= 1)
then X/Y/Z f32 records. Coordinates are Angstrom on disk (x 0.1); frame
time is (istart + frame * nsavc) * delta. Fixed atoms and 4-dimensional
files are refused.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Optional

import numpy as np

from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from .base import EmptyFileError, FormatHandler, MalformedFileError, NotWritableError, SeekError


def _parse_unit_cell(cell: np.ndarray) -> Optional[PeriodicBox]:
    a, g, b, be, al, c = [float(v) for v in cell]
    if a <= 0 or b <= 0 or c <= 0:
        return None

    def ang(v):
        return float(np.degrees(np.arccos(np.clip(v, -1, 1)))) if abs(v) <= 1.0 else v

    try:
        return PeriodicBox.from_vectors_angles(
            a * 0.1, b * 0.1, c * 0.1, ang(al), ang(be), ang(g)
        )
    except PeriodicBoxError:
        return None


class DcdHandler(FormatHandler):
    can_read_state = True
    can_write = True
    can_seek = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._pos = 0  # next frame read_state returns
        self._mm = None
        if mode == "r":
            self._fh = open(path, "rb")
            try:
                if os.fstat(self._fh.fileno()).st_size == 0:
                    raise EmptyFileError(f"dcd file is empty: {path}")
                self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
                self._buf = memoryview(self._mm)
                self._read_header()
            except BaseException:
                self.close()
                raise
        elif mode == "w":
            self._fh = open(path, "wb")
            self._n_atoms: Optional[int] = None
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- reading ----------------------------------------------------------------

    def _read_header(self) -> None:
        buf = self._buf
        (le_len,) = struct.unpack_from("<i", buf, 0)
        if le_len == 84:
            self._end = "<"
        else:
            (be_len,) = struct.unpack_from(">i", buf, 0)
            if be_len != 84:
                raise MalformedFileError(f"not a dcd file: {self.path}")
            self._end = ">"
        e = self._end
        if bytes(buf[4:8]) != b"CORD":
            raise MalformedFileError("missing CORD tag")
        ic = struct.unpack_from(f"{e}20i", buf, 8)
        self._istart = ic[1]
        self._nsavc = ic[2]
        n_fixed = max(ic[8], 0)
        self._has_cell = ic[10] != 0
        has_4d = ic[11] != 0
        if ic[19] != 0:  # CHARMM: delta is f32
            (self._delta,) = struct.unpack_from(f"{e}f", buf, 8 + 36)
        else:
            (self._delta,) = struct.unpack_from(f"{e}d", buf, 8 + 36)
        off = 4 + 84 + 4
        (tlen,) = struct.unpack_from(f"{e}i", buf, off)
        off += 4 + tlen + 4
        (nlen,) = struct.unpack_from(f"{e}i", buf, off)
        if nlen != 4:
            raise MalformedFileError("bad natoms record")
        (self._natoms,) = struct.unpack_from(f"{e}i", buf, off + 4)
        off += 12
        if n_fixed > 0:
            raise MalformedFileError("dcd files with fixed atoms are not supported")
        if has_4d:
            raise MalformedFileError("4-dimensional dcd files are not supported")
        self._data_start = off
        cell_bytes = 4 + 48 + 4 if self._has_cell else 0
        self._frame_bytes = cell_bytes + 3 * (self._natoms * 4 + 8)
        self._n_frames = max((len(buf) - off) // self._frame_bytes, 0)
        if self._n_frames == 0:
            raise MalformedFileError(f"no complete frames in {self.path}")

    @property
    def n_frames(self) -> int:
        return self._n_frames

    @property
    def n_atoms(self) -> int:
        return self._natoms

    @property
    def times(self) -> np.ndarray:
        fr = np.arange(self._n_frames)
        return ((self._istart + fr * self._nsavc) * self._delta).astype(np.float32)

    def read_frame(self, i: int) -> State:
        """Frame ``i`` as a host :class:`State` (nm)."""
        if not 0 <= i < self._n_frames:
            raise SeekError(f"frame {i} out of range (0..{self._n_frames - 1})")
        e = self._end
        off = self._data_start + i * self._frame_bytes
        box = None
        if self._has_cell:
            cell = np.frombuffer(self._buf, dtype=f"{e}f8", count=6, offset=off + 4)
            box = _parse_unit_cell(cell)
            off += 56
        n = self._natoms
        xyz = np.empty((3, n), dtype=np.float32)
        for d in range(3):
            (rl,) = struct.unpack_from(f"{e}i", self._buf, off)
            if rl != n * 4:
                raise MalformedFileError(f"bad coord record length at frame {i}")
            xyz[d] = np.frombuffer(self._buf, dtype=f"{e}f4", count=n, offset=off + 4)
            off += n * 4 + 8
        coords = (xyz.T * np.float32(0.1)).astype(np.float32)
        step = self._istart + i * self._nsavc
        return State(coords=coords, time=float(step * self._delta), step=step, box=box)

    def read_state(self) -> Optional[State]:
        """The next frame, or None past the last."""
        if self._pos >= self._n_frames:
            return None
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    # -- seeking ----------------------------------------------------------------

    def seek_frame(self, fr: int) -> None:
        if not 0 <= fr < self._n_frames:
            raise SeekError(f"frame {fr} out of range")
        self._pos = fr

    def seek_time(self, t: float) -> None:
        """Next read at the first frame whose time is >= ``t``."""
        i = int(np.searchsorted(self.times, t))
        if i >= self._n_frames:
            raise SeekError(f"time {t} beyond end of trajectory")
        self._pos = i

    def seek_last(self) -> State:
        self._pos = self._n_frames - 1
        return self.read_state()

    def tell_first(self) -> tuple[int, float]:
        return self._istart, float(self.times[0])

    # -- writing ----------------------------------------------------------------

    def _write_header(self, n_atoms: int) -> None:
        e = "<"
        ic = [0] * 20
        ic[2] = 1  # nsavc
        ic[10] = 1  # unit cell present
        ic[19] = 24  # CHARMM version flag
        # Frame count left 0: readers derive it from the file size.
        header = (b"CORD" + struct.pack(f"{e}9i", *ic[:9]) + struct.pack(f"{e}f", 1.0)
                  + struct.pack(f"{e}10i", *ic[10:]))
        self._fh.write(struct.pack(f"{e}i", 84) + header + struct.pack(f"{e}i", 84))
        title = b"Created by molar_tpu".ljust(80)
        trec = struct.pack(f"{e}i", 4 + 80) + struct.pack(f"{e}i", 1) + title
        self._fh.write(trec + struct.pack(f"{e}i", 4 + 80))
        self._fh.write(struct.pack(f"{e}iii", 4, n_atoms, 4))

    def _start_frame(self, n: int) -> None:
        if self.mode != "w":
            raise NotWritableError("dcd handler opened read-only")
        if self._n_atoms is None:
            self._n_atoms = n
            self._write_header(n)
        elif n != self._n_atoms:
            raise MalformedFileError("dcd frames must have a constant atom count")

    def write(self, topology, state: State, indices=None) -> None:
        """Append the rows ``indices`` (None: all) of a host state; the unit
        cell from its box's lengths and angles (zeros without a box).
        ``topology`` is not read."""
        idx = slice(None) if indices is None else np.asarray(indices)
        coords = np.asarray(state.coords[idx], dtype=np.float64) * 10.0
        n = coords.shape[0]
        self._start_frame(n)
        e = "<"
        if state.box is not None:
            lengths, angles = state.box.to_vectors_angles()
            cell = np.array([lengths[0] * 10.0, np.cos(np.radians(angles[2])),
                             lengths[1] * 10.0, np.cos(np.radians(angles[1])),
                             np.cos(np.radians(angles[0])), lengths[2] * 10.0],
                            dtype=f"{e}f8")
        else:
            cell = np.zeros(6, dtype=f"{e}f8")
        self._fh.write(struct.pack(f"{e}i", 48) + cell.tobytes() + struct.pack(f"{e}i", 48))
        for d in range(3):
            block = np.ascontiguousarray(coords[:, d], dtype=f"{e}f4").tobytes()
            self._fh.write(struct.pack(f"{e}i", n * 4) + block + struct.pack(f"{e}i", n * 4))

    def write_frame_raw(self, xyz: np.ndarray, cell6: np.ndarray) -> None:
        """Append one frame for a streaming converter: ``xyz`` the (3, n)
        f32 X/Y/Z rows already in Angstrom, ``cell6`` the unit-cell record
        [A, cos g, B, cos b, cos a, C] (lengths in Angstrom). One buffered
        write a frame; the same bytes as :meth:`write` for the same frame."""
        n = xyz.shape[1]
        self._start_frame(n)
        e = "<"
        nb = struct.pack(f"{e}i", n * 4)
        self._fh.write(b"".join((
            struct.pack(f"{e}i", 48),
            np.ascontiguousarray(cell6, dtype=f"{e}f8").tobytes(),
            struct.pack(f"{e}ii", 48, n * 4),
            np.ascontiguousarray(xyz[0], dtype=f"{e}f4").tobytes(),
            nb, nb,
            np.ascontiguousarray(xyz[1], dtype=f"{e}f4").tobytes(),
            nb, nb,
            np.ascontiguousarray(xyz[2], dtype=f"{e}f4").tobytes(),
            nb,
        )))

    def close(self) -> None:
        if self._mm is not None:
            self._buf.release()
            self._mm.close()
            self._mm = None
        self._fh.close()
