"""TRR trajectory handler (GROMACS XDR .trr).

The port's own copy of ``molar_tpu.io.trr`` (no JAX).

Format contract (reference: molar/src/io/trr_handler.rs:14-240): big-endian
XDR; per frame — magic 1993, slen 13, XDR string "GMX_trn_file", ten section
sizes (ir/e/box/vir/pres/top/sym/x/v/f), natoms/step/nre, time+lambda, then
box (9 reals, consecutive triples = box vectors = our matrix columns), vir/
pres (skipped), x/v/f blocks. On-disk reals are f32 or f64, detected from the
section sizes; writing is always f32.

Design: mmap + upfront header index (frame sizes are computable from each
header), numpy bulk big-endian decodes, exact random access, selective
read (skip vel/force at the IO level — ``read_state_pick``), and windowed
reads for the device pipeline.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from .base import (
    EmptyFileError,
    FormatHandler,
    MalformedFileError,
    NotWritableError,
    SeekError,
)

MAGIC = 1993
VERSION = b"GMX_trn_file"


class _Header:
    __slots__ = (
        "box_size", "vir_size", "pres_size", "x_size", "v_size", "f_size",
        "natoms", "step", "time", "double", "header_bytes", "data_bytes",
    )


def _parse_header(buf: memoryview, off: int) -> Optional[_Header]:
    try:
        magic, slen, strlen = struct.unpack_from(">iii", buf, off)
    except struct.error:
        return None
    if magic != MAGIC:
        return None
    padded = (strlen + 3) & ~3
    p = off + 12
    if bytes(buf[p : p + strlen]) != VERSION[:strlen]:
        return None
    p += padded
    try:
        (ir, e, box_size, vir, pres, top, sym, x, v, f, natoms, step, nre) = (
            struct.unpack_from(">13i", buf, p)
        )
    except struct.error:
        return None
    p += 52
    n3 = natoms * 3
    double = box_size == 72 or x == n3 * 8 or (v != 0 and v == n3 * 8) or (
        f != 0 and f == n3 * 8
    )
    elem = 8 if double else 4
    try:
        if double:
            (time,) = struct.unpack_from(">d", buf, p)
        else:
            (time,) = struct.unpack_from(">f", buf, p)
    except struct.error:
        return None
    p += 2 * elem  # time + lambda
    h = _Header()
    h.box_size, h.vir_size, h.pres_size = box_size, vir, pres
    h.x_size, h.v_size, h.f_size = x, v, f
    h.natoms, h.step, h.time, h.double = natoms, step, float(time), double
    h.header_bytes = p - off
    data = 0
    for sz, count in ((box_size, 9), (vir, 9), (pres, 9), (x, n3), (v, n3), (f, n3)):
        if sz != 0:
            data += count * elem
    h.data_bytes = data
    return h


class TrrHandler(FormatHandler):
    can_read_state = True
    can_write = True
    can_seek = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._pos = 0
        self._mm = None
        if mode == "r":
            self._fh = open(path, "rb")
            if os.fstat(self._fh.fileno()).st_size == 0:
                raise EmptyFileError(f"trr file is empty: {path}")
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
            self._buf = memoryview(self._mm)
            self._index()
        elif mode in ("w", "a"):
            self._fh = open(path, mode + "b")
        else:
            raise ValueError(f"bad mode {mode!r}")

    def _index(self) -> None:
        self._offsets: list[int] = []
        self._headers: list[_Header] = []
        off = 0
        size = len(self._buf)
        while off + 72 <= size:
            h = _parse_header(self._buf, off)
            if h is None or off + h.header_bytes + h.data_bytes > size:
                break
            self._offsets.append(off)
            self._headers.append(h)
            off += h.header_bytes + h.data_bytes
        if not self._offsets:
            raise MalformedFileError(f"no valid trr frames in {self.path}")

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._headers[0].natoms

    @property
    def times(self) -> np.ndarray:
        return np.array([h.time for h in self._headers], dtype=FLOAT)

    # -- reading ----------------------------------------------------------------

    def read_frame(
        self, i: int, need_velocities: bool = True, need_forces: bool = True
    ) -> State:
        if not 0 <= i < self.n_frames:
            raise SeekError(f"frame {i} out of range (0..{self.n_frames - 1})")
        h = self._headers[i]
        off = self._offsets[i] + h.header_bytes
        elem = 8 if h.double else 4
        dt = np.dtype(">f8") if h.double else np.dtype(">f4")
        n3 = h.natoms * 3

        box = None
        if h.box_size:
            vals = np.frombuffer(self._buf, dtype=dt, count=9, offset=off).astype(
                np.float64
            )
            off += 9 * elem
            # consecutive triples are box vectors -> our matrix columns
            m = vals.reshape(3, 3).T
            try:
                box = PeriodicBox(m)
            except PeriodicBoxError:
                box = None
        if h.vir_size:
            off += 9 * elem
        if h.pres_size:
            off += 9 * elem
        coords = vel = force = None
        if h.x_size:
            coords = (
                np.frombuffer(self._buf, dtype=dt, count=n3, offset=off)
                .astype(FLOAT)
                .reshape(-1, 3)
            )
            off += n3 * elem
        if h.v_size:
            if need_velocities:
                vel = (
                    np.frombuffer(self._buf, dtype=dt, count=n3, offset=off)
                    .astype(FLOAT)
                    .reshape(-1, 3)
                )
            off += n3 * elem
        if h.f_size and need_forces:
            force = (
                np.frombuffer(self._buf, dtype=dt, count=n3, offset=off)
                .astype(FLOAT)
                .reshape(-1, 3)
            )
        if coords is None:
            raise MalformedFileError(f"trr frame {i} has no coordinates")
        return State(
            coords=coords,
            velocities=vel,
            forces=force,
            time=h.time,
            step=h.step,
            box=box,
        )

    def read_state(self) -> Optional[State]:
        if self._pos >= self.n_frames:
            return None
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    def read_state_pick(self, need_velocities=True, need_forces=True) -> Optional[State]:
        if self._pos >= self.n_frames:
            return None
        st = self.read_frame(self._pos, need_velocities, need_forces)
        self._pos += 1
        return st

    def read_frames(self, start: int, count: int, n_threads=None):
        """Windowed coords decode -> (coords (B,N,3), boxes, times)."""
        count = min(count, self.n_frames - start)
        n = self.n_atoms
        coords = np.empty((count, n, 3), np.float32)
        boxes = np.empty((count, 3, 3), np.float32)
        times = np.empty(count, np.float32)
        for k in range(count):
            st = self.read_frame(start + k, need_velocities=False, need_forces=False)
            coords[k] = st.coords
            boxes[k] = st.box.matrix if st.box is not None else np.eye(3)
            times[k] = st.time
        return coords, boxes, times

    # -- seeking ----------------------------------------------------------------

    def seek_frame(self, fr: int) -> None:
        if not 0 <= fr < self.n_frames:
            raise SeekError(f"frame {fr} out of range")
        self._pos = fr

    def seek_time(self, t: float) -> None:
        times = self.times
        i = int(np.searchsorted(times, t))
        if i >= self.n_frames:
            raise SeekError(f"time {t} beyond end of trajectory")
        self._pos = i

    def seek_last(self) -> State:
        self._pos = self.n_frames - 1
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    def tell_first(self) -> tuple[int, float]:
        return self._headers[0].step, self._headers[0].time

    # -- writing ----------------------------------------------------------------

    def write(self, topology, state: State, indices=None) -> None:
        if self.mode == "r":
            raise NotWritableError("trr handler opened read-only")
        self.write_state(state, indices)

    def write_state(
        self,
        state: State,
        indices=None,
        write_coords: bool = True,
        write_velocities: bool = True,
        write_forces: bool = True,
    ) -> None:
        idx = slice(None) if indices is None else np.asarray(indices)
        coords = state.coords[idx] if write_coords else None
        vel = (
            state.velocities[idx]
            if write_velocities and state.velocities is not None
            else None
        )
        force = (
            state.forces[idx] if write_forces and state.forces is not None else None
        )
        n = (
            coords.shape[0]
            if coords is not None
            else (vel.shape[0] if vel is not None else 0)
        )
        n3 = n * 3
        w = self._fh
        parts = [struct.pack(">iii", MAGIC, 13, 12), VERSION]
        parts.append(
            struct.pack(
                ">13i",
                0,
                0,
                36 if state.box is not None else 0,
                0,
                0,
                0,
                0,
                n3 * 4 if coords is not None else 0,
                n3 * 4 if vel is not None else 0,
                n3 * 4 if force is not None else 0,
                n,
                state.step,
                0,
            )
        )
        parts.append(struct.pack(">ff", state.time, 0.0))
        if state.box is not None:
            parts.append(
                np.ascontiguousarray(state.box.matrix.T, dtype=">f4").tobytes()
            )
        for block in (coords, vel, force):
            if block is not None:
                parts.append(np.ascontiguousarray(block, dtype=">f4").tobytes())
        w.write(b"".join(parts))

    def close(self) -> None:
        if self._mm is not None:
            self._buf.release()
            self._mm.close()
        self._fh.close()
