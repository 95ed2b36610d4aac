"""AMBER NetCDF trajectory handler (classic CDF-1/CDF-2, no libnetcdf).

The port's own copy of ``molar_tpu.io.netcdf_amber`` (no JAX).

The reference links C libnetcdf/HDF5 behind a cargo feature
(molar/src/io/netcdf_handler.rs); AMBER convention trajectories are classic-
format NetCDF, which is simple enough to parse directly — so this handler
reads/writes the classic container itself (magic 'CDF\\x01'/'CDF\\x02',
dim/attr/var lists, fixed + record variables) with zero native dependencies.

AMBER convention (Conventions="AMBER"): record dim ``frame``; variables
``coordinates`` (frame, atom, spatial) f32 Angstrom, ``time`` (frame) f32 ps,
``cell_lengths`` (frame, cell_spatial) f64 Angstrom, ``cell_angles`` f64
degrees, optional ``velocities``. Coordinates convert to nm in memory.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
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

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

_TYPES = {
    1: (np.dtype(">i1"), 1),
    2: (np.dtype("S1"), 1),
    3: (np.dtype(">i2"), 2),
    4: (np.dtype(">i4"), 4),
    5: (np.dtype(">f4"), 4),
    6: (np.dtype(">f8"), 8),
}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


@dataclass
class _Var:
    name: str
    dimids: list
    nc_type: int
    vsize: int
    begin: int
    attrs: dict = field(default_factory=dict)
    shape: tuple = ()
    is_record: bool = False


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.d, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.d, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.d, self.pos)
        self.pos += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.d[self.pos : self.pos + n].decode("ascii", "replace")
        self.pos += _pad4(n)
        return s

    def attr_values(self):
        nc_type = self.u32()
        n = self.u32()
        dt, sz = _TYPES[nc_type]
        raw = self.d[self.pos : self.pos + n * sz]
        self.pos += _pad4(n * sz)
        if nc_type == 2:
            return raw.decode("ascii", "replace")
        return np.frombuffer(raw, dtype=dt, count=n)

    def attr_list(self) -> dict:
        tag = self.u32()
        count = self.u32()
        if tag == 0 and count == 0:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise MalformedFileError("bad attribute list tag")
        out = {}
        for _ in range(count):
            name = self.string()
            out[name] = self.attr_values()
        return out


class NetcdfHandler(FormatHandler):
    can_read_state = True
    can_write = True
    can_seek = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._pos = 0
        if mode == "r":
            with open(path, "rb") as fh:
                self._data = fh.read()
            if len(self._data) < 8:
                raise EmptyFileError(f"netcdf file is empty: {path}")
            self._parse_header()
        elif mode == "w":
            self._fh = open(path, "wb")
            self._n_atoms: Optional[int] = None
            self._frames_written = 0
            self._frames: list = []  # buffered (coords_A, time, lengths_A, angles)
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- reading ------------------------------------------------------------

    def _parse_header(self) -> None:
        r = _Reader(self._data)
        magic = self._data[:4]
        if magic[:3] != b"CDF" or magic[3] not in (1, 2):
            raise MalformedFileError(f"not a classic netcdf file: {self.path}")
        self._cdf2 = magic[3] == 2
        r.pos = 4
        self._numrecs = r.u32()
        # dims
        tag = r.u32()
        ndims = r.u32()
        dims = []
        if tag == _NC_DIMENSION:
            for _ in range(ndims):
                name = r.string()
                length = r.u32()
                dims.append((name, length))
        self.dims = dims
        self.attrs = r.attr_list()
        tag = r.u32()
        nvars = r.u32()
        self.vars: dict[str, _Var] = {}
        if tag == _NC_VARIABLE:
            for _ in range(nvars):
                name = r.string()
                nd = r.u32()
                dimids = [r.u32() for _ in range(nd)]
                attrs = r.attr_list()
                nc_type = r.u32()
                vsize = r.u32()
                begin = r.u64() if self._cdf2 else r.u32()
                v = _Var(name, dimids, nc_type, vsize, begin, attrs)
                v.is_record = bool(dimids) and dims[dimids[0]][1] == 0
                v.shape = tuple(
                    dims[d][1] if dims[d][1] != 0 else self._numrecs for d in dimids
                )
                self.vars[name] = v
        # record size = sum of padded vsizes of record vars (classic rule:
        # a single record var is NOT padded)
        rec_vars = [v for v in self.vars.values() if v.is_record]
        if len(rec_vars) == 1:
            self._recsize = rec_vars[0].vsize
        else:
            self._recsize = sum(_pad4(v.vsize) for v in rec_vars)
        if "coordinates" not in self.vars:
            raise MalformedFileError("no 'coordinates' variable (AMBER convention)")

    @property
    def n_frames(self) -> int:
        return self._numrecs

    @property
    def n_atoms(self) -> int:
        return self.vars["coordinates"].shape[1]

    def _read_record(self, var: _Var, frame: int) -> np.ndarray:
        dt, sz = _TYPES[var.nc_type]
        count = int(np.prod(var.shape[1:], dtype=np.int64)) if len(var.shape) > 1 else 1
        off = var.begin + frame * self._recsize
        return np.frombuffer(self._data, dtype=dt, count=count, offset=off).reshape(
            var.shape[1:] or ()
        )

    def read_frame(self, i: int) -> State:
        if not 0 <= i < self._numrecs:
            raise SeekError(f"frame {i} out of range (0..{self._numrecs - 1})")
        coords = self._read_record(self.vars["coordinates"], i).astype(FLOAT) * FLOAT(0.1)
        t = 0.0
        if "time" in self.vars:
            t = float(self._read_record(self.vars["time"], i))
        box = None
        if "cell_lengths" in self.vars and "cell_angles" in self.vars:
            lengths = np.asarray(self._read_record(self.vars["cell_lengths"], i), float)
            angles = np.asarray(self._read_record(self.vars["cell_angles"], i), float)
            if lengths.all():
                try:
                    box = PeriodicBox.from_vectors_angles(
                        lengths[0] * 0.1, lengths[1] * 0.1, lengths[2] * 0.1,
                        angles[0], angles[1], angles[2],
                    )
                except PeriodicBoxError:
                    box = None
        vel = None
        if "velocities" in self.vars:
            vel = self._read_record(self.vars["velocities"], i).astype(FLOAT) * FLOAT(0.1)
        return State(coords=coords, velocities=vel, time=t, box=box)

    def read_state(self) -> Optional[State]:
        if self._pos >= self._numrecs:
            return None
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    def read_frames(self, start: int, count: int, n_threads=None):
        count = min(count, self._numrecs - start)
        n = self.n_atoms
        coords = np.empty((count, n, 3), np.float32)
        boxes = np.empty((count, 3, 3), np.float32)
        times = np.empty(count, np.float32)
        for k in range(count):
            st = self.read_frame(start + k)
            coords[k] = st.coords
            boxes[k] = st.box.matrix if st.box is not None else np.eye(3)
            times[k] = st.time
        return coords, boxes, times

    def seek_frame(self, fr: int) -> None:
        if not 0 <= fr < self._numrecs:
            raise SeekError(f"frame {fr} out of range")
        self._pos = fr

    def seek_time(self, t: float) -> None:
        times = [float(self._read_record(self.vars["time"], k)) for k in range(self._numrecs)] if "time" in self.vars else []
        for k, tv in enumerate(times):
            if tv >= t:
                self._pos = k
                return
        raise SeekError(f"time {t} beyond end of trajectory")

    def seek_last(self) -> State:
        self._pos = self._numrecs - 1
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    # -- writing -------------------------------------------------------------

    def write(self, topology, state: State, indices=None) -> None:
        if self.mode != "w":
            raise NotWritableError("netcdf handler opened read-only")
        idx = slice(None) if indices is None else np.asarray(indices)
        coords = np.asarray(state.coords[idx], dtype=np.float32) * 10.0
        if self._n_atoms is None:
            self._n_atoms = coords.shape[0]
        elif coords.shape[0] != self._n_atoms:
            raise MalformedFileError("netcdf frames must have a constant atom count")
        if state.box is not None:
            lengths, angles = state.box.to_vectors_angles()
            lengths = np.asarray(lengths, np.float64) * 10.0
            angles = np.asarray(angles, np.float64)
        else:
            lengths = np.zeros(3)
            angles = np.zeros(3)
        self._frames.append((coords, float(state.time), lengths, angles))

    @staticmethod
    def _nc_string(s: bytes) -> bytes:
        return struct.pack(">I", len(s)) + s + b"\0" * (_pad4(len(s)) - len(s))

    @staticmethod
    def _nc_attr(name: bytes, text: bytes) -> bytes:
        return (
            NetcdfHandler._nc_string(name)
            + struct.pack(">II", 2, len(text))
            + text
            + b"\0" * (_pad4(len(text)) - len(text))
        )

    def close(self) -> None:
        if self.mode != "w":
            return
        n = self._n_atoms or 0
        frames = self._frames
        out = bytearray()
        out += b"CDF\x01"
        out += struct.pack(">I", len(frames))
        dims = [(b"frame", 0), (b"spatial", 3), (b"atom", n),
                (b"cell_spatial", 3), (b"cell_angular", 3), (b"label", 5)]
        out += struct.pack(">II", _NC_DIMENSION, len(dims))
        for name, length in dims:
            out += self._nc_string(name) + struct.pack(">I", length)
        # The JAX package's attributes, so that both packages write the
        # same bytes for the same frames.
        gatts = [
            (b"title", b"Created by molar_tpu"),
            (b"application", b"molar_tpu"),
            (b"program", b"molar_tpu"),
            (b"programVersion", b"0.1"),
            (b"Conventions", b"AMBER"),
            (b"ConventionVersion", b"1.0"),
        ]
        out += struct.pack(">II", _NC_ATTRIBUTE, len(gatts))
        for k, v in gatts:
            out += self._nc_attr(k, v)

        # Variables: spatial, cell_spatial, cell_angular (fixed), then record
        # vars time, coordinates, cell_lengths, cell_angles.
        def var_header(name, dimids, attrs, nc_type, vsize, begin):
            b = self._nc_string(name)
            b += struct.pack(">I", len(dimids))
            for d in dimids:
                b += struct.pack(">I", d)
            if attrs:
                b += struct.pack(">II", _NC_ATTRIBUTE, len(attrs))
                for k, v in attrs:
                    b += self._nc_attr(k, v)
            else:
                b += struct.pack(">II", 0, 0)
            b += struct.pack(">III", nc_type, vsize, begin)
            return b

        # Layout plan (classic, CDF-1 offsets):
        specs = [
            # (name, dimids, attrs, nc_type, elem_count_fixed, record_count)
            (b"spatial", [1], [], 2, 3, None),
            (b"cell_spatial", [3], [], 2, 3, None),
            (b"cell_angular", [4, 5], [], 2, 15, None),
            (b"time", [0], [(b"units", b"picosecond")], 5, None, 1),
            (b"coordinates", [0, 2, 1], [(b"units", b"angstrom")], 5, None, n * 3),
            (b"cell_lengths", [0, 3], [(b"units", b"angstrom")], 6, None, 3),
            (b"cell_angles", [0, 4], [(b"units", b"degree")], 6, None, 3),
        ]
        # compute header size first with dummy offsets
        def emit_vars(offsets):
            b = struct.pack(">II", _NC_VARIABLE, len(specs))
            for (name, dimids, attrs, nc_type, fixed_count, rec_count), off in zip(
                specs, offsets
            ):
                dt, sz = _TYPES[nc_type]
                count = fixed_count if fixed_count is not None else rec_count
                vsize = _pad4(count * sz)
                b += var_header(name, dimids, attrs, nc_type, vsize, off)
            return b

        dummy = emit_vars([0] * len(specs))
        header_size = len(out) + len(dummy)
        offsets = []
        off = header_size
        # fixed vars first
        for name, dimids, attrs, nc_type, fixed_count, rec_count in specs:
            if fixed_count is not None:
                dt, sz = _TYPES[nc_type]
                offsets.append(off)
                off += _pad4(fixed_count * sz)
        rec_start = off
        # record vars, interleaved per record
        rec_off = rec_start
        for name, dimids, attrs, nc_type, fixed_count, rec_count in specs:
            if fixed_count is None:
                dt, sz = _TYPES[nc_type]
                offsets_rec = rec_off
                # insert in order
                offsets.append(offsets_rec)
                rec_off += _pad4(rec_count * sz)
        recsize = rec_off - rec_start
        out += emit_vars(offsets)
        assert len(out) == header_size
        # fixed data
        out += b"xyz" + b"\0"  # spatial (3 chars padded)
        out += b"abc" + b"\0"  # cell_spatial
        out += (b"alpha" + b"beta\0" + b"gamma").ljust(16, b"\0")  # 15 chars padded
        # records
        for coords, t, lengths, angles in frames:
            rec = bytearray()
            rec += struct.pack(">f", t)
            rec += np.ascontiguousarray(coords, dtype=">f4").tobytes()
            rec += b"\0" * (_pad4(n * 3 * 4) - n * 3 * 4)
            rec += np.ascontiguousarray(lengths, dtype=">f8").tobytes()
            rec += np.ascontiguousarray(angles, dtype=">f8").tobytes()
            assert len(rec) == recsize, (len(rec), recsize)
            out += rec
        self._fh.write(bytes(out))
        self._fh.close()
