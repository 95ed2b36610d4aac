"""XTC reading and writing over the repository's C++ codec.

The slice's subset of ``molar_tpu.io.xtc.XtcHandler``: the file is
memory-mapped and indexed up front (exact random access), windows of frames
decode in parallel threads (ctypes releases the GIL inside the codec; one
pool a handler, closed with it), and
``read_frames_i16`` returns the stream's raw quantized ints for the
half-/quarter-byte window transports. Coordinates are nm, box rows on disk
are vectors (transposed into the column convention here).
"""

from __future__ import annotations

import ctypes
import mmap
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..native import load as load_native

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i16p = ctypes.POINTER(ctypes.c_int16)


#: Threads that decode the frames of one window, at most (never more than
#: the host's cores). From a sweep on the 8-core host of an NVIDIA H100 80GB
#: HBM3 (``chip_smoke.py``, the ``decode_workers`` line): 256 frames of
#: 100,000 atoms decode in 0.79-1.19 s on 1 thread, 0.25-0.54 on 4 and
#: 0.15-0.44 on 8 (three calls); the prefix decode of a 4,000-row subset
#: does not care (0.14-0.26 s for 1,024 frames at any count).
DECODE_WORKERS = 8


class XtcError(RuntimeError):
    pass


class MalformedFileError(XtcError):
    pass


class SeekError(XtcError):
    pass


@dataclass
class Frame:
    coords: np.ndarray  # (n_atoms, 3) f32
    box: Optional[PeriodicBox]
    time: float
    step: int


def _box_from_rows(box9: np.ndarray) -> Optional[PeriodicBox]:
    m = box9.reshape(3, 3).T
    if not m.any():
        return None
    try:
        return PeriodicBox(m)
    except PeriodicBoxError:
        return None


class XtcHandler:
    # Run-group overshoot slack rows of the prefix decoders (xtc_codec.cpp).
    PREFIX_SLACK = 10

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._lib = load_native()
        self._mm: Optional[mmap.mmap] = None
        self._sticky: Optional[int] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if mode == "r":
            self._fh = open(path, "rb")
            try:
                if os.fstat(self._fh.fileno()).st_size == 0:
                    raise MalformedFileError(f"xtc file is empty: {path}")
                self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
                self._data = np.frombuffer(self._mm, dtype=np.uint8)
                self._index()
            except BaseException:
                self.close()
                raise
        elif mode == "w":
            self._fh = open(path, "wb")
        else:
            raise ValueError(f"bad mode {mode!r}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _addr(self, offset: int):
        return self._data[offset:].ctypes.data_as(_u8p)

    def _index(self) -> None:
        size = len(self._mm)
        max_frames = max(size // 56, 1)
        offsets = np.empty(max_frames, dtype=np.int64)
        steps = np.empty(max_frames, dtype=np.int32)
        times = np.empty(max_frames, dtype=np.float32)
        natoms = ctypes.c_int32(-1)
        n = self._lib.xtc_index(
            self._addr(0),
            size,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            times.ctypes.data_as(_f32p),
            max_frames,
            ctypes.byref(natoms),
        )
        if n <= 0:
            raise MalformedFileError(f"no valid xtc frames in {self.path}")
        self._offsets = offsets[:n].copy()
        self._times = times[:n].copy()
        self._natoms = int(natoms.value)

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._natoms

    @property
    def times(self) -> np.ndarray:
        return self._times

    def _check_frame(self, i: int) -> None:
        if not 0 <= i < self.n_frames:
            raise SeekError(f"frame {i} out of range (0..{self.n_frames - 1})")

    def _decode_at(self, offset: int, coords_out: np.ndarray):
        box9 = np.empty(9, dtype=np.float32)
        step = ctypes.c_int32()
        time = ctypes.c_float()
        prec = ctypes.c_float()
        n = self._lib.xtc_decode_frame_buf(
            self._addr(offset),
            len(self._mm) - offset,
            coords_out.ctypes.data_as(_f32p),
            box9.ctypes.data_as(_f32p),
            ctypes.byref(step),
            ctypes.byref(time),
            ctypes.byref(prec),
        )
        if n != self._natoms:
            raise MalformedFileError(f"xtc decode failed at offset {offset} in {self.path}")
        return int(step.value), float(time.value), box9

    def _dialect(self) -> int:
        """Run-flag dialect (0 canonical, 1 sticky), detected once by a
        strict full decode; the prefix decoders cannot detect it themselves."""
        if self._sticky is None:
            coords = np.empty((self._natoms, 3), dtype=np.float32)
            box9 = np.empty(9, dtype=np.float32)
            step = ctypes.c_int32()
            time = ctypes.c_float()
            prec = ctypes.c_float()
            sticky = ctypes.c_int32()
            off = int(self._offsets[0])
            n = self._lib.xtc_decode_frame_detect(
                self._addr(off), len(self._mm) - off,
                coords.ctypes.data_as(_f32p), box9.ctypes.data_as(_f32p),
                ctypes.byref(step), ctypes.byref(time), ctypes.byref(prec),
                ctypes.byref(sticky),
            )
            if n != self._natoms:
                raise MalformedFileError(f"xtc dialect detection failed in {self.path}")
            self._sticky = sticky.value
        return self._sticky

    def read_frame(self, i: int) -> Frame:
        """Random-access decode of frame ``i``."""
        self._check_frame(i)
        coords = np.empty((self._natoms, 3), dtype=np.float32)
        step, time, box9 = self._decode_at(int(self._offsets[i]), coords)
        return Frame(coords=coords, box=_box_from_rows(box9), time=time, step=step)

    def _run(self, work, count: int) -> None:
        """``work(k)`` for every frame of a window, on the handler's pool
        (made at the first window that has more than one frame)."""
        workers = min(os.cpu_count() or 1, DECODE_WORKERS)
        if workers > 1 and count > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=workers)
            list(self._pool.map(work, range(count)))
        else:
            for k in range(count):
                work(k)

    def read_frames(self, start: int, count: int, alloc=None):
        """Parallel decode of a frame window -> (coords (B,N,3), boxes (B,3,3)
        column convention, times (B,)). ``alloc(shape, dtype) -> ndarray``
        places the coordinates (None: ``np.empty``)."""
        count = max(0, min(count, self.n_frames - start))
        coords = (alloc or np.empty)((count, self._natoms, 3), np.float32)
        boxes = np.empty((count, 3, 3), dtype=np.float32)
        times = np.empty(count, dtype=np.float32)

        def work(k: int):
            _, t, box9 = self._decode_at(int(self._offsets[start + k]), coords[k])
            boxes[k] = box9.reshape(3, 3).T
            times[k] = t

        self._run(work, count)
        return coords, boxes, times

    def read_frames_i16(
        self, start: int, count: int, n_prefix: Optional[int] = None, alloc=None
    ):
        """Decode a window to the raw quantized ints as int16:
        -> (icoords (B,N,3) i16, scale f32, boxes, times).

        ``icoords * scale`` reproduces the float decode bit-exactly. Raises
        ValueError when the window is not representable (beyond +-32767
        units, uncompressed tiny frames, mixed precisions); callers then use
        :meth:`read_frames`. ``n_prefix`` decodes only the first n_prefix
        atoms of each frame (XDR3DFR is sequential per atom). ``alloc(shape,
        dtype) -> ndarray`` places the ints (None: ``np.empty``).
        """
        count = max(0, min(count, self.n_frames - start))
        n_rows = self._natoms if n_prefix is None else min(n_prefix, self._natoms)
        if count == 0:
            return (
                np.empty((0, n_rows, 3), np.int16),
                np.float32(1.0),
                np.empty((0, 3, 3), np.float32),
                np.empty(0, np.float32),
            )
        prefix = n_rows < self._natoms
        sticky = self._dialect() if prefix else 0
        slack = self.PREFIX_SLACK if prefix else 0
        icoords = (alloc or np.empty)((count, n_rows + slack, 3), np.int16)
        boxes = np.empty((count, 3, 3), dtype=np.float32)
        times = np.empty(count, dtype=np.float32)
        precs = np.empty(count, dtype=np.float32)
        size = len(self._mm)

        def work(k: int):
            offset = int(self._offsets[start + k])
            box9 = np.empty(9, dtype=np.float32)
            step = ctypes.c_int32()
            time = ctypes.c_float()
            prec = ctypes.c_float()
            if prefix:
                n = self._lib.xtc_decode_frame_prefix_i16(
                    self._addr(offset), size - offset,
                    icoords[k].ctypes.data_as(_i16p), n_rows,
                    box9.ctypes.data_as(_f32p), ctypes.byref(step),
                    ctypes.byref(time), ctypes.byref(prec), sticky,
                )
            else:
                n = self._lib.xtc_decode_frame_buf_i16(
                    self._addr(offset), size - offset,
                    icoords[k].ctypes.data_as(_i16p),
                    box9.ctypes.data_as(_f32p), ctypes.byref(step),
                    ctypes.byref(time), ctypes.byref(prec),
                )
            if n == -2:
                raise ValueError("frame not representable as i16 quantized coordinates")
            if n != self._natoms:
                raise MalformedFileError(f"xtc decode failed at offset {offset} in {self.path}")
            boxes[k] = box9.reshape(3, 3).T
            times[k] = time.value
            precs[k] = prec.value

        self._run(work, count)
        if not (precs == precs[0]).all() or precs[0] <= 0:
            raise ValueError("mixed or invalid precisions in window")
        # Same f32 arithmetic as the C decoder: inv = 1.0f / precision.
        scale = np.float32(1.0) / np.float32(precs[0])
        if slack:
            icoords = icoords[:, :n_rows]
        return icoords, scale, boxes, times

    def write_raw(
        self,
        coords: np.ndarray,
        box_matrix: Optional[np.ndarray],
        step: int = 0,
        time: float = 0.0,
        precision: float = 1000.0,
    ) -> None:
        if self.mode == "r":
            raise XtcError("xtc handler opened read-only")
        box9 = (
            np.zeros((3, 3), np.float32)
            if box_matrix is None
            else np.ascontiguousarray(np.asarray(box_matrix).T, dtype=np.float32)
        )
        # The encoder reads raw f32: anything else must be converted first.
        coords = np.ascontiguousarray(coords, dtype=np.float32)
        out = _u8p()
        n = self._lib.xtc_encode_frame(
            coords.ctypes.data_as(_f32p), coords.shape[0],
            box9.ctypes.data_as(_f32p), step, time, precision, ctypes.byref(out),
        )
        if n < 0:
            raise MalformedFileError("xtc encode failed")
        try:
            self._fh.write(ctypes.string_at(out, n))
        finally:
            self._lib.xtc_free(out)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._mm is not None:
            # Drop the numpy view before closing the mapping it exports.
            self._data = None
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None
        self._fh.close()
