"""The benchmark's own XTC codec: ``xtc_codec.cpp`` beside this file (a frozen
copy of ``molar_tpu/native/xtc_codec.cpp``), built with g++ into a fixed
directory of the checkout and bound with ctypes.

It writes the benchmark's trajectories and decodes the frames its reference
checks, so neither leans on the program's codec. The ctypes declarations
follow ``molar_tpu_torch/native.py``.
"""

from __future__ import annotations

import ctypes
import functools
import mmap
import os
import pathlib
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "xtc_codec.cpp"
#: Fixed, inside the checkout (``build/`` is ignored by git), so that only the
#: first run of a checkout compiles.
BUILD_DIR = HERE.parent.parent / "build" / "portbench"
LIBRARY = BUILD_DIR / "libportbench_xtc.so"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_longp = ctypes.POINTER(ctypes.c_long)


def build() -> pathlib.Path:
    """Compile the codec unless an up-to-date library is there; the output is
    written under a temporary name and renamed into place."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the benchmark's codec cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIBRARY.name + ".", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
                               "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"codec build failed:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.xtc_decode_frame_buf.restype = ctypes.c_int
    lib.xtc_decode_frame_buf.argtypes = [_u8p, ctypes.c_long, _f32p, _f32p, _i32p, _f32p, _f32p]
    lib.xtc_encode_frame.restype = ctypes.c_long
    lib.xtc_encode_frame.argtypes = [_f32p, ctypes.c_int, _f32p, ctypes.c_int32, ctypes.c_float,
                                     ctypes.c_float, ctypes.POINTER(_u8p)]
    lib.xtc_free.restype = None
    lib.xtc_free.argtypes = [_u8p]
    lib.xtc_index.restype = ctypes.c_long
    lib.xtc_index.argtypes = [_u8p, ctypes.c_long, _longp, _i32p, _f32p, ctypes.c_long, _i32p]
    return lib


def _encode(lib, coords: np.ndarray, box9: np.ndarray, step: int, precision: float) -> bytes:
    out = _u8p()
    n = lib.xtc_encode_frame(coords.ctypes.data_as(_f32p), coords.shape[0],
                             box9.ctypes.data_as(_f32p), step, float(step), precision,
                             ctypes.byref(out))
    if n < 0:
        raise RuntimeError("xtc encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.xtc_free(out)


def write_walk(path, coords0: np.ndarray, box_matrix: np.ndarray, n_frames: int, sigma: float,
               seed: int, precision: float = 1000.0, held=None, held_rms: float = 0.0,
               order=None, batch: int = 16, threads: int = 4) -> None:
    """A random walk from ``coords0`` (``molar_tpu_torch/headline.py``'s
    ``write_trajectory``: one normal draw of sigma nm a coordinate a frame,
    in float32, frame k at step k and time k ps), encoded in ``threads``
    threads, written in order. Frame 0 is ``coords0`` itself, so that what a
    program sizes from the first frame is the same for every seed. The rows
    ``held`` (a folded protein) walk bound to their start, ``x_k = x_0 + rho
    (x_{k-1} - x_0) + step``, with rho set so that their spread settles at
    ``held_rms`` nm a coordinate; the other rows (solvent) walk freely.
    ``order`` (a permutation of the frames, 0 first) writes the walk's frames
    in that order. ``box_matrix`` has the box vectors as columns."""
    lib = load()
    rng = np.random.default_rng(seed)
    box9 = np.ascontiguousarray(np.asarray(box_matrix, np.float32).T)
    c0 = np.asarray(coords0, np.float32)
    held = np.zeros(0, np.int64) if held is None else np.asarray(held, np.int64)
    rho = np.float32(np.sqrt(1.0 - (sigma / held_rms) ** 2)) if len(held) else np.float32(1)

    def walk():
        c = c0
        for k in range(n_frames):
            if k:
                step = rng.normal(0, sigma, c.shape).astype(np.float32)
                prev, c = c, c + step
                c[held] = c0[held] + rho * (prev[held] - c0[held]) + step[held]
            yield c

    frames = walk()
    if order is not None:
        walked = list(f.copy() for f in frames)
        frames = (walked[i] for i in order)
    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as pool:
        for start in range(0, n_frames, batch):
            chunk = [next(frames) for _ in range(min(batch, n_frames - start))]
            for blob in pool.map(lambda a: _encode(lib, a[1], box9, start + a[0], precision),
                                 enumerate(chunk)):
                fh.write(blob)


class XtcFile:
    """Random access to the frames of an XTC file: ``n_frames``,
    ``n_atoms``, and ``frame(i) -> (coords (n, 3) f32, box (3, 3) f32 with
    the vectors as columns)``."""

    def __init__(self, path):
        self._lib = load()
        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._data = np.frombuffer(self._mm, dtype=np.uint8)
        size = len(self._mm)
        cap = max(size // 56, 1)
        offsets = np.empty(cap, np.int64)
        steps = np.empty(cap, np.int32)
        times = np.empty(cap, np.float32)
        natoms = ctypes.c_int32(-1)
        n = self._lib.xtc_index(self._data.ctypes.data_as(_u8p), size,
                                offsets.ctypes.data_as(_longp), steps.ctypes.data_as(_i32p),
                                times.ctypes.data_as(_f32p), cap, ctypes.byref(natoms))
        if n <= 0:
            raise ValueError(f"no xtc frames in {path}")
        self.offsets = np.append(offsets[:n], size)
        self.n_frames = int(n)
        self.n_atoms = int(natoms.value)

    def frame(self, i: int):
        off = int(self.offsets[i])
        coords = np.empty((self.n_atoms, 3), np.float32)
        box9 = np.empty(9, np.float32)
        step = ctypes.c_int32()
        t = ctypes.c_float()
        prec = ctypes.c_float()
        n = self._lib.xtc_decode_frame_buf(
            self._data[off:].ctypes.data_as(_u8p), int(self.offsets[i + 1]) - off,
            coords.ctypes.data_as(_f32p), box9.ctypes.data_as(_f32p), ctypes.byref(step),
            ctypes.byref(t), ctypes.byref(prec))
        if n != self.n_atoms:
            raise ValueError(f"frame {i} did not decode")
        return coords, box9.reshape(3, 3).T.copy()

    def close(self) -> None:
        del self._data
        self._mm.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
