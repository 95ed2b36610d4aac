"""Streaming trajectory conversion (trjconv): XTC -> selection -> DCD.

The counterpart of ``molar_tpu.io.trjconv`` and of the reference's trjconv
workload (molar/benches/comparison_small.rs:44-57): stream an XTC and write
a selection to DCD frame by frame. Host work by design, in both packages:
no byte of it goes through the card. Three things make it fast:

* the prefix decode: only atoms ``[0, max(selection)+1)`` of a frame are
  decoded (:meth:`XtcHandler.decode_prefix`), so a protein selection of a
  protein-first topology skips the solvent tail;
* raw ``(step, time, box9)`` tuples, no per-frame ``State``/``PeriodicBox``;
* one buffered write a frame (:meth:`DcdHandler.write_frame_raw`), and a
  slice in place of a gather for a contiguous selection.

The output is byte-identical to ``molar_tpu.io.trjconv``'s. Coordinates are
those of the per-frame ``DcdHandler.write`` path; the unit-cell record is
computed from the vectors' cosines (exact for an orthorhombic cell, where
``write``'s angle round trip leaves a ~3e-7 residue).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dcd import DcdHandler
from .xtc import XtcHandler


def _cell6_from_box9(box9: np.ndarray) -> np.ndarray:
    """DCD unit-cell record [A, cos g, B, cos b, cos a, C] (Angstrom) from
    the XTC header's row-major box rows (nm). Zero box -> zero record."""
    m = np.asarray(box9, np.float64).reshape(3, 3)  # rows are box vectors
    if not m.any():
        return np.zeros(6)
    ln = np.sqrt((m * m).sum(1))

    def cosang(i: int, j: int) -> float:
        d = ln[i] * ln[j]
        return float(m[i] @ m[j] / d) if d else 0.0

    return np.array([
        ln[0] * 10.0, cosang(0, 1), ln[1] * 10.0,
        cosang(0, 2), cosang(1, 2), ln[2] * 10.0,
    ])


def trjconv(
    src: str,
    dst: str,
    indices: Optional[np.ndarray] = None,
    *,
    first: int = 0,
    last: Optional[int] = None,
    step: int = 1,
) -> int:
    """Stream ``src`` (XTC) and write the ``indices`` rows (None: all) to
    ``dst`` (DCD) -> the number of frames written. ``first``/``last``/``step``
    subset the frames (``last`` exclusive; None: to the end)."""
    with XtcHandler(src) as r:
        idx = (np.arange(r.n_atoms, dtype=np.int64) if indices is None
               else np.asarray(indices, dtype=np.int64))
        if idx.size == 0:
            raise ValueError("trjconv: empty selection")
        if idx.min() < 0 or idx.max() >= r.n_atoms:
            raise ValueError(f"trjconv: selection indices out of range 0..{r.n_atoms - 1}")
        n_want = int(idx.max()) + 1
        stop = r.n_frames if last is None else min(last, r.n_frames)
        s0 = int(idx[0])
        contig = bool(np.array_equal(idx, np.arange(s0, s0 + idx.size, dtype=np.int64)))
        buf = np.empty((n_want + XtcHandler.PREFIX_SLACK, 3), np.float32)
        xyz = np.empty((3, idx.size), np.float32)
        # nm -> Angstrom: an f32 product equals DcdHandler.write's f64 round
        # trip bit for bit (both correctly rounded from the same f32 value).
        ten = np.float32(10.0)
        n = 0
        with DcdHandler(dst, "w") as w:
            for k in range(first, stop, step):
                coords, _, _, box9 = r.decode_prefix(k, n_want, buf)
                sel = coords[s0: s0 + idx.size] if contig else coords[idx]
                np.multiply(sel.T, ten, out=xyz)
                w.write_frame_raw(xyz, _cell6_from_box9(box9))
                n += 1
        return n
