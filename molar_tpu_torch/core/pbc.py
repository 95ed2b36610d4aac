"""Periodic box: the slice's subset of ``molar_tpu.core.pbc``.

``PeriodicBox`` is host-side numpy (column convention: the matrix columns are
the box vectors, as in the reference). ``mat3_apply`` is the torch
elementwise 3x3 apply; torch tensors never go through ``molar_tpu``'s
numpy/JAX array functions.
"""

from __future__ import annotations

import numpy as np
import torch

#: Static row count of the padded triclinic correction table.
N_TRIC_CANDIDATES = 26


class PeriodicBoxError(ValueError):
    pass


def build_tric_corrections(matrix) -> np.ndarray:
    """Lattice shifts that can shorten a fractionally-reduced displacement.

    Empty (0, 3) for orthogonal boxes. For triclinic boxes: every
    ``i*a + j*b + k*c`` with (i, j, k) in {-1, 0, 1}^3 minus the origin,
    pruned to ``|s| < 2*half_diag`` (half_diag bounds the reduced
    displacement), packed into the first rows of a zero-padded (26, 3)
    table. A zero row is a no-op candidate. Float32 throughout, as
    ``molar_tpu.core.pbc.build_tric_corrections``.
    """
    m = np.asarray(matrix, dtype=np.float32)
    if not (m - np.diag(np.diag(m))).any():
        return np.zeros((0, 3), dtype=np.float32)
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    half_diag = 0.5 * max(
        np.linalg.norm(a + b + c),
        np.linalg.norm(a + b - c),
        np.linalg.norm(a - b + c),
        np.linalg.norm(-a + b + c),
    )
    bound2 = (2.0 * half_diag) ** 2
    out = np.zeros((N_TRIC_CANDIDATES, 3), dtype=np.float32)
    n = 0
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                if i == 0 and j == 0 and k == 0:
                    continue
                s = i * a + j * b + k * c
                if float(s @ s) < bound2:
                    out[n] = s
                    n += 1
    return out


class PeriodicBox:
    """Host-side periodic box over numpy (matrix columns = box vectors)."""

    __slots__ = ("matrix", "inv", "corrections")

    def __init__(self, matrix):
        m = np.array(matrix, dtype=np.float32)
        if m.shape != (3, 3):
            raise PeriodicBoxError(f"box matrix must be 3x3, got {m.shape}")
        if np.any(np.linalg.norm(m, axis=0) == 0.0):
            raise PeriodicBoxError("zero length box vector")
        try:
            inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        except np.linalg.LinAlgError as e:
            raise PeriodicBoxError("box matrix inverse failed") from e
        self.matrix = m
        self.inv = inv
        self.corrections = build_tric_corrections(m)

    @property
    def is_triclinic(self) -> bool:
        return bool((self.matrix - np.diag(np.diag(self.matrix))).any())

    def box_extents(self) -> np.ndarray:
        """Lengths of the three box vectors."""
        return np.linalg.norm(self.matrix, axis=0).astype(np.float32)

    def cell_heights(self) -> np.ndarray:
        """Perpendicular widths ``V / |b_j x b_k|`` of the box along each
        vector, in float64: the thickness a slab of the cell grid has. Equal
        to :meth:`box_extents` for an orthorhombic box, smaller for a skewed
        one."""
        m = self.matrix.astype(np.float64)
        vol = abs(np.linalg.det(m))
        cols = [m[:, 0], m[:, 1], m[:, 2]]
        return np.array([
            vol / np.linalg.norm(np.cross(cols[(i + 1) % 3], cols[(i + 2) % 3]))
            for i in range(3)
        ])

    def shortest_vector(self, vec) -> np.ndarray:
        """Minimum-image displacements of (..., 3) vectors under full PBC,
        in float32 as ``molar_tpu``'s ``PeriodicBox.shortest_vector``: the
        fractional round, then the shortest pruned correction where it is
        strictly shorter."""
        v = np.asarray(vec, dtype=np.float32)
        frac = _mat3_np(self.inv, v)
        start = _mat3_np(self.matrix, frac - np.round(frac))
        if not self.corrections.shape[0]:
            return start
        cands = start[..., None, :] + self.corrections
        n2 = np.sum(cands * cands, axis=-1)
        best = np.argmin(n2, axis=-1)
        cand_best = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
        cand_n2 = np.take_along_axis(n2, best[..., None], axis=-1)[..., 0]
        shorter = cand_n2 < np.sum(start * start, axis=-1)
        return np.where(shorter[..., None], cand_best, start)

    def padded_corrections(self) -> np.ndarray:
        """(26, 3) corrections, zero-padded, whatever the box kind."""
        out = np.zeros((N_TRIC_CANDIDATES, 3), dtype=np.float32)
        k = self.corrections.shape[0]
        if k:
            out[:k] = self.corrections
        return out


def _mat3_np(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """``m @ v`` for (..., 3) numpy row vectors, elementwise."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    return np.stack([m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
                     m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
                     m[2, 0] * x + m[2, 1] * y + m[2, 2] * z], axis=-1)


def mat3_apply(m: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for (..., 3) row vectors, written elementwise (exact f32,
    no matrix-unit rounding; same operation order as ``molar_tpu``)."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    return torch.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        dim=-1,
    )
