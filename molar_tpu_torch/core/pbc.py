"""Periodic box: the slice's subset of ``molar_tpu.core.pbc``.

``PeriodicBox`` is host-side numpy (column convention: the matrix columns are
the box vectors, as in the reference). ``mat3_apply`` is the torch
elementwise 3x3 apply; torch tensors never go through ``molar_tpu``'s
numpy/JAX array functions.
"""

from __future__ import annotations

import numpy as np
import torch


class PeriodicBoxError(ValueError):
    pass


class PeriodicBox:
    """Host-side periodic box over numpy (matrix columns = box vectors)."""

    __slots__ = ("matrix", "inv")

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

    @property
    def is_triclinic(self) -> bool:
        return bool((self.matrix - np.diag(np.diag(self.matrix))).any())

    def box_extents(self) -> np.ndarray:
        """Lengths of the three box vectors."""
        return np.linalg.norm(self.matrix, axis=0).astype(np.float32)


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
