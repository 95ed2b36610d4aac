"""Periodic box: triclinic minimum-image, wrapping, box algebra.

The port's copy of ``molar_tpu.core.pbc``. ``PeriodicBox`` is host-side
numpy (column convention: the matrix columns are the box vectors, as in the
reference), vectorized over point arrays; ``PbcDims`` says which axes are
periodic (the selection language's ``pbc yyn``). The free functions
``shortest_vector`` / ``wrap_coords`` take the box as plain numpy arrays.
``wrap_point`` keeps the reference's sign quirk (a negative fractional part
``f`` maps through ``1.0 - f``, periodic_box.rs:409-434);
``wrap_conventional`` is the grid-population wrap ``f - floor(f)``.
``mat3_apply`` is the torch elementwise 3x3 apply; torch tensors never go
through the numpy functions here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

#: Static row count of the padded triclinic correction table.
N_TRIC_CANDIDATES = 26


class PeriodicBoxError(ValueError):
    pass


@dataclass(frozen=True)
class PbcDims:
    """Which of the three dimensions are periodic (``molar_tpu.core.pbc``'s)."""

    x: bool = True
    y: bool = True
    z: bool = True

    @staticmethod
    def from_str(s: str) -> "PbcDims":
        """Parse 'yyn' / '110'-style strings used by the selection language."""
        s = s.strip().lower()
        if len(s) != 3 or any(c not in "yn10" for c in s):
            raise PeriodicBoxError(f"invalid pbc dims string: {s!r}")
        return PbcDims(*(c in "y1" for c in s))

    def as_tuple(self) -> tuple[bool, bool, bool]:
        return (self.x, self.y, self.z)

    def as_array(self) -> np.ndarray:
        return np.array(self.as_tuple(), dtype=bool)

    @property
    def any(self) -> bool:
        return self.x or self.y or self.z

    @property
    def all(self) -> bool:
        return self.x and self.y and self.z


PBC_FULL = PbcDims(True, True, True)
PBC_NONE = PbcDims(False, False, False)


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

    def __init__(self, matrix, angles: Sequence[float] | None = None):
        if angles is not None:
            # pymolar two-arg form: PeriodicBox([a, b, c], [alpha, beta,
            # gamma]) (molar.pyi:61).
            v = np.asarray(matrix, dtype=np.float64)
            ang = np.asarray(angles, dtype=np.float64)
            if v.shape != (3,) or ang.shape != (3,):
                raise PeriodicBoxError("vectors+angles form needs two length-3 sequences")
            matrix = PeriodicBox.from_vectors_angles(*v, *ang).matrix
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

    @staticmethod
    def from_vectors_angles(a: float, b: float, c: float, alpha: float, beta: float,
                            gamma: float) -> "PeriodicBox":
        """Box from lengths (nm) and angles (degrees): alpha = angle(b, c),
        beta = angle(a, c), gamma = angle(a, b); zero lengths and angles
        below 60 degrees are refused (``molar_tpu``'s, in float64)."""
        if a == 0.0 or b == 0.0 or c == 0.0:
            raise PeriodicBoxError("zero length box vector")
        if alpha < 60.0 or beta < 60.0 or gamma < 60.0:
            raise PeriodicBoxError("box angle is < 60 deg")
        m = np.zeros((3, 3), dtype=np.float64)
        m[0, 0] = a
        if alpha != 90.0 or beta != 90.0 or gamma != 90.0:
            cosa = np.cos(np.radians(alpha)) if alpha != 90.0 else 0.0
            cosb = np.cos(np.radians(beta)) if beta != 90.0 else 0.0
            if gamma != 90.0:
                sing, cosg = np.sin(np.radians(gamma)), np.cos(np.radians(gamma))
            else:
                sing, cosg = 1.0, 0.0
            m[0, 1] = b * cosg
            m[1, 1] = b * sing
            m[0, 2] = c * cosb
            m[1, 2] = c * (cosa - cosb * cosg) / sing
            m[2, 2] = np.sqrt(c * c - m[0, 2] ** 2 - m[1, 2] ** 2)
        else:
            m[1, 1] = b
            m[2, 2] = c
        return PeriodicBox(m)

    def to_vectors_angles(self) -> tuple[np.ndarray, np.ndarray]:
        """(lengths, angles in degrees) as float32; 90 degrees for a pair
        with a zero vector."""
        m = self.matrix
        lengths = np.linalg.norm(m, axis=0)
        angles = np.full(3, 90.0)
        for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1))):
            ni, nj = lengths[i], lengths[j]
            if ni * nj != 0.0:
                cosang = float(m[:, i] @ m[:, j]) / float(ni * nj)
                angles[k] = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
        return lengths.astype(np.float32), angles.astype(np.float32)

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

    def shortest_vector(self, vec, pbc: PbcDims = PBC_FULL) -> np.ndarray:
        """Minimum-image displacements of (..., 3) vectors, in float32: the
        fractional round on the periodic axes of ``pbc``, then, under full
        PBC only, the shortest pruned correction where it is strictly
        shorter."""
        v = np.asarray(vec, dtype=np.float32)
        return shortest_vector(v, self.matrix, self.inv, self.corrections, pbc.as_tuple())

    def distance_squared(self, p1, p2, pbc: PbcDims = PBC_FULL):
        d = self.shortest_vector(np.asarray(p2, np.float32) - np.asarray(p1, np.float32), pbc)
        return np.sum(d * d, axis=-1)

    def distance(self, p1, p2, pbc: PbcDims = PBC_FULL):
        return np.sqrt(self.distance_squared(p1, p2, pbc))

    def closest_image(self, point, target, pbc: PbcDims = PBC_FULL) -> np.ndarray:
        t = np.asarray(target, dtype=np.float32)
        return t + self.shortest_vector(np.asarray(point, np.float32) - t, pbc)

    def wrap_point(self, p) -> np.ndarray:
        """Reference-compatible wrap, including its negative-fraction quirk
        (``1.0 - fract`` for fract < 0; periodic_box.rs:409-434)."""
        frac = np.asarray(p, dtype=np.float32) @ self.inv.T
        frac = frac - np.trunc(frac)  # Rust fract(): keeps the sign
        frac = np.where(frac < 0.0, 1.0 - frac, frac)
        return (frac @ self.matrix.T).astype(np.float32)

    def wrap_conventional(self, coords) -> np.ndarray:
        """Wrap into [0,1)^3 fractional (the grid-population wrap)."""
        return wrap_coords(np.asarray(coords, dtype=np.float32), self.matrix, self.inv)

    def to_box_coords(self, vec) -> np.ndarray:
        return np.asarray(vec, dtype=np.float32) @ self.inv.T

    def to_lab_coords(self, vec) -> np.ndarray:
        return np.asarray(vec, dtype=np.float32) @ self.matrix.T

    def is_inside(self, point) -> np.ndarray:
        f = self.to_box_coords(point)
        return np.all((f >= 0.0) & (f < 1.0), axis=-1)

    def lab_extents(self) -> np.ndarray:
        """Per-axis lab-frame extent: row sums of the matrix."""
        return self.matrix.sum(axis=1).astype(np.float32)

    def scale_vectors(self, factors: Sequence[float]) -> "PeriodicBox":
        """A new box with each box vector scaled (functional, unlike the
        reference's in-place periodic_box.rs:393-403)."""
        return PeriodicBox(self.matrix * np.asarray(factors, dtype=np.float32)[None, :])

    # pymolar getter aliases (molar.pyi:66-70)
    def get_matrix(self) -> np.ndarray:
        return self.matrix

    def get_box_extents(self) -> np.ndarray:
        return self.box_extents()

    def get_lab_extents(self) -> np.ndarray:
        return self.lab_extents()

    def padded_corrections(self) -> np.ndarray:
        """(26, 3) corrections, zero-padded, whatever the box kind."""
        out = np.zeros((N_TRIC_CANDIDATES, 3), dtype=np.float32)
        k = self.corrections.shape[0]
        if k:
            out[:k] = self.corrections
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, PeriodicBox) and np.array_equal(self.matrix, other.matrix)

    def __repr__(self) -> str:
        v, a = self.to_vectors_angles()
        return f"PeriodicBox(lengths={v.tolist()}, angles={a.tolist()})"


def shortest_vector(vec, matrix, inv, corrections, pbc_dims=(True, True, True)) -> np.ndarray:
    """Minimum-image displacement(s) of (..., 3) numpy row vectors; the box
    as plain arrays. Triclinic correction applies only under full PBC
    (periodic_box.rs:301-318)."""
    frac = _mat3_np(inv, vec)
    if all(pbc_dims):
        frac = frac - np.round(frac)
    elif any(pbc_dims):
        frac = np.where(np.array(pbc_dims, dtype=bool), frac - np.round(frac), frac)
    start = _mat3_np(matrix, frac)
    if corrections.shape[0] == 0 or not all(pbc_dims):
        return start
    cands = start[..., None, :] + corrections
    n2 = np.sum(cands * cands, axis=-1)
    best = np.argmin(n2, axis=-1)
    cand_best = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    cand_n2 = np.take_along_axis(n2, best[..., None], axis=-1)[..., 0]
    shorter = cand_n2 < np.sum(start * start, axis=-1)
    return np.where(shorter[..., None], cand_best, start)


def wrap_coords(coords, matrix, inv) -> np.ndarray:
    """Conventional wrap into the primary cell: frac -> frac - floor(frac)
    (the distance-search grid's wrap, distance_search.rs:184-189), not the
    ``wrap_point`` quirk."""
    frac = _mat3_np(inv, coords)
    return _mat3_np(matrix, frac - np.floor(frac))


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
