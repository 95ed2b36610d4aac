"""VMD TCL graphics export (reference: molar_membrane/src/vmd_visual.rs).

The port's own copy of ``molar_tpu.membrane.vmd_visual`` (no JAX).

Emits `draw` commands (Angstrom) for spheres/arrows/cylinders; used by
Membrane.write_vmd_visualization to inspect markers, normals, and Voronoi
cells in VMD.
"""

from __future__ import annotations

import numpy as np

_ARROW_LENGTH = 5.0


class VmdVisual:
    def __init__(self):
        self.lines: list[str] = []

    def sphere(self, point, radius: float, color: str) -> None:
        p = np.asarray(point) * 10.0
        self.lines.append(f"draw color {color}")
        self.lines.append(
            f'draw sphere "{p[0]} {p[1]} {p[2]}" radius {radius} resolution 12'
        )

    def arrow(self, point, direction, color: str) -> None:
        p1 = np.asarray(point) * 10.0
        d = np.asarray(direction)
        p2 = p1 + d * 0.5 * _ARROW_LENGTH
        p3 = p1 + d * 0.7 * _ARROW_LENGTH
        self.lines.append(f"draw color {color}")
        self.lines.append(
            f'draw cylinder "{p1[0]} {p1[1]} {p1[2]}" "{p2[0]} {p2[1]} {p2[2]}" '
            "radius 0.2 resolution 12"
        )
        self.lines.append(
            f'draw cone "{p2[0]} {p2[1]} {p2[2]}" "{p3[0]} {p3[1]} {p3[2]}" '
            "radius 0.4 resolution 12"
        )

    def cylinder(self, p1, p2, color: str) -> None:
        a = np.asarray(p1) * 10.0
        b = np.asarray(p2) * 10.0
        self.lines.append(f"draw color {color}")
        self.lines.append(
            f'draw cylinder "{a[0]} {a[1]} {a[2]}" "{b[0]} {b[1]} {b[2]}" '
            "radius 0.1 resolution 12"
        )

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("\n".join(self.lines) + "\n")


class Histogram1D:
    """Fixed-range histogram (reference stats.rs:14-54)."""

    def __init__(self, lo: float, hi: float, n_bins: int):
        self.lo = lo
        self.hi = hi
        self.bins = np.zeros(n_bins)

    def add(self, values) -> None:
        v = np.atleast_1d(np.asarray(values, dtype=np.float64))
        n = len(self.bins)
        b = np.floor(n * (v - self.lo) / (self.hi - self.lo)).astype(np.int64)
        ok = (b >= 0) & (b < n)
        np.add.at(self.bins, b[ok], 1.0)

    add_one = add

    def normalize_density(self) -> None:
        d = (self.hi - self.lo) / len(self.bins)
        total = self.bins.sum() * d
        if total > 0:
            self.bins /= total

    def centers(self) -> np.ndarray:
        d = (self.hi - self.lo) / len(self.bins)
        return self.lo + d * (np.arange(len(self.bins)) + 0.5)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            for c, v in zip(self.centers(), self.bins):
                fh.write(f"{c} {v}\n")
