"""The card's form of ``Sel``'s computing calls: plain functions over a
selection's rows on a given device.

:class:`~molar_tpu_torch.core.system.Sel` calls these when its system's
device is a card, and the numpy functions of ``ops/measure_host``,
``ops/neighbor_host`` and ``ops/sasa_host`` (their plain versions, held to
the JAX package's ``Sel``) when it is the CPU. Each function takes numpy
rows, copies only the rows it reads to ``device``, computes there and
returns numpy: the API boundary, where one wait on the device a call is
allowed. The tests run them on CPU tensors.

* **Measures.** The O(n) reductions run on the device in float64 through
  :mod:`~molar_tpu_torch.ops.measure` (``center``, ``center_pbc``,
  ``gyration``, ``inertia_tensor``; ``measure_host`` accumulates in float64
  too). The O(1) tail, the 3x3 SVD of the fit and the inertia
  eigendecomposition, runs on the host with ``measure_host``'s own code once
  the 3x3 has crossed back, so R equals the host's up to rounding in the
  covariance. Horn's 60-step power iteration (``measure.kabsch``) is not
  used: it is not bit-stable on a few percent of frames.
* **within.** An orthorhombic box under full or partial PBC, or no PBC,
  takes :func:`~molar_tpu_torch.ops.neighbor.within_mask_window`: on a card
  one ``cell_bins`` and one ``within_ghost`` launch. The search frame is a
  compiled selection's (``selection/compiled.py``: its grid, its caps, its
  window box, in which each non-periodic axis is binned in the rows' own
  span, so no atom wraps). A skewed full-PBC box takes the correction route
  (plain torch) on a grid from the cell heights; partial PBC in a skewed
  box, whose non-periodic axes are not separable from the lattice, takes
  the host function, as ``FrameSelection`` sends it to its host tier.
* **Pairs.** ``contact_pairs_dense`` up to ``DENSE_LIMIT`` candidates, the
  grid ``contact_pairs`` above; distances of the pairs found are taken
  again in float64 from the rows as given, and sorted by (i, j).
* **SASA.** ``sasa_lr.neighbor_lists_device`` then ``sasa_lr.sasa``, in
  float64; the volume is ``sasa_host.total_volume``'s voxel test in torch,
  the same float64 operations a voxel, so the same count.

Capacities come from the compiled selection's occupancy estimate
(:func:`~molar_tpu_torch.selection.compiled.search_caps`). A search whose
overflow flag is set is never read: it runs again at the next of its
capacity tiers (:func:`~molar_tpu_torch.selection.compiled.over_tiers`,
caps x2, then x4).
In-place edits of a selection (``translate``, ``rotate``,
``apply_transform``, ``wrap``, ``unwrap_simple``) stay numpy writes into
the host state, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import measure, measure_host, neighbor, neighbor_host, sasa_lr
from ..selection import compiled
from .pbc import PBC_NONE, PbcDims, PeriodicBox

__all__ = ["min_max", "center", "center_pbc", "gyration", "inertia_tensor", "inertia",
           "principal_transform", "rmsd", "rmsd_mw", "fit_transform", "within",
           "search_pairs", "sort_pairs", "sasa", "total_volume"]

# First pair-list capacity of a pair search; a longer list runs again at the
# count the search reported.
_MAX_PAIRS0 = 1 << 16
# Neighbour-list width of a SASA call at the first capacity tier.
_SASA_K0 = 96
# Elements of one (atoms, x, y, z) block of the voxel volume.
_VOLUME_BLOCK = 1 << 24


def _tensor(a, device, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _weights(w) -> np.ndarray:
    """Masses as float64, raising on a zero total (``measure_host``'s rule)."""
    w = np.asarray(w, np.float64)
    if w.sum() == 0.0:
        raise measure_host.MeasureError("zero total mass")
    return w


def _box(box: PeriodicBox, pbc: PbcDims, device):
    """(box, inverse, corrections or None) as float64 tensors; the
    corrections only under full PBC in a skewed box, as the host's."""
    corr = None
    if pbc.all and box.corrections.shape[0]:
        corr = _tensor(box.corrections, device)
    return _tensor(box.matrix, device), _tensor(box.inv, device), corr


def _numpy(*tensors) -> np.ndarray:
    """Flattened float64 tensors read back in one copy."""
    return torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()


# -- measures ------------------------------------------------------------------


def min_max(coords, device) -> tuple[np.ndarray, np.ndarray]:
    c = _tensor(coords, device, torch.float32)
    out = torch.stack([c.amin(0), c.amax(0)]).cpu().numpy()
    return out[0], out[1]


def center(coords, weights, device) -> np.ndarray:
    """COM (``weights`` the masses) or COG (None)."""
    w = None if weights is None else _tensor(_weights(weights), device)
    return _numpy(measure.center(_tensor(coords, device), w))


def center_pbc(coords, weights, box: PeriodicBox, pbc: PbcDims, device) -> np.ndarray:
    """Closest images relative to the first atom, then the average."""
    w = None if weights is None else _tensor(_weights(weights), device)
    b, i, corr = _box(box, pbc, device)
    return _numpy(measure.center_pbc(_tensor(coords, device), w, b, i, corr, pbc.as_tuple()))


def gyration(coords, masses, box: Optional[PeriodicBox], pbc: PbcDims, device) -> float:
    c, m = _tensor(coords, device), _tensor(_weights(masses), device)
    if box is None:
        return float(measure.gyration(c, m))
    return float(measure.gyration(c, m, *_box(box, pbc, device), pbc.as_tuple()))


def inertia_tensor(coords, masses, box: Optional[PeriodicBox], pbc: PbcDims, device):
    """(tensor 3x3, com) about the (PBC) centre of mass, as numpy."""
    c, m = _tensor(coords, device), _tensor(_weights(masses), device)
    if box is None:
        t, com = measure.inertia_tensor(c, m)
    else:
        t, com = measure.inertia_tensor(c, m, *_box(box, pbc, device), pbc.as_tuple())
    out = _numpy(t, com)
    return out[:9].reshape(3, 3), out[9:]


def inertia(coords, masses, box: Optional[PeriodicBox], pbc: PbcDims, device):
    """(moments ascending, right-handed axes as columns, com); the
    eigendecomposition on the host."""
    return measure_host.inertia_axes(*inertia_tensor(coords, masses, box, pbc, device))


def principal_transform(coords, masses, box: Optional[PeriodicBox], pbc: PbcDims, device):
    _, axes, com = inertia(coords, masses, box, pbc, device)
    return measure_host.principal_from_axes(axes, com)


def _same_shape(coords1, coords2, what: str) -> None:
    if np.shape(coords1) != np.shape(coords2):
        raise measure_host.MeasureError(f"{what} requires selections of equal size")


def rmsd(coords1, coords2, device) -> float:
    _same_shape(coords1, coords2, "rmsd")
    return float(measure.rmsd(_tensor(coords1, device), _tensor(coords2, device)))


def rmsd_mw(coords1, coords2, masses1, device) -> float:
    _same_shape(coords1, coords2, "rmsd")
    m = _tensor(_weights(masses1), device)
    return float(measure.rmsd_mw(_tensor(coords1, device), _tensor(coords2, device), m))


def fit_transform(coords1, coords2, masses1, device) -> tuple[np.ndarray, np.ndarray]:
    """(R, t): x -> R x + t superimposing ``coords1`` onto ``coords2``,
    mass-weighted by ``masses1``. The centres and the covariance ``sum m p2
    p1^T`` on the device, the SVD on the host."""
    _same_shape(coords1, coords2, "fit")
    a, b = _tensor(coords1, device), _tensor(coords2, device)
    m = _tensor(_weights(masses1), device)
    cm1, cm2 = measure.center(a, m), measure.center(b, m)
    cov = torch.einsum("n,ni,nj->ij", m, b - cm2, a - cm1)
    out = _numpy(cov, cm1, cm2)
    r = measure_host.rotation_from_covariance(out[:9].reshape(3, 3))
    return r, out[12:] - r @ out[9:12]


# -- searches ------------------------------------------------------------------


def _periodic(box: Optional[PeriodicBox], pbc: PbcDims) -> tuple[bool, bool, bool]:
    return pbc.as_tuple() if box is not None and pbc.any else (False, False, False)


def _search_frame(rows: np.ndarray, cutoff: float, box: Optional[PeriodicBox], per, n_src: int,
                  device):
    """The frame a search over ``rows`` (float32; the first ``n_src`` the
    sources, the rest the targets) bins in, as a compiled selection's
    ``within`` builds it: :func:`~molar_tpu_torch.selection.compiled.search_grid`'s
    grid, :func:`~molar_tpu_torch.selection.compiled.search_caps`' caps, the
    box on a periodic axis and the rows' own window box on a non-periodic
    one (:func:`~molar_tpu_torch.selection.compiled.window_box`) -> (dims,
    cap, tgt_cap, coords (1, n, 3), boxes (1, 3, 3), invs (1, 3, 3)) on
    ``device``."""
    dims, span = compiled.search_grid(rows, cutoff, box, per)
    cap, tgt_cap = compiled.search_caps(rows, dims, per, box, np.arange(len(rows)),
                                        np.arange(n_src, len(rows)))
    eye = np.eye(3, dtype=np.float32)
    c = _tensor(rows, device, torch.float32)[None]
    b = _tensor(eye if box is None else box.matrix, device, torch.float32)[None]
    i = _tensor(eye if box is None else box.inv, device, torch.float32)[None]
    if not all(per):
        c, b, i = compiled.window_box(c, b, i, _tensor(span, device, torch.float32), per)
    return dims, cap, tgt_cap, c, b, i


def _corrections(box: Optional[PeriodicBox], per, device):
    """A skewed full-PBC box's (26, 3) correction candidates, else None."""
    if all(per) and box.is_triclinic:
        return _tensor(box.padded_corrections(), device, torch.float32)
    return None


def within(cutoff: float, coords, src_idx, tgt_idx, box: Optional[PeriodicBox],
           pbc: PbcDims, device) -> np.ndarray:
    """Sorted members of ``src_idx`` with a member of ``tgt_idx`` within
    ``cutoff`` (inclusive; an atom in both sets finds itself at d = 0).
    ``coords`` (N, 3) is the host array both index sets point into; only
    their rows go to the device."""
    per = _periodic(box, pbc)
    src_idx = np.asarray(src_idx, np.int64)
    tgt_idx = np.asarray(tgt_idx, np.int64)
    if any(per) and box.is_triclinic and not all(per):
        return neighbor_host.search_within(cutoff, coords, src_idx, tgt_idx, box, pbc)
    if not len(src_idx) or not len(tgt_idx):
        return np.empty(0, np.int64)
    ns = len(src_idx)
    rows = np.concatenate([coords[src_idx], coords[tgt_idx]]).astype(np.float32)
    dims, cap, tcap, c, b, i = _search_frame(rows, cutoff, box, per, ns, device)
    corr = _corrections(box, per, device)
    src = torch.arange(ns, device=device)
    tgt = torch.arange(ns, len(rows), device=device)

    def attempt(_tier, scale):
        if corr is None:
            masks, ofl = neighbor.within_mask_window(c, src, tgt, cutoff, b, i, dims,
                                                     cap * scale, tcap * scale, per)
            mask, ofl = masks[0], ofl[0]
        else:
            mask, ofl = neighbor.within_mask(c[0], src, tgt, cutoff, b[0], i[0],
                                             corrections=corr, dims=dims, cap=cap * scale,
                                             pbc=per, tgt_cap=tcap * scale)
        out = torch.cat([mask, ofl.reshape(1)]).cpu().numpy()
        return None if out[ns] else np.sort(src_idx[out[:ns]])

    return compiled.over_tiers(attempt, f"within {cutoff}")


def search_pairs(cutoff, coords, idx1, idx2=None, box: Optional[PeriodicBox] = None,
                 pbc: PbcDims = PBC_NONE, vdw=None, device=None):
    """All pairs within ``cutoff``, the contract of
    :func:`~molar_tpu_torch.ops.neighbor_host.search_pairs`: one set
    (``idx2`` None: each pair once, i before j, no self pairs) or two;
    ``vdw`` per-atom radii make the per-pair cutoff ``vdw_i + vdw_j +
    1e-6`` (``cutoff`` then sizes the grid). Returns ``(pairs (K, 2) global
    indices, sorted by (i, j), distances (K,) float32)``."""
    per = _periodic(box, pbc)
    idx1 = np.asarray(idx1, np.int64)
    idx2a = idx1 if idx2 is None else np.asarray(idx2, np.int64)
    if any(per) and box.is_triclinic and not all(per):
        return sort_pairs(*neighbor_host.search_pairs(cutoff, coords, idx1, idx2, box, pbc,
                                                      vdw=vdw))
    if not len(idx1) or not len(idx2a):
        return np.empty((0, 2), np.int64), np.empty(0, np.float32)
    n1 = len(idx1)
    given = np.concatenate([coords[idx1], coords[idx2a]]).astype(np.float32)
    dims, _, tcap, c, b, i = _search_frame(given, float(cutoff), box, per, n1, device)
    c, b, i, corr = c[0], b[0], i[0], _corrections(box, per, device)
    src = torch.arange(n1, device=device)
    tgt = torch.arange(n1, len(given), device=device)
    dense = n1 * len(idx2a) <= neighbor.DENSE_LIMIT
    max_pairs = _MAX_PAIRS0

    def attempt(_tier, scale):
        nonlocal max_pairs
        while True:
            if dense:
                pairs, _, count, ofl = neighbor.contact_pairs_dense(
                    c, src, tgt, cutoff, b, i, corr, max_pairs=max_pairs, pbc=per)
            else:
                pairs, _, count, ofl = neighbor.contact_pairs(
                    c, src, tgt, cutoff, b, i, corr, dims, tcap * scale, max_pairs, per)
            k, flagged = torch.stack([count.to(torch.int64), ofl.to(torch.int64)]).tolist()
            if not flagged:
                return pairs[:k]
            if k <= max_pairs:  # the list held every pair: the cell table overflowed
                return None
            # The list was short; the count is exact unless the table overflowed too.
            max_pairs = (k + 1023) // 1024 * 1024

    pairs = compiled.over_tiers(attempt, f"pair search {cutoff}")
    # The pairs found, their distances again in float64 from the rows as given.
    pos = pairs.long()
    pi, pj = pos[:, 0], pos[:, 1] - n1
    g = _tensor(given, device)
    d = g[n1 + pj] - g[pi]
    if any(per):
        bb, ii, cc = _box(box, pbc, device)
        d = measure.min_image(d, bb, ii, cc, per)
    out = torch.stack([pi.double(), pj.double(), (d * d).sum(dim=-1)], 1).cpu().numpy()
    pi, pj, d2 = out[:, 0].astype(np.int64), out[:, 1].astype(np.int64), out[:, 2]
    keep = np.ones(len(pi), bool) if idx2 is not None else pi < pj
    if vdw is not None:
        r = vdw[idx1[pi]].astype(np.float64) + vdw[idx2a[pj]] + neighbor_host._EPS
        keep &= d2 <= r * r
    gi, gj = idx1[pi[keep]], idx2a[pj[keep]]
    return sort_pairs(np.stack([gi, gj], axis=1), np.sqrt(d2[keep]).astype(np.float32))


def sort_pairs(pairs: np.ndarray, dist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A pair list and its distances in (i, j) order: the order
    ``distance_search`` returns on every device."""
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order], dist[order]


# -- SASA ----------------------------------------------------------------------


def sasa(coords, vdw, probe: float, n_slices: int, device) -> np.ndarray:
    """Per-atom exact Lee-Richards areas (nm^2, float64), the host's
    slicing: neighbour lists built on the device (``|xi - xj| < ri + rj``),
    then the interval unions, both in float64. The cell table and the
    lists' width grow by the capacity tiers on overflow."""
    c64 = np.asarray(coords, np.float64)
    radii = np.asarray(vdw, np.float64) + probe
    n = len(c64)
    if n == 0:
        return np.zeros(0)
    shifted = c64 - c64.min(axis=0)  # exact: differences of float32 values in float64
    no_pbc = (False, False, False)
    dims, _ = compiled.search_grid(shifted, 2 * float(radii.max()), None, no_pbc)
    ext = tuple(float(v) for v in shifted.max(axis=0) + compiled.SPAN_PAD)
    cell_cap, = compiled.search_caps(shifted, dims, no_pbc, None, np.arange(n))
    c, r = _tensor(shifted, device), _tensor(radii, device)

    def attempt(_tier, scale):
        nbr, ofl = sasa_lr.neighbor_lists_device(c, r, ext, dims, min(cell_cap * scale, n),
                                                 min(_SASA_K0 * scale, max(n - 1, 1)))
        return None if bool(ofl) else sasa_lr.sasa(c, r, nbr, n_slices=n_slices).cpu().numpy()

    return compiled.over_tiers(attempt, "sasa's neighbour lists")


def total_volume(coords, vdw, probe: float, device) -> float:
    """Volume (nm^3) of the union of the solvent-expanded spheres:
    ``sasa_host.total_volume``'s grid (its voxel coordinates from the same
    ``np.arange``) and its float64 test ``(dx^2 + dy^2) + dz^2 <= r^2`` a
    voxel, on the device in blocks of atoms, so the same voxel count."""
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(vdw, np.float64) + probe
    if len(coords) == 0:
        return 0.0
    lo = (coords - radii[:, None]).min(axis=0)
    hi = (coords + radii[:, None]).max(axis=0)
    res = max((hi - lo).max() / 120, 1e-3)
    axes = [_tensor(np.arange(lo[a], hi[a] + res, res), device) for a in range(3)]
    gx, gy, gz = axes[0][:, None, None], axes[1][None, :, None], axes[2][None, None, :]
    inside = torch.zeros((len(axes[0]), len(axes[1]), len(axes[2])), dtype=torch.bool,
                         device=device)
    c, r = _tensor(coords, device), _tensor(radii, device)
    step = max(1, _VOLUME_BLOCK // inside.numel())
    for s in range(0, len(coords), step):
        cx, cy, cz = (c[s:s + step, a, None, None, None] for a in range(3))
        dx, dy, dz = gx[None] - cx, gy[None] - cy, gz[None] - cz
        d2 = (dx * dx + dy * dy) + dz * dz
        rr = r[s:s + step, None, None, None]
        inside |= (d2 <= rr * rr).any(dim=0)
    return float(int(inside.sum())) * res**3
