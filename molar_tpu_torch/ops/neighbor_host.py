"""Host (numpy) cell-grid distance search.

Reference semantics (molar/src/distance_search.rs):

* grid dims per axis = ``max(floor(extent/cutoff), 1)`` (distance_search.rs:103-114);
  for periodic dims the extent is the box, points are wrapped in; for
  non-periodic dims the extent is min/max +- (cutoff + eps) of the searched
  points, and out-of-extent points are silently dropped (:134-171);
* distances are *minimum-image* in the periodic dims; cutoff test is inclusive
  ``d^2 <= cutoff^2`` (:287,316);
* ``within``-style search returns members of set 1 having >= 1 partner in
  set 2; pair search returns (i, j[, d]) pairs.

This module is the *host* implementation: plain vectorized numpy, chunked to
bound memory. It doubles as the ground truth the jitted TPU kernels
(:mod:`molar_tpu.ops.neighbor`) are tested against. The algorithm is the
bucketed form of the reference's cell grid: points are binned to cells, cells
are materialized as a fixed-capacity (n_cells, cap) index matrix, and each
query atom scans the 27-cell neighborhood.

The port's own copy of ``molar_tpu.ops.neighbor_host`` (numpy only), the
ground truth of the selection language's host tier, with one repair: a
skewed box's grid is sized by its cell heights. On orthorhombic boxes it
equals the JAX package's; on skewed ones it equals a float64 brute force
over the lattice images, where the JAX package's misses atoms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.pbc import PBC_FULL, PBC_NONE, PbcDims, PeriodicBox

_EPS = 1e-6


def _grid_dims_and_frac(
    coords: np.ndarray,
    cutoff: float,
    box: Optional[PeriodicBox],
    pbc: PbcDims,
    extents_lo: np.ndarray,
    extents_hi: np.ndarray,
):
    """Per-axis cell counts plus each point's fractional grid position.

    Periodic axes use box-fractional coords wrapped to [0,1); non-periodic axes
    use (x - lo) / (hi - lo). Returns (dims[3], frac (N,3), valid (N,))."""
    n = coords.shape[0]
    frac = np.empty((n, 3), dtype=np.float64)
    dims = np.empty(3, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    if box is not None and pbc.any:
        bf = coords.astype(np.float64) @ box.inv.T.astype(np.float64)
    else:
        bf = None
    # Cell heights, not vector lengths: a skewed box's slab of length / n is
    # thinner than the cutoff, and the +-1 stencil then misses pairs two
    # cells apart (the JAX package's grid has that fault).
    heights = None
    if box is not None:
        heights = box.cell_heights() if box.is_triclinic else box.box_extents()
    for d in range(3):
        if pbc.as_tuple()[d]:
            # Periodic axis: wrap into [0,1). Slabs at least one cutoff thick.
            f = bf[:, d] - np.floor(bf[:, d])
            frac[:, d] = f
            dims[d] = max(int(np.floor(float(heights[d]) / cutoff)), 1)
        else:
            lo, hi = float(extents_lo[d]), float(extents_hi[d])
            span = hi - lo
            if span <= 0:
                span = 1.0
            f = (coords[:, d].astype(np.float64) - lo) / span
            frac[:, d] = f
            # Out-of-extent points along non-periodic dims are dropped
            # (distance_search.rs:134-171).
            valid &= (f >= 0.0) & (f < 1.0)
            dims[d] = max(int(np.floor(span / cutoff)), 1)
    return dims, frac, valid


def _bucket(frac: np.ndarray, dims: np.ndarray, valid: np.ndarray):
    """Cell index triple and flat id per point (invalid points get id -1)."""
    cell = np.minimum((frac * dims).astype(np.int64), dims - 1)
    cell = np.maximum(cell, 0)
    flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    flat = np.where(valid, flat, -1)
    return cell, flat


class _CellTable:
    """Fixed-capacity cell -> member-index table."""

    def __init__(self, flat: np.ndarray, n_cells: int):
        order = np.argsort(flat, kind="stable")
        sorted_flat = flat[order]
        first_valid = np.searchsorted(sorted_flat, 0)
        self.order = order[first_valid:]
        self.sorted_flat = sorted_flat[first_valid:]
        self.starts = np.searchsorted(self.sorted_flat, np.arange(n_cells + 1))

    def members(self, cell_ids: np.ndarray, cap: int) -> np.ndarray:
        """(len(cell_ids), cap) member matrix, padded with -1."""
        s = self.starts[cell_ids]
        e = self.starts[cell_ids + 1]
        counts = e - s
        out = np.full((len(cell_ids), cap), -1, dtype=np.int64)
        k = np.arange(cap)
        take = s[:, None] + k[None, :]
        ok = k[None, :] < counts[:, None]
        out[ok] = self.order[take[ok]]
        return out

    @property
    def max_count(self) -> int:
        if len(self.starts) <= 1:
            return 0
        return int(np.max(np.diff(self.starts)))


def _neighbor_cells(cell: np.ndarray, dims: np.ndarray, pbc: PbcDims):
    """(N, 27) flat neighbor-cell ids; -1 where out of range (non-periodic)."""
    offs = np.array(
        [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        dtype=np.int64,
    )
    nb = cell[:, None, :] + offs[None, :, :]  # (N, 27, 3)
    ok = np.ones(nb.shape[:2], dtype=bool)
    for d in range(3):
        if pbc.as_tuple()[d] and dims[d] > 1:
            nb[:, :, d] %= dims[d]
        elif pbc.as_tuple()[d]:
            nb[:, :, d] = 0
        else:
            ok &= (nb[:, :, d] >= 0) & (nb[:, :, d] < dims[d])
            nb[:, :, d] = np.clip(nb[:, :, d], 0, dims[d] - 1)
    flat = (nb[:, :, 0] * dims[1] + nb[:, :, 1]) * dims[2] + nb[:, :, 2]
    # Small periodic grids (dim <= 2) alias neighbor offsets to the same cell;
    # dedupe to avoid double-counting pairs.
    flat = np.where(ok, flat, -1)
    sorted_flat = np.sort(flat, axis=1)
    dup = np.zeros_like(sorted_flat, dtype=bool)
    dup[:, 1:] = sorted_flat[:, 1:] == sorted_flat[:, :-1]
    sorted_flat[dup] = -1
    return sorted_flat


def _min_image_d2(
    d: np.ndarray, box: Optional[PeriodicBox], pbc: PbcDims
) -> np.ndarray:
    if box is not None and pbc.any:
        sv = box.shortest_vector(d.astype(FLOAT), pbc)
        return np.sum(sv.astype(np.float64) ** 2, axis=-1)
    return np.sum(d.astype(np.float64) ** 2, axis=-1)


def search_within(
    cutoff: float,
    coords: np.ndarray,
    src_idx: np.ndarray,
    target_idx_or_point,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_NONE,
    chunk: int = 8192,
) -> np.ndarray:
    """Indices (subset of ``src_idx``, sorted) with >= 1 partner within cutoff.

    ``target_idx_or_point`` is either an index array into ``coords`` or a
    single (3,) point. The cutoff test is inclusive (d^2 <= cutoff^2).
    """
    src_idx = np.asarray(src_idx, dtype=np.int64)
    if np.ndim(target_idx_or_point) == 1 and np.asarray(target_idx_or_point).dtype.kind == "f":
        tgt_coords = np.asarray(target_idx_or_point, dtype=FLOAT)[None, :]
        tgt_idx = None
    else:
        tgt_idx = np.asarray(target_idx_or_point, dtype=np.int64)
        tgt_coords = coords[tgt_idx]
    src_coords = coords[src_idx]

    if len(src_idx) == 0 or len(tgt_coords) == 0:
        return np.empty(0, dtype=np.int64)

    use_pbc = box is not None and pbc.any
    if not use_pbc:
        from scipy.spatial import cKDTree

        tree = cKDTree(tgt_coords.astype(np.float64))
        dmin, _ = tree.query(src_coords.astype(np.float64), k=1)
        hit = dmin * dmin <= float(cutoff) ** 2 + 0.0
        return np.sort(src_idx[hit])

    # Periodic path: cell grid over wrapped points.
    lo = src_coords.min(axis=0)
    hi = src_coords.max(axis=0)
    lo = lo - (cutoff + _EPS)
    hi = hi + (cutoff + _EPS)
    dims, tfrac, tvalid = _grid_dims_and_frac(tgt_coords, cutoff, box, pbc, lo, hi)
    _, tflat = _bucket(tfrac, dims, tvalid)
    n_cells = int(np.prod(dims))
    table = _CellTable(tflat, n_cells)
    cap = max(table.max_count, 1)

    _, sfrac, svalid = _grid_dims_and_frac(src_coords, cutoff, box, pbc, lo, hi)
    scell, _ = _bucket(sfrac, dims, svalid)

    c2 = float(cutoff) ** 2
    hits = np.zeros(len(src_idx), dtype=bool)
    for start in range(0, len(src_idx), chunk):
        sl = slice(start, min(start + chunk, len(src_idx)))
        nb = _neighbor_cells(scell[sl], dims, pbc)  # (B, 27)
        ok_cell = nb >= 0
        members = table.members(np.maximum(nb, 0).ravel(), cap).reshape(
            nb.shape[0], -1
        )  # (B, 27*cap)
        members[~np.repeat(ok_cell, cap, axis=1)] = -1
        valid_m = members >= 0
        cand = np.maximum(members, 0)
        d = tgt_coords[cand] - src_coords[sl][:, None, :]
        d2 = _min_image_d2(d, box, pbc)
        # NOTE: no self-exclusion — an atom present in both sets matches itself
        # at d=0, so plain `within` includes the inner selection (VMD-compatible;
        # reference search_cell_pair_within has no index check,
        # distance_search.rs:271-293).
        within = valid_m & (d2 <= c2)
        hits[sl] = within.any(axis=1) & svalid[sl]
    return np.sort(src_idx[hits])


def search_pairs(
    cutoff,
    coords: np.ndarray,
    idx1: np.ndarray,
    idx2: Optional[np.ndarray] = None,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_NONE,
    vdw: Optional[np.ndarray] = None,
    chunk: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs within cutoff: double (set1 x set2) or single (set1 x itself).

    Returns ``(pairs (K,2) of global indices, distances (K,))``. For the
    single-grid variant pairs are emitted once with ``i < j`` by position.
    ``vdw``: per-atom radii; when given, the per-pair cutoff is
    ``vdw[i] + vdw[j] + eps`` and ``cutoff`` is used only for the grid cell
    size (pass the max possible pair cutoff).
    """
    idx1 = np.asarray(idx1, dtype=np.int64)
    single = idx2 is None
    idx2_arr = idx1 if single else np.asarray(idx2, dtype=np.int64)
    c1 = coords[idx1]
    c2 = coords[idx2_arr]
    if len(idx1) == 0 or len(idx2_arr) == 0:
        return np.empty((0, 2), np.int64), np.empty(0, FLOAT)

    both = np.concatenate([c1, c2], axis=0)
    lo = both.min(axis=0) - (cutoff + _EPS)
    hi = both.max(axis=0) + (cutoff + _EPS)
    dims, tfrac, tvalid = _grid_dims_and_frac(c2, cutoff, box, pbc, lo, hi)
    _, tflat = _bucket(tfrac, dims, tvalid)
    n_cells = int(np.prod(dims))
    table = _CellTable(tflat, n_cells)
    cap = max(table.max_count, 1)
    _, sfrac, svalid = _grid_dims_and_frac(c1, cutoff, box, pbc, lo, hi)
    scell, _ = _bucket(sfrac, dims, svalid)

    c2cut = float(cutoff) ** 2
    out_pairs = []
    out_d = []
    for start in range(0, len(idx1), chunk):
        sl = slice(start, min(start + chunk, len(idx1)))
        nb = _neighbor_cells(scell[sl], dims, pbc)
        ok_cell = nb >= 0
        members = table.members(np.maximum(nb, 0).ravel(), cap).reshape(nb.shape[0], -1)
        members[~np.repeat(ok_cell, cap, axis=1)] = -1
        valid_m = (members >= 0) & svalid[sl][:, None]
        cand = np.maximum(members, 0)
        d = c2[cand] - c1[sl][:, None, :]
        d2 = _min_image_d2(d, box, pbc)
        if vdw is not None:
            r = vdw[idx1[sl]][:, None] + vdw[idx2_arr[cand]] + _EPS
            within = valid_m & (d2 <= r * r)
        else:
            within = valid_m & (d2 <= c2cut)
        ii, jj = np.nonzero(within)
        gi = idx1[sl][ii]
        pos2 = cand[ii, jj]
        gj = idx2_arr[pos2]
        if single:
            keep = (start + ii) < pos2  # emit each pair once, no self-pairs
            gi, gj = gi[keep], gj[keep]
            dk = d2[ii, jj][keep]
        else:
            dk = d2[ii, jj]
        out_pairs.append(np.stack([gi, gj], axis=1))
        out_d.append(np.sqrt(dk))
    pairs = np.concatenate(out_pairs) if out_pairs else np.empty((0, 2), np.int64)
    dist = np.concatenate(out_d).astype(FLOAT) if out_d else np.empty(0, FLOAT)
    return pairs, dist
