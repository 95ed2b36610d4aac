"""Cell-grid ``within`` search and contact lists with periodic images, in torch.

Counterpart of ``molar_tpu.ops.neighbor``: points are wrapped into the unit
cell and bucketed into fixed-capacity cells. ``within_mask`` has two
regimes, as in the JAX package:

* ``corrections is None`` — the ghost-slab search, for a window of frames
  (:func:`within_mask_window`; :func:`within_mask` is its one-frame form).
  On CUDA tensors it is two hand-written kernels
  (:mod:`.neighbor_ghost`): a counting-sort binning of every frame into
  cell records, then a 27-cell stencil that shifts the neighbour cells'
  targets into their periodic images as it stages them and writes the
  mask through the sources' list positions. On CPU tensors, and with
  ``plain=True`` on any device (the reference the kernels are held against
  on the card), it runs the plain twin frame by frame: ``(n_cells, cap)``
  structure-of-arrays planes (stable argsort + rank in run + scatter),
  ghost-padded ``(nx+2, ny+2, nz+2, tgt_cap)`` target planes whose border
  cells hold pre-shifted images (pad slots are +-1e17 sentinels), the
  stencil over them and the unsort — the JAX package's own steps.
* ``corrections`` given — the per-pair min-image path of skewed boxes:
  inverse transform, round, forward transform, then the running minimum
  over the triclinic correction candidates, with validity planes (a
  sentinel would round back to d ~ 0). Dense (every cell against its 27
  neighbours) or, with ``max_tgt_cells``, sparse (the occupied target cells
  only, hits scattered back into the source cells). Plain torch on every
  device; the occupied-cell list is compacted without a host sync.

Static-shape contract as in the JAX package: ``dims``/``cap``/``tgt_cap``
(and ``max_tgt_cells``) are fixed, the search returns an overflow flag, and
when the flag is set the mask is UNDEFINED (clipped ranks make duplicate
scatter slots) — callers retry at a larger capacity.

A skewed box's grid is sized from its perpendicular cell heights
(:func:`grid_dims_for`), not from its vector lengths: a slab of
``length / n`` is thinner than the cutoff when the box is skewed, and the
+-1 stencil then misses pairs two cells apart. On the height-sized grid a
displacement within the cutoff moves each fractional coordinate by at most
one cell, so every in-cutoff image is a +-1-cell lattice shift and the
ghost-slab search is exact on a skewed box too; the correction path stays
the plain reference of skewed boxes and the route of a partially periodic
one.

Contact lists (:func:`contact_pairs_dense`, :func:`contact_pairs` and their
window forms) are fixed-capacity: ``(max_pairs, 2)`` int32 global indices
padded with -1, distances (0 at padding), the true hit count (not clipped
to ``max_pairs``) and an overflow flag, pair order implementation-defined.
The dense form tests every source against every target; the grid form
scans each source's 27 neighbour cells of a target :func:`cell_table`, by
lattice shifts when the box is orthorhombic and every axis has 3 cells or
more, by per-pair min-image otherwise. The hit table is compacted by a
prefix sum and a scatter (:func:`_compact`), batched over the frames of a
window: nothing waits on the host (``torch.nonzero`` would).

The cutoff test is inclusive (d^2 <= cutoff^2, with cutoff^2 the f32 square
of the f32 cutoff).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config  # noqa: F401  (pins fp32 matmuls)
from .neighbor_ghost import _OFFSETS, _ghost_stencil, cell_bins, within_ghost

__all__ = [
    "grid_dims",
    "grid_dims_for",
    "estimate_caps",
    "cell_table",
    "within_mask",
    "within_mask_window",
    "contact_pairs",
    "contact_pairs_window",
    "contact_pairs_dense",
    "contact_pairs_dense_window",
]

# Pad-slot sentinels of the source and target planes. Opposite signs keep
# pad-vs-pad differences far from zero; every d^2 stays finite in f32.
SRC_PAD = -1e17
TGT_PAD = 1e17

# Elements of one distance block of the contact searches; a window is cut
# into runs of frames that stay under it (2^25 f32 = 128 MiB a temporary).
_BLOCK_ELEMS = 1 << 25

#: ``n_src * n_tgt`` up to which a contact list takes the direct distance
#: matrix (:func:`contact_pairs_dense`) rather than the cell grid.
DENSE_LIMIT = 1 << 21


def grid_dims(box_lengths, cutoff: float) -> tuple[int, int, int]:
    """Per-axis cell counts max(floor(extent / cutoff), 1). Host helper."""
    return tuple(max(int(np.floor(float(l) / cutoff)), 1) for l in box_lengths)


def grid_dims_for(box, cutoff: float) -> tuple[int, int, int]:
    """Cell counts for a host :class:`~molar_tpu_torch.core.pbc.PeriodicBox`:
    from the perpendicular cell heights of a triclinic box (every slab at
    least one cutoff thick), from the vector lengths otherwise (equal to
    the heights for an orthorhombic box)."""
    if box.is_triclinic:
        return grid_dims(box.cell_heights(), cutoff)
    return grid_dims(box.box_extents(), cutoff)


def estimate_caps(coords, inv, dims, tgt_idx=None, margin: float = 1.2, round_to: int = 8):
    """Host frame-occupancy estimate of the cell capacities.

    Returns ``(cap, tgt_cap, occupied_tgt_cells)``: each max occupancy times
    ``margin`` (ceiling), then — only when ``round_to > 1`` — plus 2 slots
    and rounded up to a multiple of ``round_to``. ``margin=1.0,
    round_to=1`` gives the exact counts. ``tgt_idx`` None makes the last two 0.
    """
    nx, ny, nz = dims
    frac = (np.asarray(coords, np.float64) @ np.asarray(inv, np.float64).T) % 1.0
    cx = np.minimum((frac[:, 0] * nx).astype(np.int64), nx - 1)
    cy = np.minimum((frac[:, 1] * ny).astype(np.int64), ny - 1)
    cz = np.minimum((frac[:, 2] * nz).astype(np.int64), nz - 1)
    cell = (cx * ny + cy) * nz + cz
    n_cells = nx * ny * nz

    def size(v):
        v = math.ceil(v * margin)
        if round_to > 1:
            v = (v + 2 + round_to - 1) // round_to * round_to
        return v

    cap = size(np.bincount(cell, minlength=n_cells).max())
    if tgt_idx is None:
        return cap, 0, 0
    tc = np.bincount(cell[np.asarray(tgt_idx)], minlength=n_cells)
    return cap, size(tc.max()), int((tc > 0).sum())


def _apply3(m, x, y, z):
    """Componentwise ``m @ (x, y, z)`` for component planes. ``m`` is one
    (3, 3) matrix, or (B, 3, 3), one a frame, against planes whose first
    axis is the frame."""
    if m.dim() == 3:
        m = m.reshape(m.shape[0], *([1] * (x.dim() - 1)), 3, 3)
    return (
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    )


def _wrap_frac(coords, inv):
    fx, fy, fz = _apply3(inv, coords[..., 0], coords[..., 1], coords[..., 2])
    return fx - torch.floor(fx), fy - torch.floor(fy), fz - torch.floor(fz)


def _cell3(fx, fy, fz, dims):
    return tuple(
        (f * d).to(torch.int32).clamp(0, d - 1) for f, d in zip((fx, fy, fz), dims)
    )


def _rank_in_run(sorted_flat):
    """Rank of each element within its run of equal values (sorted input):
    ``i - cummax(run start positions)``."""
    idx = torch.arange(sorted_flat.shape[0], device=sorted_flat.device)
    is_start = torch.ones_like(sorted_flat, dtype=torch.bool)
    is_start[1:] = sorted_flat[1:] != sorted_flat[:-1]
    starts = torch.where(is_start, idx, torch.full_like(idx, -1))
    return idx - torch.cummax(starts, dim=0).values


def _bucket(flat, cap: int):
    """Stable sort by cell id -> (slot per sorted point, order, overflow)."""
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order].long()
    rank = _rank_in_run(sorted_flat)
    overflow = (rank >= cap).any()
    return sorted_flat * cap + rank.clamp(max=cap - 1), order, overflow


def cell_table(fx, fy, fz, dims: tuple[int, int, int], cap: int):
    """Bucket points by the cell of their wrapped fractional coordinates ->
    ((n_cells, cap) int32 member table padded with -1, overflow flag).
    Members fill a cell's slots from 0 in index order; under overflow the
    table is undefined."""
    cx, cy, cz = _cell3(fx, fy, fz, dims)
    n_cells = dims[0] * dims[1] * dims[2]
    slot, order, overflow = _bucket((cx * dims[1] + cy) * dims[2] + cz, cap)
    table = torch.full((n_cells * cap,), -1, dtype=torch.int32, device=fx.device)
    table[slot] = order.to(torch.int32)
    return table.view(n_cells, cap), overflow


def _blocked_planes(values_list, flat, n_cells: int, cap: int, fill):
    """Scatter per-point planes into cell-blocked ``(n_cells, cap)`` layout.

    Returns (planes, slot per sorted point, order, overflow). Slots fill in
    rank order from 0, so a cell's first pad slot ends its members. Under
    overflow, clipped ranks collide and the planes are undefined.
    """
    slot, order, overflow = _bucket(flat, cap)
    out = []
    for v, f in zip(values_list, fill):
        p = torch.full((n_cells * cap,), f, dtype=v.dtype, device=v.device)
        p[slot] = v[order]
        out.append(p.view(n_cells, cap))
    return out, slot, order, overflow


def _ghost_planes(vals, flat_pad, dims, cap: int, box, pbc, fill):
    """Scatter [x, y, z] planes into a ghost-padded ``(nx+2, ny+2, nz+2,
    cap)`` grid and fill the ghost faces with wrapped copies shifted by the
    box vectors — axis by axis (x, then y including the x ghosts, then z
    including both) so edges and corners compose the multi-axis shifts.
    Non-periodic faces keep the sentinel. Returns (planes, overflow)."""
    nx, ny, nz = dims
    slot, order, overflow = _bucket(flat_pad, cap)
    out = []
    for d, v in enumerate(vals):
        p = torch.full(((nx + 2) * (ny + 2) * (nz + 2) * cap,), fill, dtype=v.dtype,
                       device=v.device)
        p[slot] = v[order]
        p = p.view(nx + 2, ny + 2, nz + 2, cap)
        if pbc[0]:
            p[0] = p[nx] - box[d, 0]
            p[nx + 1] = p[1] + box[d, 0]
        if pbc[1]:
            p[:, 0] = p[:, ny] - box[d, 1]
            p[:, ny + 1] = p[:, 1] + box[d, 1]
        if pbc[2]:
            p[:, :, 0] = p[:, :, nz] - box[d, 2]
            p[:, :, nz + 1] = p[:, :, 1] + box[d, 2]
        out.append(p)
    return out, overflow


def _unsort_mask(hit_blocks, s_slot, s_order, n):
    """Per-point mask from cell-blocked hits (undo the bucketing sort)."""
    out = torch.zeros(n, dtype=torch.bool, device=hit_blocks.device)
    out[s_order] = hit_blocks.reshape(-1)[s_slot]
    return out


def _cutoff2(cutoff) -> float:
    """The f32 square of the f32 cutoff (exact as a Python float)."""
    c = np.float32(cutoff)
    return float(c * c)


def _ghost_inputs(sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz, box, dims, cap, tgt_cap, pbc):
    """Source blocks + ghost target planes shared by the plain stencil and
    the kernel. Returns (src planes, ghost planes, s_slot, s_order, overflow)."""
    nx, ny, nz = dims
    src, s_slot, s_order, s_ofl = _blocked_planes(
        [sx, sy, sz], sflat, nx * ny * nz, cap, [SRC_PAD] * 3
    )
    tflat_pad = ((tcx + 1) * (ny + 2) + (tcy + 1)) * (nz + 2) + (tcz + 1)
    ghost, t_ofl = _ghost_planes([tx, ty, tz], tflat_pad, dims, tgt_cap, box, pbc, TGT_PAD)
    return src, ghost, s_slot, s_order, s_ofl | t_ofl


def _search_args(coords, src_idx, tgt_idx, box, inv, dims):
    """Wrapped lab coordinates and cells of both sets:
    (sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz)."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    src = coords if src_idx is None else torch.stack([x[src_idx], y[src_idx], z[src_idx]], -1)
    tgt = torch.stack([x[tgt_idx], y[tgt_idx], z[tgt_idx]], -1)
    sf = _wrap_frac(src, inv)
    tf = _wrap_frac(tgt, inv)
    sx, sy, sz = _apply3(box, *sf)
    tx, ty, tz = _apply3(box, *tf)
    scx, scy, scz = _cell3(*sf, dims)
    sflat = (scx * dims[1] + scy) * dims[2] + scz
    tcx, tcy, tcz = _cell3(*tf, dims)
    return sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz


def _min_image_d2(dx, dy, dz, box, inv, corrections, pbc):
    """Squared min-image norm of component planes (any broadcast shape), in
    the JAX package's order: inverse transform, round (half to even) on the
    periodic axes, forward transform, ``(x² + y²) + z²``; then, under full
    PBC, the minimum over the ``(K, 3)`` correction candidates (zero rows
    are no-ops), taken in one broadcast over a trailing K axis. ``box``,
    ``inv`` and ``corrections`` may carry a leading frame axis
    (:func:`_apply3`)."""
    fx, fy, fz = _apply3(inv, dx, dy, dz)
    if pbc[0]:
        fx = fx - torch.round(fx)
    if pbc[1]:
        fy = fy - torch.round(fy)
    if pbc[2]:
        fz = fz - torch.round(fz)
    sx, sy, sz = _apply3(box, fx, fy, fz)
    d2 = sx * sx + sy * sy + sz * sz
    if corrections is None or not all(pbc):
        return d2
    if corrections.dim() == 3:
        corrections = corrections.reshape(corrections.shape[0], *([1] * (sx.dim() - 1)),
                                          *corrections.shape[1:])
    cx = sx[..., None] + corrections[..., 0]
    cy = sy[..., None] + corrections[..., 1]
    cz = sz[..., None] + corrections[..., 2]
    return torch.minimum(d2, (cx * cx + cy * cy + cz * cz).amin(dim=-1))


def _neighbor_cells(cx, cy, cz, off, dims, pbc):
    """Flat ids of the cells at offset ``off`` from cells (cx, cy, cz), and
    whether each exists (a non-periodic axis has no cell past its edge)."""
    ok = torch.ones_like(cx, dtype=torch.bool)
    cs = []
    for c, o, n, per in zip((cx, cy, cz), off, dims, pbc):
        c = c + o
        if per:
            c = c % n
        else:
            ok = ok & (c >= 0) & (c < n)
            c = c.clamp(0, n - 1)
        cs.append(c)
    return (cs[0] * dims[1] + cs[1]) * dims[2] + cs[2], ok


def _cell_neighbor_ids(dims, pbc, device):
    """(n_cells, 27) flat neighbour ids of every cell, -1 past a
    non-periodic edge; on a grid with an axis of 1 or 2 cells, where
    offsets alias, each row is sorted and its repeats set to -1. Built on
    ``device`` from ``arange`` (no host data to copy)."""
    nx, ny, nz = dims
    ids = torch.arange(nx * ny * nz, device=device)[:, None]
    o = torch.arange(27, device=device)[None, :]
    flat, ok = _neighbor_cells(ids // (ny * nz), (ids // nz) % ny, ids % nz,
                               (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1), dims, pbc)
    flat = torch.where(ok, flat, -1)
    return _dedupe_small_grid(flat) if min(dims) <= 2 else flat


def _dedupe_small_grid(nb_ids):
    """(n, 27) neighbour ids -> each row sorted, its repeats set to -1 (on
    a periodic axis of 1 or 2 cells different offsets reach the same
    cell)."""
    s = nb_ids.sort(dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.where(dup, -1, s)


def _occupied_cells(tflat, max_cells: int):
    """The distinct cell ids of ``tflat`` in ascending order, padded to
    ``max_cells`` -> (cells (padding reads cell 0), valid, overflow).
    ``nonzero_static`` compacts into a fixed size, so nothing waits on the
    host."""
    sorted_t = torch.sort(tflat).values
    is_first = torch.ones_like(sorted_t, dtype=torch.bool)
    is_first[1:] = sorted_t[1:] != sorted_t[:-1]
    pos = torch.nonzero_static(is_first, size=max_cells, fill_value=-1)[:, 0]
    valid = pos >= 0
    cells = torch.where(valid, sorted_t[pos.clamp(min=0)], 0)
    return cells, valid, is_first.sum() > max_cells


def _within_corrections(sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz, box, inv, corrections,
                        dims, cap, tgt_cap, pbc, c2, max_tgt_cells):
    """The per-pair min-image search (``molar_tpu.ops.neighbor.within_mask``'s
    triclinic branch) -> (hit blocks (n_cells, cap), s_slot, s_order,
    overflow)."""
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    tflat = (tcx * ny + tcy) * nz + tcz
    (sxb, syb, szb, svalid), s_slot, s_order, s_ofl = _blocked_planes(
        [sx, sy, sz, torch.ones_like(sx, dtype=torch.bool)], sflat, n_cells, cap,
        [0.0, 0.0, 0.0, False])
    (txb, tyb, tzb, tvalid), _, _, t_ofl = _blocked_planes(
        [tx, ty, tz, torch.ones_like(tx, dtype=torch.bool)], tflat, n_cells, tgt_cap,
        [0.0, 0.0, 0.0, False])

    if max_tgt_cells is None:
        # Dense: every source cell against its 27 neighbour rows.
        nb = _cell_neighbor_ids(dims, pbc, sx.device)
        hit = torch.zeros((n_cells, cap), dtype=torch.bool, device=sx.device)
        for o in range(27):
            cells = nb[:, o]
            safe = cells.clamp(min=0)
            d2 = _min_image_d2(txb[safe][:, None, :] - sxb[:, :, None],
                               tyb[safe][:, None, :] - syb[:, :, None],
                               tzb[safe][:, None, :] - szb[:, :, None], box, inv, corrections, pbc)
            ok = (cells >= 0)[:, None, None] & tvalid[safe][:, None, :]
            hit |= (ok & (d2 <= c2)).any(dim=2)
        return hit & svalid, s_slot, s_order, s_ofl | t_ofl

    # Sparse: the occupied target cells only, each against its 27
    # neighbouring source cells; hits are summed back into the source
    # blocks (an index_add, since padding rows repeat cell 0). No grid has
    # more occupied cells than cells, so slots beyond n_cells are dropped.
    occ, occ_valid, occ_ofl = _occupied_cells(tflat, min(max_tgt_cells, n_cells))
    ocx, ocy, ocz = occ // (ny * nz), (occ // nz) % ny, occ % nz
    otx, oty, otz = txb[occ][:, None, :], tyb[occ][:, None, :], tzb[occ][:, None, :]
    otv = tvalid[occ][:, None, :] & occ_valid[:, None, None]
    hits = torch.zeros((n_cells, cap), dtype=torch.int32, device=sx.device)
    for off in _OFFSETS:
        scells, ok = _neighbor_cells(ocx, ocy, ocz, off, dims, pbc)
        d2 = _min_image_d2(otx - sxb[scells][:, :, None], oty - syb[scells][:, :, None],
                           otz - szb[scells][:, :, None], box, inv, corrections, pbc)
        hit = (otv & (d2 <= c2)).any(dim=2) & (ok & occ_valid)[:, None]
        hits.index_add_(0, scells, hit.to(torch.int32))
    return (hits > 0) & svalid, s_slot, s_order, s_ofl | t_ofl | occ_ofl


def within_mask_window(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    boxes,
    invs,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    tgt_cap=None,
    pbc=(True, True, True),
    plain: bool = False,
):
    """The ghost-slab search over a window of frames -> (masks (B, n_src)
    bool, overflow (B,) bool); a frame's mask is undefined when its flag is
    set. ``coords`` (B, N, 3) f32; ``src_idx`` int64 or None (every atom);
    ``tgt_idx`` int64; ``boxes``/``invs`` (B, 3, 3), read on the coords'
    device (no host read, no host sync).

    Asserts a grid whose cells are at least a cutoff thick between
    opposite faces in every frame's box, which :func:`grid_dims_for` gives
    for any box, skewed or not: every periodic image within the cutoff is
    then a +-1-cell lattice shift, and the stencil visits each (the
    correction path rests on the same precondition, over the same
    stencil). CUDA tensors take the two kernels of
    :mod:`.neighbor_ghost` (two launches for the whole window); CPU
    tensors, or ``plain=True`` on any device, the plain twin frame by frame.
    """
    tgt_cap = tgt_cap or cap
    n_src = coords.shape[1] if src_idx is None else src_idx.shape[0]
    c2 = _cutoff2(cutoff)
    if plain or coords.device.type == "cpu":
        masks, overflows = [], []
        for f in range(coords.shape[0]):
            args = _search_args(coords[f], src_idx, tgt_idx, boxes[f], invs[f], dims)
            src, ghost, s_slot, s_order, ofl = _ghost_inputs(*args, boxes[f], dims, cap, tgt_cap,
                                                             pbc)
            hit = _ghost_stencil(src, ghost, dims, cap, tgt_cap, c2)
            masks.append(_unsort_mask(hit, s_slot, s_order, n_src))
            overflows.append(ofl)
        return torch.stack(masks), torch.stack(overflows)
    src_rec, tgt_rec, counts, overflow = cell_bins(coords, src_idx, tgt_idx, boxes, invs, dims,
                                                   cap, tgt_cap)
    return within_ghost(src_rec, tgt_rec, counts, boxes, dims, cap, tgt_cap, pbc, c2,
                        n_src), overflow


def within_mask(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    pbc=(True, True, True),
    tgt_cap=None,
    max_tgt_cells=None,
    plain: bool = False,
):
    """Boolean mask over ``src_idx`` (all atoms when None): has >= 1
    partner in ``tgt_idx`` within ``cutoff`` under periodic images. One
    frame; ``box``/``inv`` are (3, 3) tensors on the coords' device.

    ``corrections is None`` runs the ghost-slab search,
    :func:`within_mask_window` on a window of one (``plain`` runs the
    kernels' plain twin in their place), and asserts a grid whose cells
    are at least a cutoff thick between opposite faces (:func:`grid_dims_for`
    gives one for any box). Both regimes rest on that precondition. Given a
    skewed box's ``(K, 3)`` correction candidates (on the device), the
    per-pair min-image path runs instead; ``max_tgt_cells`` then selects the
    sparse-target variant with that many occupied-cell slots (overflow
    beyond them raises the flag). Returns (mask, overflow flag); the mask
    is undefined when the flag is set.
    """
    tgt_cap = tgt_cap or cap
    if corrections is None:
        masks, overflow = within_mask_window(coords[None], src_idx, tgt_idx, cutoff, box[None],
                                             inv[None], dims, cap, tgt_cap, pbc, plain)
        return masks[0], overflow[0]
    n_src = coords.shape[0] if src_idx is None else src_idx.shape[0]
    hit, s_slot, s_order, ofl = _within_corrections(
        *_search_args(coords, src_idx, tgt_idx, box, inv, dims), box, inv, corrections, dims,
        cap, tgt_cap, pbc, _cutoff2(cutoff), max_tgt_cells)
    return _unsort_mask(hit, s_slot, s_order, n_src), ofl


def _cells_shift(cx, cy, cz, off, dims, pbc, box):
    """Neighbour cells at offsets ``off`` (three tensors broadcastable
    against the cell coordinates) and the lab-frame lattice shift of each
    neighbour's periodic image -> (flat cell ids (clipped), (shift x, y,
    z), ok). With every point wrapped into the unit cell and cells no
    smaller than the cutoff, the only image of a neighbour cell's contents
    that can be in range is the one displaced by the wrap's lattice vector,
    known per (cell, offset): it replaces the per-pair image math."""
    ok = torch.ones_like(cx + off[0], dtype=torch.bool)
    cs, ws = [], []
    for c, o, n, per in zip((cx, cy, cz), off, dims, pbc):
        c = c + o
        if per:
            w = (c >= n).to(c.dtype) - (c < 0).to(c.dtype)
            c = c - w * n
        else:
            w = torch.zeros_like(c)
            ok = ok & (c >= 0) & (c < n)
            c = c.clamp(0, n - 1)
        cs.append(c)
        ws.append(w.to(box.dtype))
    return (cs[0] * dims[1] + cs[1]) * dims[2] + cs[2], _apply3(box, *ws), ok


def _search_core(coords, src_idx, tgt_idx, c2, box, inv, corrections, dims, cap, pbc):
    """One frame of the grid contact search -> (hit (n_src, 27, cap) bool,
    members (n_src, 27, cap) int32 target list positions (-1 at padding),
    the target table's overflow flag, wrapped source planes, wrapped
    target planes).

    With ``corrections is None`` and 3 cells or more on every axis (no
    offset aliases, the in-range image unique) all 27 offsets are taken in
    one broadcast with the lattice shift of :func:`_cells_shift`; otherwise
    offset by offset with the per-pair min-image of :func:`_min_image_d2`,
    the neighbour ids deduplicated on tiny grids."""
    sf = _wrap_frac(coords[src_idx], inv)
    tf = _wrap_frac(coords[tgt_idx], inv)
    sx, sy, sz = _apply3(box, *sf)
    tx, ty, tz = _apply3(box, *tf)
    table, overflow = cell_table(*tf, dims, cap)
    cx, cy, cz = (c[:, None] for c in _cell3(*sf, dims))
    o = torch.arange(27, device=coords.device)[None, :]
    off = (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1)

    if corrections is None and min(dims) >= 3:
        cells, (shx, shy, shz), ok = _cells_shift(cx, cy, cz, off, dims, pbc, box)
        members = table[cells]
        cand = members.clamp(min=0).long()
        dx = tx[cand] + shx[..., None] - sx[:, None, None]
        dy = ty[cand] + shy[..., None] - sy[:, None, None]
        dz = tz[cand] + shz[..., None] - sz[:, None, None]
        hit = ok[..., None] & (members >= 0) & (dx * dx + dy * dy + dz * dz <= c2)
        return hit, members, overflow, (sx, sy, sz), (tx, ty, tz)

    nb, ok = _neighbor_cells(cx, cy, cz, off, dims, pbc)
    nb = torch.where(ok, nb, -1)
    if min(dims) <= 2:
        nb = _dedupe_small_grid(nb)
    hits, mems = [], []
    for k in range(27):
        cells = nb[:, k]
        members = table[cells.clamp(min=0)]
        cand = members.clamp(min=0).long()
        d2 = _min_image_d2(tx[cand] - sx[:, None], ty[cand] - sy[:, None],
                           tz[cand] - sz[:, None], box, inv, corrections, pbc)
        hits.append((cells >= 0)[:, None] & (members >= 0) & (d2 <= c2))
        mems.append(members)
    return torch.stack(hits, 1), torch.stack(mems, 1), overflow, (sx, sy, sz), (tx, ty, tz)


def _compact(hit, size: int):
    """The positions of the first ``size`` true entries of each row of
    ``hit`` (B, M), ascending, padded with -1 -> (B, size) int64: what
    ``nonzero(size=, fill_value=-1)`` gives row by row. A prefix sum ranks
    the hits and a scatter writes each position to its rank (the others,
    and the hits past ``size``, into a spare column that is cut off), so
    the shape is fixed and nothing waits on the host."""
    b, m = hit.shape
    rank = torch.cumsum(hit, dim=1, dtype=torch.int32) - 1
    dst = torch.where(hit & (rank < size), rank, size).long()
    out = torch.full((b, size + 1), -1, dtype=torch.int64, device=hit.device)
    out.scatter_(1, dst, torch.arange(m, device=hit.device).expand(b, m))
    return out[:, :size]


def _dense_d2(coords, src_idx, tgt_idx, boxes, invs, corrections, pbc):
    """Squared min-image distance of every source to every target, frame by
    frame -> (B, n_src, n_tgt). Both sets are wrapped into the unit cell
    first (small displacements, one min-image step exact)."""
    sx, sy, sz = _apply3(boxes, *_wrap_frac(coords[:, src_idx], invs))
    tx, ty, tz = _apply3(boxes, *_wrap_frac(coords[:, tgt_idx], invs))
    return _min_image_d2(tx[:, None, :] - sx[:, :, None], ty[:, None, :] - sy[:, :, None],
                         tz[:, None, :] - sz[:, :, None], boxes, invs, corrections, pbc)


def _frames_of(corrections, frames):
    """The correction candidates of ``frames`` (a slice or an index): a
    (K, 3) table serves every frame, a (B, K, 3) one is per frame."""
    return corrections if corrections is None or corrections.dim() == 2 else corrections[frames]


def contact_pairs_dense_window(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    boxes,
    invs,
    corrections=None,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
):
    """Fixed-capacity contact lists of a window through the direct
    (n_src, n_tgt) distance matrix, no cell grid -> per frame (pairs (B,
    max_pairs, 2) int32 global indices padded with -1, distances (B,
    max_pairs), 0 at padding, count (B,) the true number of hits, overflow
    (B,) = count > max_pairs). ``coords`` (B, N, 3); ``boxes``/``invs`` (B,
    3, 3); ``corrections`` None, (K, 3) or (B, K, 3). The one to use when
    n_src * n_tgt is small; nothing to size but ``max_pairs``. Pairs come
    in ascending (source, target) list order. A long window is taken in
    runs of frames whose distance block stays under :data:`_BLOCK_ELEMS`.
    """
    c2 = _cutoff2(cutoff)
    n_tgt = tgt_idx.shape[0]
    k = corrections.shape[-2] if corrections is not None and all(pbc) else 1
    step = max(1, _BLOCK_ELEMS // max(1, src_idx.shape[0] * n_tgt * k))
    runs = []
    for lo in range(0, coords.shape[0], step):
        run = slice(lo, lo + step)
        d2 = _dense_d2(coords[run], src_idx, tgt_idx, boxes[run], invs[run],
                       _frames_of(corrections, run), pbc).flatten(1)
        hit = d2 <= c2
        pos = _compact(hit, max_pairs)
        ok = pos >= 0
        safe = pos.clamp(min=0)
        pairs = torch.stack([src_idx[safe // n_tgt], tgt_idx[safe % n_tgt]], dim=-1)
        count = hit.sum(dim=1)
        runs.append((torch.where(ok[..., None], pairs, -1).to(torch.int32),
                     torch.where(ok, torch.sqrt(d2.gather(1, safe)), 0.0),
                     count, count > max_pairs))
    return runs[0] if len(runs) == 1 else tuple(torch.cat(x) for x in zip(*runs))


def contact_pairs_dense(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
):
    """One frame of :func:`contact_pairs_dense_window`: ``coords`` (N, 3),
    ``box``/``inv`` (3, 3), ``corrections`` None or (K, 3) -> (pairs
    (max_pairs, 2), distances (max_pairs,), count, overflow)."""
    out = contact_pairs_dense_window(coords[None], src_idx, tgt_idx, cutoff, box[None],
                                     inv[None], corrections, max_pairs, pbc)
    return tuple(x[0] for x in out)


def contact_pairs(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
):
    """Fixed-capacity contact list between two selections through the cell
    grid, one frame -> (pairs (max_pairs, 2) int32 global indices padded
    with -1, distances (max_pairs,), count, overflow = the target table
    overflowed ``cap`` or count > max_pairs). ``dims`` from
    :func:`grid_dims_for`. Pair order is implementation-defined; sort
    before comparing across implementations."""
    hit, mem, overflow, (sx, sy, sz), (tx, ty, tz) = _search_core(
        coords, src_idx, tgt_idx, _cutoff2(cutoff), box, inv, corrections, dims, cap, pbc)
    pos = _compact(hit.reshape(1, -1), max_pairs)[0]
    ok = pos >= 0
    safe = pos.clamp(min=0)
    si = safe // (27 * cap)
    mj = mem.reshape(-1)[safe].clamp(min=0).long()
    d2 = _min_image_d2(tx[mj] - sx[si], ty[mj] - sy[si], tz[mj] - sz[si], box, inv,
                       corrections, pbc)
    pairs = torch.stack([src_idx[si], tgt_idx[mj]], dim=-1)
    count = hit.sum()
    return (torch.where(ok[:, None], pairs, -1).to(torch.int32),
            torch.where(ok, torch.sqrt(d2), 0.0), count, overflow | (count > max_pairs))


def _cell_table_window(fx, fy, fz, dims, cap: int):
    """:func:`cell_table` of every frame of a window at once: (B, n)
    fractional planes -> ((B, n_cells, cap) int32 member tables (row
    positions within the frame, -1 at padding), overflow (B,)). One stable
    sort over frame-offset cell ids keeps each frame's members in index
    order, so each frame's table is the one :func:`cell_table` builds."""
    b, n = fx.shape
    n_cells = dims[0] * dims[1] * dims[2]
    cx, cy, cz = _cell3(fx, fy, fz, dims)
    frame = torch.arange(b, device=fx.device)[:, None]
    flat = (((cx * dims[1] + cy) * dims[2] + cz).long() + frame * n_cells).reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    rank = _rank_in_run(sorted_flat)
    over = torch.zeros(b, dtype=torch.int32, device=fx.device).index_add_(
        0, sorted_flat // n_cells, (rank >= cap).to(torch.int32))
    table = torch.full((b * n_cells * cap,), -1, dtype=torch.int32, device=fx.device)
    table[sorted_flat * cap + rank.clamp(max=cap - 1)] = (order % n).to(torch.int32)
    return table.view(b, n_cells, cap), over > 0


def _rows(x, idx):
    """``x[f][idx[f]]`` for every frame f: (B, n) planes gathered at (B,
    ...) indices."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).view(idx.shape)


def _search_core_window(coords, src_idx, tgt_idx, c2, boxes, invs, corrections, dims, cap,
                        pbc):
    """:func:`_search_core` over a window, every frame at once -> (hit (B,
    n_src, 27, cap), members (B, n_src, 27, cap), overflow (B,), wrapped
    source planes (B, n_src), wrapped target planes (B, n_tgt)). The same
    operations on each element as the one-frame form, so the same bits."""
    b = coords.shape[0]
    sf = _wrap_frac(coords[:, src_idx], invs)
    tf = _wrap_frac(coords[:, tgt_idx], invs)
    sx, sy, sz = _apply3(boxes, *sf)
    tx, ty, tz = _apply3(boxes, *tf)
    table, overflow = _cell_table_window(*tf, dims, cap)
    cx, cy, cz = (c[:, :, None] for c in _cell3(*sf, dims))
    o = torch.arange(27, device=coords.device)[None, None, :]
    off = (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1)
    frame = torch.arange(b, device=coords.device)

    if corrections is None and min(dims) >= 3:
        cells, (shx, shy, shz), ok = _cells_shift(cx, cy, cz, off, dims, pbc, boxes)
        members = table[frame[:, None, None], cells]
        cand = members.clamp(min=0).long()
        dx = _rows(tx, cand) + shx[..., None] - sx[:, :, None, None]
        dy = _rows(ty, cand) + shy[..., None] - sy[:, :, None, None]
        dz = _rows(tz, cand) + shz[..., None] - sz[:, :, None, None]
        hit = ok[..., None] & (members >= 0) & (dx * dx + dy * dy + dz * dz <= c2)
        return hit, members, overflow, (sx, sy, sz), (tx, ty, tz)

    nb, ok = _neighbor_cells(cx, cy, cz, off, dims, pbc)
    nb = torch.where(ok, nb, -1)
    if min(dims) <= 2:
        nb = _dedupe_small_grid(nb.reshape(-1, 27)).view(nb.shape)
    hits, mems = [], []
    for k in range(27):
        cells = nb[:, :, k]
        members = table[frame[:, None], cells.clamp(min=0)]
        cand = members.clamp(min=0).long()
        d2 = _min_image_d2(_rows(tx, cand) - sx[:, :, None], _rows(ty, cand) - sy[:, :, None],
                           _rows(tz, cand) - sz[:, :, None], boxes, invs, corrections, pbc)
        hits.append((cells >= 0)[:, :, None] & (members >= 0) & (d2 <= c2))
        mems.append(members)
    return torch.stack(hits, 2), torch.stack(mems, 2), overflow, (sx, sy, sz), (tx, ty, tz)


def contact_pairs_window(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    boxes,
    invs,
    corrections=None,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
    plain: bool = False,
):
    """:func:`contact_pairs` over a window: ``coords`` (B, N, 3),
    ``boxes``/``invs`` (B, 3, 3), ``corrections`` None, (K, 3) or (B, K,
    3) -> (pairs (B, max_pairs, 2), distances (B, max_pairs), count (B,),
    overflow (B,)). Every frame of a run at once (runs of frames whose hit
    table stays under :data:`_BLOCK_ELEMS`), a fixed number of launches a
    run; ``plain=True`` runs :func:`contact_pairs` frame by frame, the
    plain version it equals: the same pairs in the same order, the same
    distances, counts and flags."""
    if plain:
        frames = [contact_pairs(coords[f], src_idx, tgt_idx, cutoff, boxes[f], invs[f],
                                _frames_of(corrections, f), dims, cap, max_pairs, pbc)
                  for f in range(coords.shape[0])]
        return tuple(torch.stack(x) for x in zip(*frames))
    c2 = _cutoff2(cutoff)
    k = corrections.shape[-2] if corrections is not None and all(pbc) else 1
    per_frame = src_idx.shape[0] * 27 * cap * k
    step = max(1, _BLOCK_ELEMS // max(1, per_frame))
    runs = []
    for lo in range(0, coords.shape[0], step):
        run = slice(lo, lo + step)
        corr = _frames_of(corrections, run)
        hit, mem, overflow, (sx, sy, sz), (tx, ty, tz) = _search_core_window(
            coords[run], src_idx, tgt_idx, c2, boxes[run], invs[run], corr, dims, cap, pbc)
        b = hit.shape[0]
        pos = _compact(hit.reshape(b, -1), max_pairs)
        ok = pos >= 0
        safe = pos.clamp(min=0)
        si = safe // (27 * cap)
        mj = torch.gather(mem.reshape(b, -1), 1, safe).clamp(min=0).long()
        d2 = _min_image_d2(_rows(tx, mj) - _rows(sx, si), _rows(ty, mj) - _rows(sy, si),
                           _rows(tz, mj) - _rows(sz, si), boxes[run], invs[run], corr, pbc)
        pairs = torch.stack([src_idx[si], tgt_idx[mj]], dim=-1)
        count = hit.reshape(b, -1).sum(dim=1)
        runs.append((torch.where(ok[..., None], pairs, -1).to(torch.int32),
                     torch.where(ok, torch.sqrt(d2), 0.0), count,
                     overflow | (count > max_pairs)))
    return runs[0] if len(runs) == 1 else tuple(torch.cat(x) for x in zip(*runs))
