"""Cell-grid ``within`` search with periodic images, in torch.

Counterpart of ``molar_tpu.ops.neighbor`` for the headline's search:
points are wrapped into the unit cell, bucketed into fixed-capacity
``(n_cells, cap)`` structure-of-arrays planes (stable argsort + rank in run +
scatter), the targets go into ghost-padded ``(nx+2, ny+2, nz+2, tgt_cap)``
planes whose border cells hold pre-shifted periodic images, and the 27-cell
stencil then needs no gathers, no per-pair image math and no validity
planes (pad slots are +-1e17 sentinels).

:func:`within_mask` runs the ghost-slab search: it builds the planes here
and hands them to :func:`.neighbor_ghost.within_ghost`, which launches the
hand-written kernel on CUDA tensors and runs its plain twin on CPU tensors.
``within_mask(..., plain=True)`` runs the plain twin on any device (the
counterpart of the JAX package's ``_within_ghost``): the reference the kernel
is held against on the card. Static-shape contract as in the JAX
package: ``dims``/``cap``/``tgt_cap`` are fixed, the search returns an
overflow flag, and when the flag is set the mask is UNDEFINED (clipped ranks
make duplicate scatter slots) — callers retry at a larger capacity.

The cutoff test is inclusive (d^2 <= cutoff^2, with cutoff^2 the f32 square
of the f32 cutoff).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config  # noqa: F401  (pins fp32 matmuls)
from .neighbor_ghost import _ghost_stencil, within_ghost

__all__ = ["grid_dims", "estimate_caps", "within_mask"]

# Pad-slot sentinels of the source and target planes. Opposite signs keep
# pad-vs-pad differences far from zero; every d^2 stays finite in f32.
SRC_PAD = -1e17
TGT_PAD = 1e17


def grid_dims(box_lengths, cutoff: float) -> tuple[int, int, int]:
    """Per-axis cell counts max(floor(extent / cutoff), 1). Host helper."""
    return tuple(max(int(np.floor(float(l) / cutoff)), 1) for l in box_lengths)


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
    """Componentwise ``m @ (x, y, z)`` for component planes."""
    return (
        m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
        m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
        m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
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
    plain: bool = False,
):
    """Boolean mask over ``src_idx`` (all atoms when None): has >= 1
    partner in ``tgt_idx`` within ``cutoff`` under periodic images. One
    frame; ``box``/``inv`` are (3, 3) tensors on the coords' device.

    ``corrections is None`` asserts an orthorhombic box (or one whose
    in-cutoff images are the +-1-cell lattice shifts); the triclinic
    correction sweep is not ported yet and raises. Returns (mask, overflow
    flag); the mask is undefined when the flag is set. ``plain`` runs the
    kernel's plain twin in its place.
    """
    if corrections is not None:
        raise NotImplementedError("triclinic within_mask (corrections) is not ported yet")
    tgt_cap = tgt_cap or cap
    n_src = coords.shape[0] if src_idx is None else src_idx.shape[0]
    src, ghost, s_slot, s_order, ofl = _ghost_inputs(
        *_search_args(coords, src_idx, tgt_idx, box, inv, dims), box, dims, cap, tgt_cap, pbc
    )
    stencil = _ghost_stencil if plain else within_ghost
    hit = stencil(src, ghost, dims, cap, tgt_cap, _cutoff2(cutoff))
    return _unsort_mask(hit, s_slot, s_order, n_src), ofl
