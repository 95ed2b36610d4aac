"""The per-pair min-image ``within`` search on the card: the hand-written
CUDA stencil kernel over cell records and its plain twins.

Counterpart of ``molar_tpu.ops.neighbor_pallas.within_mask_pallas`` as a
whole (its XLA plane build, its Pallas ``_kernel`` and its unsort), for
orthorhombic boxes with full PBC and a window of frames in two launches:
:func:`~.neighbor_ghost.cell_bins` (``csrc/cell_bin.cu``, the ghost route's
counting sort into 16-byte cell records) and :func:`within_rows`
(``csrc/within_rows.cu``): a block per tile of cells that leaves at once
when no cell of the tile has a source and a target in reach, a warp per
live cell, the cell's 27 neighbour cells' targets staged unshifted in shared
memory, every pair's image resolved on the spot (``d - L*round(d/L)`` per
axis, computed without a division: :func:`_image_abs`), the mask written
through each source's list position.

:func:`within_rows` launches the kernel for CUDA tensors and never falls
back; for CPU tensors, and only for them, it runs the kernel's plain twin
over the same records, :func:`_rows_bins_stencil`. ``within_rows.launches``
counts kernel launches and nothing else.

:func:`_rows_stencil` is the plain stencil over x-minor row planes (the TPU
kernel's own layout: cell ``(cy*nz + cz)*nx + cx``, 9 (dy, dz) neighbour
rows times 3 x rolls, a source validity plane and an additive d² penalty of
1e12 on target pad slots), the twin that :func:`within_mask_rows_window`
runs on the CPU (and with ``plain=True``), held bit for bit against the JAX
package.
"""

from __future__ import annotations

import torch

from .neighbor import _blocked_planes, _cutoff2, _search_args, _unsort_mask
from .neighbor_ghost import _check, _check_sizes, _image_cells, _launch_error, _lib, cell_bins

__all__ = ["within_mask_rows", "within_mask_rows_window", "within_rows"]

#: d² penalty of a pad target slot of the row planes (the plane twin only;
#: the kernel reads counts).
PAD_PENALTY = 1e12

#: Float operations the kernel spends on a candidate pair, as
#: ``csrc/within_rows.cu`` counts them: 3 sub (d), 3 sub + 3 min (the
#: image), 3 mul + 2 add (d²), 1 compare.
FLOPS_PER_PAIR = 15

#: Consecutive cells one block of the kernel looks after (at most 32, one
#: lane of its first warp each); 1 is the block-per-cell form. 16 was the
#: fastest of 1, 4, 8, 16 and 32 at the headline window on an H100
#: (``chip_smoke.py`` times them).
CELLS_PER_BLOCK = 16

_ROW_OFFSETS = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _rows_stencil(src, tgt, lengths, dims, cap: int, tgt_cap: int, c2: float):
    """Plain 9-row x 3-roll stencil -> hit blocks ``(ny*nz, nx, cap)``.

    ``_kernel``'s arithmetic in its order: ``d = target - source``,
    ``d - L*round(d/L)`` per axis (round half to even), then
    ``((dx² + dy²) + dz²) + penalty <= c2``; the source validity plane
    masks the result.
    """
    nx, ny, nz = dims
    sx, sy, sz, sval = (s[:, :, :, None] for s in src)
    lx, ly, lz = lengths[0], lengths[1], lengths[2]
    r = torch.arange(ny * nz, device=sx.device)
    y, z = r // nz, r % nz
    hit = torch.zeros((ny * nz, nx, cap), dtype=torch.bool, device=sx.device)
    for dy, dz in _ROW_OFFSETS:
        rows = ((y + dy) % ny) * nz + (z + dz) % nz
        tx, ty, tz, tp = (t[rows] for t in tgt)
        for dx in (-1, 0, 1):
            rx, ry, rz, rp = (torch.roll(t, -dx, dims=1)[:, :, None, :] for t in (tx, ty, tz, tp))
            ddx = rx - sx
            ddy = ry - sy
            ddz = rz - sz
            ddx = ddx - lx * torch.round(ddx / lx)
            ddy = ddy - ly * torch.round(ddy / ly)
            ddz = ddz - lz * torch.round(ddz / lz)
            d2 = ddx * ddx + ddy * ddy + ddz * ddz + rp
            hit |= (d2 <= c2).any(dim=3)
    return hit & (sval[..., 0] > 0)


def _rows_inputs(coords, src_idx, tgt_idx, box, inv, dims, cap: int, tgt_cap: int):
    """The x-minor row planes of both sets and the box lengths:
    (src planes, tgt planes, lengths, s_slot, s_order, overflow)."""
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz = _search_args(
        coords, src_idx, tgt_idx, box, inv, dims)
    # From x-major (cx*ny + cy)*nz + cz to x-minor (cy*nz + cz)*nx + cx.
    sflat = (sflat % (ny * nz)) * nx + sflat // (ny * nz)
    tflat = (tcy * nz + tcz) * nx + tcx
    splanes, s_slot, s_order, s_ofl = _blocked_planes(
        [sx, sy, sz, torch.ones_like(sx)], sflat, n_cells, cap, [0.0] * 4)
    tplanes, _, _, t_ofl = _blocked_planes(
        [tx, ty, tz, torch.zeros_like(tx)], tflat, n_cells, tgt_cap, [0.0, 0.0, 0.0, PAD_PENALTY])
    rows = [p.view(ny * nz, nx, -1) for p in splanes], [p.view(ny * nz, nx, -1) for p in tplanes]
    lengths = torch.diagonal(box).contiguous()
    return *rows, lengths, s_slot, s_order, s_ofl | t_ofl


def _image_abs(d, length):
    """The kernel's ``|d - length*round(d / length)|`` for wrapped
    coordinates (``|d| <= length``), without a division: ``min(|d|, length -
    |d|)``. Bitwise the plain form's magnitude there (``csrc/within_rows.cu``
    says why); past ``length`` it is minus that, and only its square is
    used."""
    return torch.minimum(d.abs(), length - d.abs())


def _rows_bins_stencil(src_rec, tgt_rec, counts, boxes, dims, cap: int, tgt_cap: int, c2: float,
                       n_src: int):
    """Plain twin of the stencil kernel over the cell records -> masks
    ``(B, n_src)``: per frame and offset, the neighbour cells' targets
    unshifted, one ``(n_cells, cap, tgt_cap)`` block of per-pair images ``d
    - L*round(d/L)`` (lengths from the frame's box diagonal) and ``(dx² +
    dy²) + dz²``, slots beyond the counts masked out, hits scattered through
    the source records' list positions below ``n_src``. Offsets that reach
    one cell (axes of 1 or 2 cells) repeat a test, which an OR ignores."""
    device = src_rec.device
    cells, _, _ = _image_cells(dims, (True, True, True), device)
    s_slots = torch.arange(cap, device=device)
    t_slots = torch.arange(tgt_cap, device=device)
    masks = torch.zeros((src_rec.shape[0], n_src), dtype=torch.bool, device=device)
    for f in range(src_rec.shape[0]):
        s = src_rec[f]
        sx, sy, sz = (s[:, :, k, None] for k in range(3))
        lx, ly, lz = boxes[f, 0, 0], boxes[f, 1, 1], boxes[f, 2, 2]
        tcount = counts[f, 1]
        hit = torch.zeros(s.shape[:2], dtype=torch.bool, device=device)
        for o in range(27):
            t = tgt_rec[f][cells[o]]
            valid = t_slots[None, :] < tcount[cells[o]][:, None]
            dx = t[:, None, :, 0] - sx
            dy = t[:, None, :, 1] - sy
            dz = t[:, None, :, 2] - sz
            dx = dx - lx * torch.round(dx / lx)
            dy = dy - ly * torch.round(dy / ly)
            dz = dz - lz * torch.round(dz / lz)
            d2 = dx * dx + dy * dy + dz * dz
            hit |= ((d2 <= c2) & valid[:, None, :]).any(dim=2)
        hit &= s_slots[None, :] < counts[f, 0][:, None]
        pos = s[..., 3].view(torch.int32)[hit].long()
        masks[f, pos[pos < n_src]] = True
    return masks


def within_rows(src_rec, tgt_rec, counts, boxes, dims, cap: int, tgt_cap: int, c2: float,
                n_src: int, cells_per_block: int = CELLS_PER_BLOCK):
    """Per-pair min-image stencil over :func:`~.neighbor_ghost.cell_bins`'
    records -> masks ``(B, n_src)`` bool: has each source a target within
    the cutoff under full PBC in the orthorhombic boxes ``boxes`` (B, 3, 3;
    the diagonal is read)? ``c2``: the squared cutoff, an f32 value. A
    source record whose list position is ``n_src`` or more writes nothing.
    Undefined for a frame whose binning overflowed. ``cells_per_block``
    shapes the launch only (1: a block per cell). CUDA tensors go to the
    kernel, CPU tensors to :func:`_rows_bins_stencil`; any other device
    raises.
    """
    nx, ny, nz = dims
    n_frames = src_rec.shape[0]
    _check_sizes("within_rows", dims, cap, tgt_cap, n_frames)
    if not 1 <= cells_per_block <= 32:
        raise ValueError(f"within_rows: cells_per_block={cells_per_block} outside [1, 32]")
    device = src_rec.device
    if device.type == "cpu":
        return _rows_bins_stencil(src_rec, tgt_rec, counts, boxes, dims, cap, tgt_cap, c2, n_src)
    if device.type != "cuda":
        raise ValueError(f"within_rows: the kernel takes CUDA tensors, got {device}")
    n_cells = nx * ny * nz
    _check("within_rows", "src_rec", src_rec, device, (n_frames, n_cells, cap, 4))
    _check("within_rows", "tgt_rec", tgt_rec, device, (n_frames, n_cells, tgt_cap, 4))
    _check("within_rows", "counts", counts, device, (n_frames, 2, n_cells), torch.int32)
    _check("within_rows", "boxes", boxes, device, (n_frames, 3, 3))
    lib = _lib()
    masks = torch.zeros((n_frames, n_src), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = lib.within_rows_launch(
            src_rec.data_ptr(), tgt_rec.data_ptr(), counts.data_ptr(), boxes.data_ptr(),
            masks.data_ptr(), n_frames, n_src, nx, ny, nz, cap, tgt_cap, cells_per_block, c2,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise _launch_error("within_rows", lib, err)
    within_rows.launches += 1
    return masks


within_rows.launches = 0


def within_mask_rows_window(coords, src_idx, tgt_idx, cutoff: float, boxes, invs, dims,
                            cap: int = 32, tgt_cap: int = 32, plain: bool = False):
    """The per-pair min-image search over a window of frames -> (masks (B,
    n_src) bool, overflow (B,) bool); a frame's mask is undefined when its
    flag is set. ``coords`` (B, N, 3) f32; ``src_idx`` int64 or None (every
    atom); ``tgt_idx`` int64; ``boxes``/``invs`` (B, 3, 3), orthorhombic,
    read on the coords' device (no host read, no host sync).

    CUDA tensors take :func:`~.neighbor_ghost.cell_bins` and
    :func:`within_rows` (two launches for the whole window); CPU tensors, or
    ``plain=True`` on any device, the plain twin frame by frame: the x-minor
    row planes, :func:`_rows_stencil` and the unsort.
    """
    n_src = coords.shape[1] if src_idx is None else src_idx.shape[0]
    c2 = _cutoff2(cutoff)
    if plain or coords.device.type == "cpu":
        masks, overflows = [], []
        for f in range(coords.shape[0]):
            src, tgt, lengths, s_slot, s_order, ofl = _rows_inputs(
                coords[f], src_idx, tgt_idx, boxes[f], invs[f], dims, cap, tgt_cap)
            hit = _rows_stencil(src, tgt, lengths, dims, cap, tgt_cap, c2)
            masks.append(_unsort_mask(hit, s_slot, s_order, n_src))
            overflows.append(ofl)
        return torch.stack(masks), torch.stack(overflows)
    src_rec, tgt_rec, counts, overflow = cell_bins(coords, src_idx, tgt_idx, boxes, invs, dims,
                                                   cap, tgt_cap)
    return within_rows(src_rec, tgt_rec, counts, boxes, dims, cap, tgt_cap, c2, n_src), overflow


def within_mask_rows(coords, src_idx, tgt_idx, cutoff: float, box, inv, dims, cap: int = 32,
                     tgt_cap: int = 32, plain: bool = False):
    """Boolean within mask for an orthorhombic box under full PBC
    (``within_mask_pallas``'s signature; ``src_idx=None`` means every
    atom): :func:`within_mask_rows_window` on a window of one. Returns
    (mask, overflow flag); the mask is undefined when the flag is set.
    ``plain`` runs the plain twin in the kernels' place on any device."""
    masks, overflow = within_mask_rows_window(coords[None], src_idx, tgt_idx, cutoff, box[None],
                                              inv[None], dims, cap, tgt_cap, plain)
    return masks[0], overflow[0]
