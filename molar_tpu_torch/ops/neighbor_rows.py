"""The row-tiled per-pair min-image ``within`` search: the hand-written CUDA
kernel and its plain twin.

Counterpart of ``molar_tpu.ops.neighbor_pallas.within_mask_pallas`` (and
its ``_kernel``), for orthorhombic boxes with full PBC. The cell grid is
laid out with x minor-most, ``(cy*nz + cz)*nx + cx``, so one cell row over
x is contiguous; the 27-cell stencil is 9 (dy, dz) neighbour rows times 3
x shifts, all taken modulo the grid, and every pair's image is resolved
on the spot as ``d - L*round(d/L)`` per axis. Source slots carry a
validity plane and target slots an additive d² penalty (0 for a real
target, 1e12 for a pad slot), as in the TPU kernel.

:func:`within_rows` launches ``csrc/within_rows.cu`` for CUDA tensors and
never falls back; for CPU tensors, and only for them, it runs the plain
twin :func:`_rows_stencil`. ``within_rows.launches`` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .neighbor import _blocked_planes, _cutoff2, _search_args, _unsort_mask
from .neighbor_ghost import _check

__all__ = ["within_mask_rows", "within_rows"]

_vp = ctypes.c_void_p
_int = ctypes.c_int

#: d² penalty of a pad target slot; the kernel ends a cell's slots at the
#: first penalty >= 1e11.
PAD_PENALTY = 1e12

_ROW_OFFSETS = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build_kernels()
    lib = ctypes.CDLL(str(path))
    lib.within_rows_launch.restype = _int
    lib.within_rows_launch.argtypes = [
        _vp, _vp, _vp, _vp,  # source planes x, y, z, validity (ny*nz, nx, cap)
        _vp, _vp, _vp, _vp,  # target planes x, y, z, penalty (ny*nz, nx, tgt_cap)
        _vp,                 # box lengths (3,) f32: Lx, Ly, Lz
        _vp,                 # hit out (ny*nz, nx, cap) bool
        _int, _int, _int, _int, _int,  # nx, ny, nz, cap, tgt_cap
        ctypes.c_float,      # cutoff^2
        _vp,                 # cudaStream_t
    ]
    lib.within_rows_error_string.restype = ctypes.c_char_p
    lib.within_rows_error_string.argtypes = [_int]
    return lib


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


def within_rows(src, tgt, lengths, dims, cap: int, tgt_cap: int, c2: float):
    """Row stencil -> hit blocks ``(ny*nz, nx, cap)`` bool.

    ``src``: source planes x, y, z, validity ``(ny*nz, nx, cap)``; ``tgt``:
    target planes x, y, z, penalty ``(ny*nz, nx, tgt_cap)``; ``lengths``:
    the box's diagonal ``(3,)``, on the planes' device; ``c2``: the squared
    cutoff, an f32 value. CUDA planes go to the kernel, CPU planes to
    :func:`_rows_stencil`; any other device raises.
    """
    nx, ny, nz = dims
    if min(dims) < 1 or cap < 1 or tgt_cap < 1:
        raise ValueError(f"within_rows: bad sizes dims={dims} cap={cap} tgt_cap={tgt_cap}")
    device = src[0].device
    if device.type == "cpu":
        return _rows_stencil(src, tgt, lengths, dims, cap, tgt_cap, c2)
    if device.type != "cuda":
        raise ValueError(f"within_rows: the kernel takes CUDA tensors, got {device}")
    for name, t in zip(("sx", "sy", "sz", "sval"), src):
        _check("within_rows", name, t, device, (ny * nz, nx, cap))
    for name, t in zip(("tx", "ty", "tz", "tpen"), tgt):
        _check("within_rows", name, t, device, (ny * nz, nx, tgt_cap))
    _check("within_rows", "lengths", lengths, device, (3,))
    lib = _lib()
    hit = torch.empty((ny * nz, nx, cap), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = lib.within_rows_launch(
            *(t.data_ptr() for t in src),
            *(t.data_ptr() for t in tgt),
            lengths.data_ptr(),
            hit.data_ptr(),
            nx, ny, nz, cap, tgt_cap, c2,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"within_rows kernel launch failed: {lib.within_rows_error_string(err).decode()}"
        )
    within_rows.launches += 1
    return hit


within_rows.launches = 0


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


def within_mask_rows(coords, src_idx, tgt_idx, cutoff: float, box, inv, dims, cap: int = 32,
                     tgt_cap: int = 32, plain: bool = False):
    """Boolean within mask for an orthorhombic box under full PBC, through
    the row stencil (``within_mask_pallas``'s signature; ``src_idx=None``
    means every atom). Returns (mask, overflow flag); the mask is undefined
    when the flag is set. ``plain`` runs the kernel's plain twin in its
    place on any device."""
    n_src = coords.shape[0] if src_idx is None else src_idx.shape[0]
    src, tgt, lengths, s_slot, s_order, ofl = _rows_inputs(
        coords, src_idx, tgt_idx, box, inv, dims, cap, tgt_cap)
    stencil = _rows_stencil if plain else within_rows
    hit = stencil(src, tgt, lengths, dims, cap, tgt_cap, _cutoff2(cutoff))
    return _unsort_mask(hit, s_slot, s_order, n_src), ofl
