"""The ghost-slab ``within`` search on the card: the two hand-written CUDA
kernels and their plain twins.

Counterpart of ``molar_tpu.ops.neighbor_pallas.within_ghost_pallas`` as a
whole (its XLA plane build, its Pallas kernel and its unsort), for a window
of frames in two launches:

* :func:`cell_bins` — ``csrc/cell_bin.cu``: a counting sort (one atomic slot
  per point) of every frame's sources and targets into fixed-capacity cells
  of 16-byte records ``(x, y, z, list position as int32 bits)``, with
  per-cell counts and a per-frame overflow flag; plain twin
  :func:`_cell_bins_plain`;
* :func:`within_ghost` — ``csrc/within_ghost.cu``: one block per (source
  cell, frame), the 27 neighbour cells' targets staged in shared memory and
  shifted into their periodic images on the way (:func:`_image_cells`,
  :func:`_image_shift`: wrap the neighbour index, then shift by the box
  column of x, then y, then z, as the ghost planes do), the mask written
  through each source's list position; plain twin :func:`_bins_stencil`.

Both are built by :mod:`molar_tpu_torch.build` and bound with ctypes (plain
C entry points, pointers and the stream as ``c_void_p``; :func:`_lib` also
binds ``csrc/within_rows.cu``'s, which :mod:`.neighbor_rows` wraps). Each
wrapper launches its kernel for CUDA tensors and never falls back: a build
failure, a refused launch or an unsupported input raises. For CPU tensors,
and only for them, it runs its plain twin. ``cell_bins.launches`` and
``within_ghost.launches`` count kernel launches and nothing else.

:func:`_ghost_stencil` is the plain stencil over ghost-padded planes, the
twin that :func:`.neighbor.within_mask_window` runs on the CPU (and with
``plain=True``), held bit for bit against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_vp = ctypes.c_void_p
_int = ctypes.c_int

_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]

# Grid dimension y of a launch: one frame each.
_MAX_FRAMES = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build_kernels()
    lib = ctypes.CDLL(str(path))
    lib.cell_bin_launch.restype = _int
    lib.cell_bin_launch.argtypes = [
        _vp,            # coords (B, n_atoms, 3) f32
        _vp, _vp,       # src_idx (n_src,) i64 or null, tgt_idx (n_tgt,) i64
        _vp, _vp,       # boxes, invs (B, 3, 3) f32
        _vp, _vp,       # src_rec (B, n_cells, cap, 4), tgt_rec (B, n_cells, tgt_cap, 4) f32
        _vp, _vp,       # counts (B, 2, n_cells) i32, overflow (B,) bool; zeroed
        _int, _int, _int, _int,  # B, n_atoms, n_src, n_tgt
        _int, _int, _int, _int, _int,  # nx, ny, nz, cap, tgt_cap
        _vp,            # cudaStream_t
    ]
    lib.within_ghost_launch.restype = _int
    lib.within_ghost_launch.argtypes = [
        _vp, _vp, _vp,  # src_rec, tgt_rec, counts as cell_bin_launch leaves them
        _vp,            # boxes (B, 3, 3) f32
        _vp,            # mask out (B, n_src) bool, zeroed
        _int, _int,     # B, n_src
        _int, _int, _int, _int, _int,  # nx, ny, nz, cap, tgt_cap
        _int, _int, _int,  # pbc x, y, z
        ctypes.c_float,  # cutoff^2
        _vp,            # cudaStream_t
    ]
    lib.within_rows_launch.restype = _int
    lib.within_rows_launch.argtypes = [
        _vp, _vp, _vp,  # src_rec, tgt_rec, counts as cell_bin_launch leaves them
        _vp,            # boxes (B, 3, 3) f32, diagonal
        _vp,            # mask out (B, n_src) bool, zeroed
        _int, _int,     # B, n_src
        _int, _int, _int, _int, _int,  # nx, ny, nz, cap, tgt_cap
        _int,           # cells per block
        ctypes.c_float,  # cutoff^2
        _vp,            # cudaStream_t
    ]
    lib.within_ghost_error_string.restype = ctypes.c_char_p
    lib.within_ghost_error_string.argtypes = [_int]
    return lib


def _check(kernel, name, t, device, shape, dtype=torch.float32):
    """Raise unless input ``name`` of ``kernel`` is a contiguous ``dtype``
    tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {str(dtype)[6:]}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _check_sizes(kernel, dims, cap, tgt_cap, n_frames):
    if min(dims) < 1 or cap < 1 or tgt_cap < 1 or not 1 <= n_frames <= _MAX_FRAMES:
        raise ValueError(f"{kernel}: bad sizes dims={dims} cap={cap} tgt_cap={tgt_cap} "
                         f"frames={n_frames}")


def _launch_error(kernel, lib, err):
    return RuntimeError(f"{kernel} kernel launch failed: "
                        f"{lib.within_ghost_error_string(err).decode()}")


# ------------------------------------------------------------ periodic images


def _image_cells(dims, pbc, device):
    """The 27 neighbours of every cell, in :data:`_OFFSETS` order ->
    (cell ids (27, n_cells), image shifts (27, n_cells, 3) in {-1, 0, 1},
    exists (27, n_cells)). A neighbour index past an edge wraps with a shift
    of -1 (below 0) or +1 (past n - 1); on a non-periodic axis it does not
    exist. Offsets that reach one cell (axes of 1 or 2 cells) stay apart."""
    nx, ny, nz = dims
    ids = torch.arange(nx * ny * nz, device=device)
    own = (ids // (ny * nz), (ids // nz) % ny, ids % nz)
    off = torch.tensor(_OFFSETS, device=device)
    ok = torch.ones((27, ids.shape[0]), dtype=torch.bool, device=device)
    cells, shifts = [], []
    for a, n in enumerate(dims):
        c = own[a][None, :] + off[:, a: a + 1]
        s = (c >= n).long() - (c < 0).long()
        if not pbc[a]:
            ok &= s == 0
        cells.append(c - s * n)
        shifts.append(s)
    return (cells[0] * ny + cells[1]) * nz + cells[2], torch.stack(shifts, -1), ok


def _image_shift(x, y, z, box, shifts):
    """Component planes shifted into their periodic images: for the x, then
    y, then z axis, add (shift +1) or subtract (shift -1) the box column of
    that axis — the operations ``neighbor._ghost_planes`` applies to its
    border cells, in its order. ``shifts`` (..., 3) broadcasts against the
    planes."""
    v = (x, y, z)
    for a in range(3):
        s = shifts[..., a]
        v = tuple(torch.where(s > 0, c + box[d, a], torch.where(s < 0, c - box[d, a], c))
                  for d, c in enumerate(v))
    return v


# ------------------------------------------------------------ binning


def _cell_bins_plain(coords, src_idx, tgt_idx, boxes, invs, dims, cap: int, tgt_cap: int):
    """Plain twin of the binning kernel, frame by frame through the plain
    search's own plane build (``neighbor._search_args`` +
    ``neighbor._blocked_planes``): the same records, counts and flags, with
    each cell's slots in list order. Pad slots hold zeros."""
    from .neighbor import _blocked_planes, _search_args

    nx, ny, nz = dims
    n_cells = nx * ny * nz
    recs, counts, overflow = ([], []), [], []
    for f in range(coords.shape[0]):
        sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz = _search_args(
            coords[f], src_idx, tgt_idx, boxes[f], invs[f], dims)
        tflat = (tcx * ny + tcy) * nz + tcz
        cnt, ofl = [], []
        for k, (pts, flat, kcap) in enumerate((((sx, sy, sz), sflat, cap),
                                                ((tx, ty, tz), tflat, tgt_cap))):
            pos = torch.arange(flat.shape[0], dtype=torch.int32, device=coords.device)
            planes, *_, o = _blocked_planes([*pts, pos.view(torch.float32)], flat, n_cells,
                                            kcap, [0.0] * 4)
            recs[k].append(torch.stack(planes, -1))
            cnt.append(torch.bincount(flat.long(), minlength=n_cells).to(torch.int32))
            ofl.append(o)
        counts.append(torch.stack(cnt))
        overflow.append(ofl[0] | ofl[1])
    return torch.stack(recs[0]), torch.stack(recs[1]), torch.stack(counts), torch.stack(overflow)


def cell_bins(coords, src_idx, tgt_idx, boxes, invs, dims, cap: int, tgt_cap: int):
    """Bin a window's sources and targets into cells -> (src_rec (B, n_cells,
    cap, 4) f32, tgt_rec (B, n_cells, tgt_cap, 4) f32, counts (B, 2,
    n_cells) int32, overflow (B,) bool).

    ``coords`` (B, N, 3) f32; ``src_idx`` (n_src,) int64 or None (every
    atom); ``tgt_idx`` (n_tgt,) int64; ``boxes``/``invs`` (B, 3, 3) f32 on
    the coords' device. A record is the wrapped lab coordinate and the
    point's position in its list (int32 bits in the fourth lane); slots
    beyond a cell's count are undefined, and so is everything when the
    frame's overflow flag is set (a cell over its capacity, or, in the
    kernel, an index outside the frame). CUDA tensors go to the kernel, CPU tensors
    to :func:`_cell_bins_plain`; any other device raises.
    """
    nx, ny, nz = dims
    n_frames = coords.shape[0]
    _check_sizes("cell_bins", dims, cap, tgt_cap, n_frames)
    device = coords.device
    if device.type == "cpu":
        return _cell_bins_plain(coords, src_idx, tgt_idx, boxes, invs, dims, cap, tgt_cap)
    if device.type != "cuda":
        raise ValueError(f"cell_bins: the kernel takes CUDA tensors, got {device}")
    n_atoms = coords.shape[1]
    _check("cell_bins", "coords", coords, device, (n_frames, n_atoms, 3))
    _check("cell_bins", "boxes", boxes, device, (n_frames, 3, 3))
    _check("cell_bins", "invs", invs, device, (n_frames, 3, 3))
    n_src = n_atoms if src_idx is None else src_idx.shape[0]
    if src_idx is not None:
        _check("cell_bins", "src_idx", src_idx, device, (n_src,), torch.int64)
    _check("cell_bins", "tgt_idx", tgt_idx, device, (tgt_idx.shape[0],), torch.int64)
    lib = _lib()
    n_cells = nx * ny * nz
    src_rec = torch.empty((n_frames, n_cells, cap, 4), dtype=torch.float32, device=device)
    tgt_rec = torch.empty((n_frames, n_cells, tgt_cap, 4), dtype=torch.float32, device=device)
    counts = torch.zeros((n_frames, 2, n_cells), dtype=torch.int32, device=device)
    overflow = torch.zeros(n_frames, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = lib.cell_bin_launch(
            coords.data_ptr(), None if src_idx is None else src_idx.data_ptr(),
            tgt_idx.data_ptr(), boxes.data_ptr(), invs.data_ptr(), src_rec.data_ptr(),
            tgt_rec.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            n_frames, n_atoms, n_src, tgt_idx.shape[0], nx, ny, nz, cap, tgt_cap,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise _launch_error("cell_bins", lib, err)
    cell_bins.launches += 1
    return src_rec, tgt_rec, counts, overflow


cell_bins.launches = 0


# ------------------------------------------------------------ stencil


def _ghost_stencil(src, ghost, dims, cap: int, tgt_cap: int, c2: float):
    """Plain 27-cell stencil over ghost-padded planes -> hit blocks
    ``(n_cells, cap)``.

    ``src``: source planes x, y, z ``(n_cells, cap)``; ``ghost``: target
    planes x, y, z ``(nx+2, ny+2, nz+2, tgt_cap)`` whose border cells hold
    the shifted images; pad slots hold sentinels. One ``(n_cells, cap,
    tgt_cap)`` distance block per offset, the target block a contiguous
    slice of the ghost planes, ``(dx² + dy²) + dz²`` with ``d = target -
    source``.
    """
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    sxb3, syb3, szb3 = (s[:, :, None] for s in src)
    gx, gy, gz = ghost
    hit = torch.zeros(sxb3.shape[:2], dtype=torch.bool, device=sxb3.device)
    for ox, oy, oz in _OFFSETS:
        a, b, c = ox + 1, oy + 1, oz + 1
        ntx = gx[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        nty = gy[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        ntz = gz[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        dx = ntx - sxb3
        dy = nty - syb3
        dz = ntz - szb3
        d2 = dx * dx + dy * dy + dz * dz
        hit |= (d2 <= c2).any(dim=2)
    return hit


def _bins_stencil(src_rec, tgt_rec, counts, boxes, dims, cap: int, tgt_cap: int, pbc,
                  c2: float, n_src: int):
    """Plain twin of the stencil kernel over the cell records -> masks
    ``(B, n_src)``: per frame and offset, the neighbour cells' targets in
    their images (:func:`_image_cells`, :func:`_image_shift`), one ``(n_cells,
    cap, tgt_cap)`` block of ``(dx² + dy²) + dz²``, slots beyond the counts
    masked out, hits scattered through the source records' list
    positions below ``n_src``."""
    device = src_rec.device
    cells, shifts, ok = _image_cells(dims, pbc, device)
    s_slots = torch.arange(cap, device=device)
    t_slots = torch.arange(tgt_cap, device=device)
    masks = torch.zeros((src_rec.shape[0], n_src), dtype=torch.bool, device=device)
    for f in range(src_rec.shape[0]):
        s = src_rec[f]
        sx, sy, sz = (s[:, :, k, None] for k in range(3))
        tcount = counts[f, 1]
        hit = torch.zeros(s.shape[:2], dtype=torch.bool, device=device)
        for o in range(27):
            t = tgt_rec[f][cells[o]]
            tx, ty, tz = _image_shift(t[..., 0], t[..., 1], t[..., 2], boxes[f],
                                      shifts[o][:, None, :])
            valid = ok[o][:, None] & (t_slots[None, :] < tcount[cells[o]][:, None])
            dx = tx[:, None, :] - sx
            dy = ty[:, None, :] - sy
            dz = tz[:, None, :] - sz
            d2 = dx * dx + dy * dy + dz * dz
            hit |= ((d2 <= c2) & valid[:, None, :]).any(dim=2)
        hit &= s_slots[None, :] < counts[f, 0][:, None]
        pos = s[..., 3].view(torch.int32)[hit].long()
        masks[f, pos[pos < n_src]] = True
    return masks


def within_ghost(src_rec, tgt_rec, counts, boxes, dims, cap: int, tgt_cap: int, pbc, c2: float,
                 n_src: int):
    """27-cell stencil over :func:`cell_bins`' records -> masks ``(B,
    n_src)`` bool: has each source a target within the cutoff under the
    periodic images of ``pbc``? ``c2``: the squared cutoff, an f32 value.
    A source record whose list position is ``n_src`` or more writes
    nothing. Undefined for a frame whose binning overflowed. CUDA tensors go to the
    kernel, CPU tensors to :func:`_bins_stencil`; any other device raises.
    """
    nx, ny, nz = dims
    n_frames = src_rec.shape[0]
    _check_sizes("within_ghost", dims, cap, tgt_cap, n_frames)
    device = src_rec.device
    if device.type == "cpu":
        return _bins_stencil(src_rec, tgt_rec, counts, boxes, dims, cap, tgt_cap, pbc, c2, n_src)
    if device.type != "cuda":
        raise ValueError(f"within_ghost: the kernel takes CUDA tensors, got {device}")
    n_cells = nx * ny * nz
    _check("within_ghost", "src_rec", src_rec, device, (n_frames, n_cells, cap, 4))
    _check("within_ghost", "tgt_rec", tgt_rec, device, (n_frames, n_cells, tgt_cap, 4))
    _check("within_ghost", "counts", counts, device, (n_frames, 2, n_cells), torch.int32)
    _check("within_ghost", "boxes", boxes, device, (n_frames, 3, 3))
    lib = _lib()
    masks = torch.zeros((n_frames, n_src), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = lib.within_ghost_launch(
            src_rec.data_ptr(), tgt_rec.data_ptr(), counts.data_ptr(), boxes.data_ptr(),
            masks.data_ptr(), n_frames, n_src, nx, ny, nz, cap, tgt_cap,
            *(int(bool(p)) for p in pbc), c2,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise _launch_error("within_ghost", lib, err)
    within_ghost.launches += 1
    return masks


within_ghost.launches = 0
