"""Exact Lee-Richards SASA in torch (batched, fixed-capacity).

Counterpart of ``molar_tpu.ops.sasa_lr``: the same Lee-Richards slicing as
the host ground truth of the JAX package, as dense tensor math that runs on
an explicit device over one frame or a window of frames:

* per atom: ``n_slices`` z-slabs relative to its own centre;
* per (atom, slice, neighbour): the neighbour's covering angular interval on
  the slice circle, wrap-split into two ``[lo, hi]`` slots in [-pi, pi]
  (an empty slot is the negative-length sentinel ``[pi, -pi]``);
* the exact union length of the 2K intervals by a stable sort on ``lo``
  (``hi`` gathered through the sort's indices) and a running maximum:
  ``sum_i max(0, hi_i - max(lo_i, cummax_{j<i} hi_j))``;
* exposed arc * R * dz accumulates the band area.

Neighbour lists are fixed-capacity ``(N, K)`` index arrays padded with -1.
:func:`neighbor_lists_device` builds them on the device from a non-periodic
cell grid, frame by frame of a window in one batched program, with an
overflow flag a frame; when the flag is set the lists are UNDEFINED (clipped
ranks share slots) and the caller retries at larger capacities.
:func:`sasa_window` is the two together: nothing in it waits on the host.

The device functions take tensors and compute where those tensors live. The
work is cut into blocks of (frame, atom) rows under an element budget
(:data:`BLOCK_ELEMS`): one frame of 4,000 atoms x 32 slices x 2 x 176 slots
is 45 M elements a temporary.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import config  # noqa: F401  (pins fp32 products)
from .neighbor import _blocked_planes, estimate_caps, grid_dims

DEFAULT_PROBE = 0.14

#: Elements of one (rows, slices, 2K) interval block of :func:`sasa` and of
#: one (frames, N, 27 * cell_cap) candidate block of the list build. From a
#: sweep on an NVIDIA H100 80GB HBM3 (``chip_smoke.py``, ``sasa_path``).
BLOCK_ELEMS = 1 << 26

# pi as float32 holds it, so that every use rounds as an f32 constant does.
_PI = float(np.float32(np.pi))
# Upper clamp of a fractional cell coordinate: the f32 value of 1 - 1e-7.
_FRAC_MAX = float(np.float32(1.0 - 1e-7))
# Pad coordinate of the cell planes.
_BIG = 1e17


def _dense_pairs(coords, radii, skin, block: int = 1024):
    """Ordered pairs (i, j), i != j, with ``|xi - xj| < ri + rj + skin``
    (float64), by a blocked dense distance test, sorted by i then j."""
    n = len(coords)
    owners, others = [], []
    for s in range(0, n, block):
        d = coords[s:s + block, None, :] - coords[None, :, :]
        hit = np.sqrt((d * d).sum(-1)) < radii[s:s + block, None] + radii[None, :] + skin
        hit[np.arange(len(hit)), s + np.arange(len(hit))] = False
        i, j = np.nonzero(hit)
        owners.append(i + s)
        others.append(j)
    if not owners:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(owners), np.concatenate(others)


def _fill_lists(owners, others, n: int, cap: int):
    """Pairs sorted by owner -> ((n, cap) int32 lists padded -1, overflowed)."""
    out = np.full((n, cap), -1, np.int32)
    starts = np.searchsorted(owners, np.arange(n))
    rank = np.arange(len(owners)) - starts[owners]
    ok = rank < cap
    out[owners[ok], rank[ok]] = others[ok]
    return out, bool(np.any(~ok))


def neighbor_lists(coords, radii, cap: int, skin: float = 0.0):
    """Host-side fixed-capacity neighbour lists for LR-SASA (numpy).

    Neighbours = atoms j with ``|xi - xj| < ri + rj + skin`` (the spheres
    whose expanded radii can clip atom i's circles while no atom has moved
    more than skin/2). Returns ((N, cap) int32 padded with -1, overflowed).
    Each list is in index order.
    """
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(radii, np.float64)
    owners, others = _dense_pairs(coords, radii, skin)
    return _fill_lists(owners, others, len(coords), cap)


def max_displacement(coords, build_coords):
    """Max atom displacement since the neighbour list build (a 0-d tensor);
    the list is valid while this is < skin/2."""
    d = coords - build_coords
    return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))


def _exposed_arcs(cx, cy, cz, ri, xj, yj, zj, rj, valid_n, ks, n_slices: int):
    """Sum over the slices ``ks`` (slice index + 0.5, f32 (S,)) of each
    row's exposed angle. Row tensors (R,), neighbour tensors (R, K)."""
    dx = xj - cx[:, None]
    dy = yj - cy[:, None]
    dxy = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)

    dz = 2 * ri / n_slices
    zrel = -ri[:, None] + dz[:, None] * ks[None, :]  # (R, S): z - zi
    rk2 = ri[:, None] ** 2 - zrel**2
    rk = torch.sqrt(torch.clamp_min(rk2, 0.0))
    slice_live = rk2 > 0

    # The neighbour's circle radius in each slab: (R, S, K).
    dzj = (cz[:, None, None] + zrel[:, :, None]) - zj[:, None, :]
    cj2 = rj[:, None, :] ** 2 - dzj * dzj
    cj = torch.sqrt(torch.clamp_min(cj2, 0.0))
    act = valid_n[:, None, :] & (cj2 > 0) & slice_live[:, :, None]
    del dzj, cj2

    d3 = dxy[:, None, :]
    r3 = rk[:, :, None]
    no_ovl = d3 >= r3 + cj
    fully = (d3 + r3 <= cj) & act
    inside = d3 + cj <= r3
    covers = act & ~no_ovl & ~fully & ~inside
    any_full = fully.any(dim=2)
    del act, no_ovl, fully, inside

    denom = torch.where(covers, 2 * d3 * r3, 1.0)
    half = torch.acos(torch.clamp((d3 * d3 + r3 * r3 - cj * cj) / denom, -1.0, 1.0))
    del denom, cj
    lo = theta[:, None, :] - half
    hi = theta[:, None, :] + half
    del half
    # Wrap-split into two slots a neighbour. A neighbour wraps on at most
    # one side, so the two wrap pieces share the second slot via min/max.
    lo_wrap = covers & (lo < -_PI)
    hi_wrap = covers & (hi > _PI)
    los = torch.cat([
        torch.where(covers, torch.clamp_min(lo, -_PI), _PI),
        torch.minimum(torch.where(lo_wrap, lo + 2 * _PI, _PI), torch.where(hi_wrap, -_PI, _PI)),
    ], dim=2)
    his = torch.cat([
        torch.where(covers, torch.clamp_max(hi, _PI), -_PI),
        torch.maximum(torch.where(lo_wrap, _PI, -_PI), torch.where(hi_wrap, hi - 2 * _PI, -_PI)),
    ], dim=2)
    del lo, hi, lo_wrap, hi_wrap, covers

    # Union sweep: sort by lo (stable, hi moved with it), running max of hi.
    lo_s, order = torch.sort(los, dim=2, stable=True)
    hi_s = torch.gather(his, 2, order)
    del los, his, order
    prev = torch.empty_like(hi_s)
    prev[:, :, 0] = -_PI
    prev[:, :, 1:] = torch.cummax(hi_s, dim=2).values[:, :, :-1]
    union = torch.clamp_min(hi_s - torch.maximum(lo_s, prev), 0.0).sum(dim=2)

    exposed = torch.where(slice_live & ~any_full, 2 * _PI - union, 0.0)
    return exposed.sum(dim=1)


def _row_block(block, n_rows: int, per_row: int) -> int:
    """Rows of one block: ``block`` when given, else as many as keep
    ``rows * per_row`` under :data:`BLOCK_ELEMS` (at least one)."""
    if block:
        return int(block)
    return int(max(1, min(n_rows, BLOCK_ELEMS // max(1, per_row))))


def _flat_rows(coords, radii, nbr):
    """A frame ``(N, 3)`` or a window ``(B, N, 3)`` as (frame, atom) rows:
    coordinate columns (R,), radii (R,), and lists (R, K) whose entries
    index the rows of their own frame (pads stay -1)."""
    coords = torch.as_tensor(coords)
    radii = torch.as_tensor(radii, dtype=coords.dtype, device=coords.device)
    nbr = torch.as_tensor(nbr, device=coords.device)
    if coords.dim() == 2:
        return coords, radii, nbr
    b, n = coords.shape[:2]
    if nbr.dim() == 2:
        nbr = nbr.expand(b, *nbr.shape)
    base = (torch.arange(b, device=coords.device, dtype=nbr.dtype) * n)[:, None, None]
    nbr = torch.where(nbr >= 0, nbr + base, nbr).reshape(b * n, -1)
    return coords.reshape(b * n, 3), radii.repeat(b), nbr


@torch.no_grad()
def sasa(coords, radii, nbr, n_slices: int = 64, block=None):
    """Per-atom exact Lee-Richards SASA.

    ``coords`` (N, 3) or a window (B, N, 3); ``radii`` (N,) = vdw + probe;
    ``nbr`` (N, K), or (B, N, K) for a window, padded with -1. Returns the
    areas, (N,) or (B, N). ``block`` is the number of (frame, atom) rows
    evaluated at once; None sizes it so that rows x slices x 2K stays under
    :data:`BLOCK_ELEMS`. Matches the host Lee-Richards of the JAX package at
    the same ``n_slices`` to float32 accuracy.
    """
    shape = torch.as_tensor(coords).shape[:-1]
    c, r, nb = _flat_rows(coords, radii, nbr)
    n_rows, k = nb.shape
    ks = torch.arange(n_slices, dtype=c.dtype, device=c.device) + 0.5
    x, y, z = c[:, 0].contiguous(), c[:, 1].contiguous(), c[:, 2].contiguous()
    step = _row_block(block, n_rows, n_slices * 2 * k)
    out = []
    for s in range(0, n_rows, step):
        nbb = nb[s:s + step]
        valid_n = nbb >= 0
        nbs = nbb.clamp_min(0).long()
        ri = r[s:s + step]
        arcs = _exposed_arcs(x[s:s + step], y[s:s + step], z[s:s + step], ri,
                             x[nbs], y[nbs], z[nbs], r[nbs], valid_n, ks, n_slices)
        out.append(arcs * ri * (2 * ri / n_slices))
    if not out:
        return c.new_zeros(shape)
    return torch.cat(out).reshape(shape)


@torch.no_grad()
def neighbor_lists_device(coords, radii, extents, dims, cell_cap: int, k_cap: int,
                          max_pairs: int = 0, skin: float = 0.0):
    """Fixed-capacity LR-SASA neighbour lists built on the device.

    ``coords`` (N, 3) or a window (B, N, 3), inside ``[0, extents)`` (a
    non-periodic grid of ``dims`` cells; the clip puts out-of-box points
    into border cells). Cell-blocked coordinate, radius and id planes, the
    27 neighbour cells of each atom's cell in the stencil's offset order,
    the ``|xi - xj| < ri + rj + skin`` test, then a per-row exclusive rank
    over the (27 * cell_cap) candidates and a scatter into the (N, k_cap)
    rows: every non-hit writes one dump slot. ``max_pairs`` is accepted as
    in the JAX package and unused. Returns ((N, k_cap) int32 padded -1,
    overflow), or ((B, N, k_cap), (B,)): overflow covers cell and row
    capacity, and the lists are undefined where it is set. Each list is in
    offset-major, then cell-slot (index) order, as the JAX package's.
    """
    coords = torch.as_tensor(coords)
    single = coords.dim() == 2
    if single:
        coords = coords[None]
    b, n = coords.shape[:2]
    device, dtype = coords.device, coords.dtype
    radii = torch.as_tensor(radii, dtype=dtype, device=device)
    nx, ny, nz = (int(d) for d in dims)
    n_cells = nx * ny * nz
    if n == 0:
        lists = torch.full((b, 0, k_cap), -1, dtype=torch.int32, device=device)
        flags = torch.zeros(b, dtype=torch.bool, device=device)
        return (lists[0], flags[0]) if single else (lists, flags)
    # Nothing here copies from the host (a window must not wait on it):
    # constants are filled or counted out on the device. The extents are
    # 0-d device tensors so that ``x / extent`` is a true f32 division by
    # the f32 extent (a host scalar would become a product by a reciprocal).
    ext = [torch.full((), float(np.float32(e)), dtype=dtype, device=device) for e in extents]
    o27 = torch.arange(27, dtype=torch.int32, device=device)
    offs = (o27 // 9 - 1, o27 // 3 % 3 - 1, o27 % 3 - 1)  # the stencil's offset order
    rows_f = torch.arange(n, dtype=torch.int32, device=device)
    fills = [_BIG, _BIG, _BIG, 0.0, -1]

    lists, flags = [], []
    step = max(1, BLOCK_ELEMS // max(1, n * 27 * cell_cap))
    for s in range(0, b, step):
        c = coords[s:s + step]
        f = c.shape[0]
        cell = [torch.clamp_max((torch.clamp(c[..., a] / ext[a], 0.0, _FRAC_MAX) * d)
                                .to(torch.int32), d - 1) for a, d in enumerate((nx, ny, nz))]
        flat = (cell[0] * ny + cell[1]) * nz + cell[2]  # (f, N)
        frame0 = torch.arange(f, dtype=torch.int32, device=device)[:, None] * n_cells
        gflat = (flat + frame0).reshape(-1)
        # Every frame's cells side by side: one stable sort bins the block.
        (xb, yb, zb, rb, ib), _, _, _ = _blocked_planes(
            [c[..., 0].reshape(-1), c[..., 1].reshape(-1), c[..., 2].reshape(-1),
             radii.repeat(f), rows_f.repeat(f)], gflat, f * n_cells, cell_cap, fills)
        occupancy = torch.zeros(f * n_cells, dtype=torch.int32, device=device)
        occupancy.index_add_(0, gflat.long(), torch.ones_like(gflat))
        cell_ofl = (occupancy > cell_cap).view(f, n_cells).any(dim=1)

        ncell = [cell[a][:, :, None] + offs[a] for a in range(3)]  # (f, N, 27) each
        ok = ((ncell[0] >= 0) & (ncell[0] < nx) & (ncell[1] >= 0) & (ncell[1] < ny)
              & (ncell[2] >= 0) & (ncell[2] < nz))
        cells = torch.where(ok, (ncell[0] * ny + ncell[1]) * nz + ncell[2], 0)
        cells = (cells + frame0[:, :, None]).long()

        def cand(plane):  # (f, N, 27 * cell_cap), offset-major
            return plane[cells].reshape(f, n, 27 * cell_cap)

        dx = cand(xb) - c[..., 0:1]
        dy = cand(yb) - c[..., 1:2]
        dz = cand(zb) - c[..., 2:3]
        rr = cand(rb) + radii[None, :, None] + skin
        inb = cand(ib)
        hit = (ok[..., None].expand(f, n, 27, cell_cap).reshape(f, n, -1)
               & (inb >= 0) & (dx * dx + dy * dy + dz * dz < rr * rr)
               & (inb != rows_f[None, :, None]))
        del dx, dy, dz, rr
        hit32 = hit.to(torch.int32)
        rank = torch.cumsum(hit32, dim=2, dtype=torch.int32) - hit32  # exclusive
        row = torch.arange(f * n, dtype=torch.int64, device=device).view(f, n, 1)
        dump = f * n * k_cap
        slot = torch.where(hit & (rank < k_cap), row * k_cap + rank, dump)
        out = torch.full((dump + 1,), -1, dtype=torch.int32, device=device)
        out[slot.reshape(-1)] = torch.where(hit, inb, -1).reshape(-1)
        lists.append(out[:dump].view(f, n, k_cap))
        flags.append(cell_ofl | (hit32.sum(dim=2) > k_cap).any(dim=1))
    lists, flags = torch.cat(lists), torch.cat(flags)
    return (lists[0], flags[0]) if single else (lists, flags)


@torch.no_grad()
def sasa_window(coords, radii, extents, dims, cell_cap: int, k_cap: int, max_pairs: int = 0,
                n_slices: int = 32, block=None):
    """Exact LR-SASA for a (B, N, 3) window: the list build and the
    evaluation of every frame, with no host rebuild, no drift check and no
    wait on the host. Returns (areas (B, N), overflow (B,)); on overflow
    retry with larger caps (the fixed-capacity + retry contract)."""
    nbr, ofl = neighbor_lists_device(coords, radii, extents, dims, cell_cap, k_cap, max_pairs)
    return sasa(coords, radii, nbr, n_slices=n_slices, block=block), ofl


def band_neighbor_lists(coords, radii, nbr, n_slices: int, n_bands: int = 8, skin: float = 0.3,
                        w_round: int = 32):
    """Z-banded neighbour windows for :func:`sasa_banded` (numpy, at build).

    Sorts each atom's neighbour list by dz = z_j - z_i and finds, for each
    of ``n_bands`` groups of consecutive z-slices, the contiguous window of
    z-sorted neighbours that can possibly clip any slice of that band,
    inclusive with ``rmax + skin`` slack: extra neighbours are possible (a
    non-covering neighbour contributes nothing) but a covering neighbour is
    never missed while drift stays < skin/2.

    Returns (nbz (N, K+W) z-sorted ids padded -1, starts (N, G) int32, W,
    G). The per-band interval union then sorts 2W instead of 2K slots.
    """
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(radii, np.float64)
    nbr = np.asarray(nbr)
    n, k = nbr.shape
    g = n_bands
    valid = nbr >= 0
    nbs = np.maximum(nbr, 0)
    dz = np.where(valid, coords[:, 2][nbs] - coords[:, 2][:, None], np.inf)
    ordz = np.argsort(dz, axis=1)
    nbz = np.take_along_axis(np.where(valid, nbr, -1), ordz, axis=1)
    dzs = np.take_along_axis(dz, ordz, axis=1)  # sorted, inf-padded
    rmax = float(radii.max())
    ri = radii[:, None]
    gs = np.arange(g)[None, :]
    band_h = 2 * ri / g
    lo = -ri + gs * band_h - (rmax + skin)
    hi = -ri + (gs + 1) * band_h + (rmax + skin)
    starts = (dzs[:, None, :] < lo[:, :, None]).sum(2).astype(np.int32)
    ends = (dzs[:, None, :] <= hi[:, :, None]).sum(2).astype(np.int32)
    w = int((ends - starts).max()) if n else 1
    w = max((w + w_round - 1) // w_round * w_round, w_round)
    nbz_pad = np.concatenate([nbz, np.full((n, w), -1, nbz.dtype)], axis=1).astype(np.int32)
    return nbz_pad, starts, w, g


@torch.no_grad()
def sasa_banded(coords, radii, nbz, starts, w: int, g: int, n_slices: int = 64, block=None):
    """Exact Lee-Richards SASA with z-banded neighbour windows (one frame).

    Same math and slab placement as :func:`sasa` (equal up to float
    summation order), but each group of ``n_slices / g`` consecutive slices
    only considers its precomputed window of ``w`` z-sorted neighbours
    (:func:`band_neighbor_lists`): the union sort runs at 2w slots.
    """
    coords = torch.as_tensor(coords)
    device, dtype = coords.device, coords.dtype
    radii = torch.as_tensor(radii, dtype=dtype, device=device)
    nbz = torch.as_tensor(nbz, device=device)
    starts = torch.as_tensor(starts, device=device)
    n = coords.shape[0]
    if n_slices % g:
        raise ValueError("n_slices must divide into n_bands")
    sg = n_slices // g
    x, y, z = coords[:, 0].contiguous(), coords[:, 1].contiguous(), coords[:, 2].contiguous()
    win = torch.arange(w, device=device)
    step = _row_block(block, n, sg * 2 * w)
    out = []
    for s in range(0, n, step):
        ri = radii[s:s + step]
        arcs = torch.zeros_like(ri)
        for gi in range(g):
            cols = starts[s:s + step, gi].long()[:, None] + win[None, :]
            nb = torch.gather(nbz[s:s + step], 1, cols)
            nbs = nb.clamp_min(0).long()
            ks = gi * sg + torch.arange(sg, dtype=dtype, device=device) + 0.5
            arcs = arcs + _exposed_arcs(x[s:s + step], y[s:s + step], z[s:s + step], ri,
                                        x[nbs], y[nbs], z[nbs], radii[nbs], nb >= 0, ks,
                                        n_slices)
        out.append(arcs * ri * (2 * ri / n_slices))
    if not out:
        return coords.new_zeros(0)
    return torch.cat(out)


class SasaSeries:
    """Reusable exact-SASA evaluator for trajectories.

    Host mode keeps a fixed-capacity Verlet neighbour list alive and
    rebuilds it (numpy) only when an atom drifted more than skin/2 from its
    build position. ``update(coords)`` returns the exact per-atom areas for
    the new coordinates, a tensor on ``device``.

    >>> ss = SasaSeries(coords0, vdw, probe=0.14, device="cuda")
    >>> areas_t = [ss.update(c).cpu().numpy() for c in frames]

    Passing ``extents=`` (box extents, coords in [0, ext)), or ``box=`` with
    an orthorhombic (3, 3) matrix (columns are the box vectors), which
    derives them, selects device mode: skin=0 fixed-capacity lists rebuilt
    on the device inside every evaluation, the static caps escalated on
    overflow. ``device`` None is the first CUDA device; there is no
    fallback to the CPU.
    """

    def __init__(self, coords, vdw, probe: float = DEFAULT_PROBE, skin: float = 0.2,
                 n_slices: int = 64, cap: int = 96, block=None, extents=None, box=None,
                 device=None):
        self.device = config.resolve_device(device)
        if extents is None and box is not None:
            # A triclinic box falls back to host-Verlet mode: the device
            # grid assumes an axis-aligned cell.
            m = np.asarray(getattr(box, "matrix", box), np.float64)
            if np.allclose(m, np.diag(np.diag(m)), atol=1e-9):
                extents = tuple(np.diag(m))
        self.radii_np = np.asarray(vdw, np.float64) + probe
        self.skin = skin
        self.n_slices = n_slices
        self.block = block
        self.cap = cap
        self.rebuilds = 0
        self.extents = extents
        self._radii = torch.as_tensor(self.radii_np, dtype=config.FLOAT, device=self.device)
        c0 = np.asarray(coords, np.float64)
        if extents is None:
            self._build(c0)
            return
        cut = 2 * float(self.radii_np.max())
        self._dims = grid_dims(extents, cut)
        nb0, _ = neighbor_lists(c0, self.radii_np, cap=2048, skin=0.0)
        k0 = int((nb0 >= 0).sum(1).max())
        inv = np.diag(1.0 / np.asarray(extents, np.float64))
        cell0, _, _ = estimate_caps(c0, inv, self._dims, margin=1.0, round_to=1)
        self._k_cap = (int(k0 * 1.3) + 15) // 16 * 16
        self._cell_cap = (int(cell0 * 1.3) + 7) // 8 * 8

    def _build(self, coords) -> None:
        while True:
            nbr, overflow = neighbor_lists(coords, self.radii_np, cap=self.cap, skin=self.skin)
            if not overflow:
                break
            self.cap += max(self.cap // 2, 16)
        self._nbr = torch.as_tensor(nbr, device=self.device)
        self._build_coords = torch.as_tensor(coords, dtype=config.FLOAT, device=self.device)

    def update(self, coords):
        """Exact per-atom SASA for new coordinates. Host mode reuses the
        Verlet list while it is still valid (drift < skin/2); device mode
        rebuilds the lists on the device every call and reads the overflow
        flag (one wait on the device a call)."""
        c = torch.as_tensor(np.asarray(coords, np.float32), device=self.device)
        if self.extents is not None:
            while True:
                nbr, ofl = neighbor_lists_device(c, self._radii, self.extents, self._dims,
                                                 self._cell_cap, self._k_cap)
                if not bool(ofl):
                    return sasa(c, self._radii, nbr, n_slices=self.n_slices, block=self.block)
                self.rebuilds += 1
                self._k_cap = (self._k_cap * 3 // 2 + 15) // 16 * 16
                self._cell_cap = (self._cell_cap * 3 // 2 + 7) // 8 * 8
        if float(max_displacement(c, self._build_coords)) >= self.skin / 2:
            self.rebuilds += 1
            self._build(np.asarray(coords, np.float64))
        return sasa(c, self._radii, self._nbr, n_slices=self.n_slices, block=self.block)

    def areas(self, coords):
        return self.update(coords)
