"""The membrane per-frame pipeline in torch, batched over frame windows.

The counterpart of ``molar_tpu.membrane.device``: marker centres, the patch
search, normal seeding, local frames, quadric fits, curvature, Voronoi
cells, marker smoothing, tail order parameters and curvature smoothing, for
every frame of a window at once. The reference scans a jitted frame body
over the window; here every tensor carries a leading frame axis ``(B, L,
...)``, so each operation launches once a window, not once a frame.

Numerics follow the reference operation by operation, in float32 with TF32
off (``config``): the 3x3 transforms are written elementwise, constant
divisors that are not powers of two are device tensors (on CUDA a division
by a host scalar is a product by its reciprocal), and the patch table keeps
``lax.top_k``'s order (the nearest first, the lower lipid id first on a
tie), which feeds every float sum over a patch.

Two stages are reformulated with the same results:

- the marker smoothing scatter (``.at[].add`` over patch members) is a
  gather over each lipid's own patch through a reverse-slot table: without
  overflow the patch relation is symmetric bit for bit (the min image of
  ``-d`` is ``-`` that of ``d``), so lipid j receives from i exactly when i
  is in j's patch. Only the sum's order differs. It runs only between
  passes: the last pass's smoothed markers are read by nothing;
- the Voronoi edge extremes reduce each plane over the ``P - 1`` candidate
  vertices that lie on it (a static table) instead of masking all ``M``.

The ``(L, L)`` patch search and curvature smoothing run in chunks of frames
and the ``(L, M, P)`` Voronoi stage in chunks of lipids, each chunk's
temporaries up to :data:`BLOCK_ELEMS` elements.

``n_shells_patch > 0`` raises, as in the reference (its device path falls
back to the host pipeline there).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
from torch import nn

from .. import config  # noqa: F401  (pins fp32 matmuls)
from .. import tracing
from ..convert import transport_to_torch
from ..core.pbc import PeriodicBox
from ..ops.measure import contiguous_segments_dense
from ..tasks.trajectory import decode_window_coords
from .spec import MembraneSpec
from .stats import LipidGroup, MembraneError, _RunningStats, _tilt_deg, merge_groups

_VORO_TOL = 1e-6  # f32 analogue of the host clip's 1e-10 (f64)
_VORO_BOUND = 10.0

#: Element budget of one temporary of a chunked stage (the ``(L, L)``
#: patch search, the ``(lipids, M, P)`` Voronoi vertex test, curvature
#: smoothing). From a sweep on an NVIDIA H100 80GB HBM3 (700 W;
#: ``chip_smoke.py``'s membrane phase), 4,608 lipids, 16-frame window, ms a
#: frame and peak GiB at 2^24 ... 2^28: 11.25 / 0.79, 6.11 / 0.82, 5.88 /
#: 1.24, 5.72 / 2.08, 5.62 / 3.77: 2^27 is within 2 % of the fastest at
#: about half its memory.
BLOCK_ELEMS = 1 << 27


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _dot3(a, b):
    """Sum over the last axis of 3-vectors, in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _mat3(m, v):
    """``m @ v`` for (..., 3) vectors, ``m`` (..., 3, 3) broadcasting
    against them, elementwise in the reference's order."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
                        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
                        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z], dim=-1)


def _unit(v):
    n = torch.sqrt(_dot3(v, v))[..., None]
    return v / torch.where(n == 0, 1.0, n)


def _min_image_ortho(vec, ext):
    """Orthorhombic minimum image, componentwise (``ext`` the box extents,
    broadcasting against ``vec``)."""
    return vec - ext * torch.round(vec / ext)


_IJK = np.array(
    [
        (i, j, k)
        for i in (-1, 0, 1)
        for j in (-1, 0, 1)
        for k in (-1, 0, 1)
        if (i, j, k) != (0, 0, 0)
    ],
    dtype=np.float32,
)  # (26, 3)


def _frame_corrections(mat):
    """All 26 ±1-lattice shifts of box matrices ``mat`` (..., 3, 3)
    (columns = box vectors), unpruned, in :data:`_IJK`'s order -> (..., 26,
    3). Each term is a product by -1, 0 or 1, as in the reference."""
    a, b, c = mat[..., :, 0], mat[..., :, 1], mat[..., :, 2]
    return torch.stack([float(i) * a + float(j) * b + float(k) * c for i, j, k in _IJK],
                       dim=-2)


def _min_image_tric(vec, mat, inv, corr):
    """Triclinic minimum image: fractional round, then a running minimum
    over the candidates ``start + corr[k]`` that a candidate joins only
    when strictly shorter (the first wins a tie). ``mat`` / ``inv`` (...,
    3, 3) and ``corr`` (..., 26, 3) broadcast against ``vec`` (..., 3)."""
    frac = _mat3(inv, vec)
    frac = frac - torch.round(frac)
    start = _mat3(mat, frac)
    best = start
    best2 = _dot3(best, best)
    for k in range(corr.shape[-2]):
        cand = start + corr[..., k, :]
        cand2 = _dot3(cand, cand)
        take = cand2 < best2
        best = torch.where(take[..., None], cand, best)
        best2 = torch.where(take, cand2, best2)
    return best


def _solve6_cholesky(M, rhs):
    """Unrolled 6x6 Cholesky solve, batched over the leading dims: ``M``
    (..., 6, 6), ``rhs`` (..., 6) -> (coefs (..., 6), ok): ``ok`` is "all
    pivots positive and finite"."""
    n = 6
    Lc = [[None] * n for _ in range(n)]
    ok = torch.ones(M.shape[:-2], dtype=torch.bool, device=M.device)
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - Lc[i][k] * Lc[j][k]
            if i == j:
                ok = ok & (s > 0) & torch.isfinite(s)
                Lc[i][j] = torch.sqrt(torch.where(s > 0, s, 1.0))
            else:
                Lc[i][j] = s / Lc[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - Lc[i][k] * y[k]
        y[i] = s / Lc[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - Lc[k][i] * x[k]
        x[i] = s / Lc[i][i]
    return torch.stack(x, dim=-1), ok


def _plane_tables(P: int, device):
    """The static tables of :func:`_voronoi_planes` for ``P`` planes, on
    ``device``: ``iu``, ``ju`` (M,) the plane pairs ``i < j`` in
    ``np.triu_indices`` order, ``on`` (P, P - 1) the pairs whose vertex lies
    on each plane, in pair order, and the x and y normals (4,) of the box
    sides ``-y <= b``, ``x <= b``, ``y <= b``, ``-x <= b``."""
    iu, ju = np.triu_indices(P, k=1)
    on = np.stack([np.flatnonzero((iu == p) | (ju == p)) for p in range(P)])
    index = [torch.as_tensor(a, dtype=torch.int64, device=device) for a in (iu, ju, on)]
    sides = [torch.tensor(v, dtype=torch.float32, device=device)
             for v in ([0.0, 1.0, 0.0, -1.0], [-1.0, 0.0, 1.0, 0.0])]
    return (*index, *sides)


def _voronoi_planes(points, pmask, tables=None):
    """The Voronoi cell of the origin among bisector targets, by candidate
    vertices (the reference's formulation): the cell is the intersection of
    P = K + 4 half-planes (K bisectors and the bounding box); its vertices
    are the plane-pair intersections that satisfy every active half-plane;
    each plane's edge runs between its extreme on-plane vertices.

    ``points`` (..., K, 2), ``pmask`` (..., K); ``tables`` from
    :func:`_plane_tables` (built here when None). Returns ``has_edge``
    (..., K), ``wall`` (...,), ``e1``, ``e2`` (..., P, 2) and ``edge_ok``
    (..., P). The vertex test runs in chunks of :data:`BLOCK_ELEMS`."""
    lead, K = pmask.shape[:-1], pmask.shape[-1]
    P = K + 4
    iu, ju, on, side_x, side_y = tables if tables is not None else _plane_tables(P, points.device)
    M = iu.shape[0]
    points, pmask = points.reshape(-1, K, 2), pmask.reshape(-1, K)
    N = pmask.shape[0]
    b = _VORO_BOUND
    eps = 1e-4  # f32 on-plane/containment tolerance (normalized planes)

    # half-planes n.x <= c, normalized so eps is a geometric distance
    nx = 0.5 * points[..., 0]
    ny = 0.5 * points[..., 1]
    c = nx * nx + ny * ny
    active = pmask & (c >= _VORO_TOL)
    norm = torch.sqrt(c)
    safe = torch.where(norm == 0, 1.0, norm)
    pnx = torch.cat([nx / safe, side_x.expand(N, 4)], dim=1)
    pny = torch.cat([ny / safe, side_y.expand(N, 4)], dim=1)
    pc = torch.cat([norm, norm.new_full((N, 4), b)], dim=1)
    pact = torch.cat([active, active.new_ones(N, 4)], dim=1)  # (N, P)

    big = 1e30
    tmin = pc.new_empty(N, P)
    tmax = pc.new_empty(N, P)
    chunk = max(1, BLOCK_ELEMS // (M * P))
    for s in range(0, N, chunk):
        cx, cy, cc, ca = (a[s:s + chunk] for a in (pnx, pny, pc, pact))
        # candidate vertices: intersections of plane pairs i < j
        n1x, n1y, n2x, n2y = cx[:, iu], cy[:, iu], cx[:, ju], cy[:, ju]
        c1, c2 = cc[:, iu], cc[:, ju]
        det = n1x * n2y - n1y * n2x
        par = torch.abs(det) < 1e-12
        sdet = torch.where(par, 1.0, det)
        vx = (c1 * n2y - c2 * n1y) / sdet
        vy = (n1x * c2 - n2x * c1) / sdet
        pair_ok = ~par & ca[:, iu] & ca[:, ju]
        # a vertex is real iff it satisfies every ACTIVE half-plane
        d = cx[:, None, :] * vx[:, :, None] + cy[:, None, :] * vy[:, :, None] - cc[:, None, :]
        inside = ((d <= eps) | ~ca[:, None, :]).all(dim=2)
        vert_ok = pair_ok & inside  # (chunk, M)
        del d, inside
        # per plane, its on-plane vertices' extreme tangential coordinates
        # (tangent t = (-n_y, n_x))
        t = -cy[:, :, None] * vx[:, on] + cx[:, :, None] * vy[:, on]  # (chunk, P, P-1)
        member = vert_ok[:, on]
        tmin[s:s + chunk] = torch.where(member, t, big).amin(dim=2)
        tmax[s:s + chunk] = torch.where(member, t, -big).amax(dim=2)
    edge_ok = pact & (tmax > tmin + 1e-7)  # degenerate/absent edges drop

    def endpoint(tt):  # x = c*n + t*(-n_y, n_x)
        return torch.stack([pc * pnx - tt * pny, pc * pny + tt * pnx], dim=-1)

    e1 = endpoint(torch.where(edge_ok, tmin, 0.0))
    e2 = endpoint(torch.where(edge_ok, tmax, 0.0))
    has_edge = edge_ok[:, :K]
    wall = edge_ok[:, K:].any(dim=1)
    return (has_edge.reshape(*lead, K), wall.reshape(lead), e1.reshape(*lead, P, 2),
            e2.reshape(*lead, P, 2), edge_ok.reshape(*lead, P))


def _order_batch(order_type, coords, normals, bond_orders):
    """Tail order parameters (``measure_host.lipid_tail_order_batch``'s
    expression sequence; the bond-order branches unroll in Python):
    ``coords`` (..., n, 3) the tail's carbons, ``normals`` (..., 3) ->
    (..., n - 2)."""
    n = coords.shape[-2]
    normals = normals[..., None, :].expand(*normals.shape[:-1], max(n - 2, 1), 3)
    three = coords.new_full((), 3.0)

    def cosang(a, b):
        num = _dot3(a, b)
        den = torch.sqrt(_dot3(a, a) * _dot3(b, b))
        return torch.clip(num / torch.where(den == 0, 1.0, den), -1.0, 1.0)

    def at(i):
        return coords[..., i, :]

    cols = [coords.new_zeros(coords.shape[:-2]) for _ in range(n - 2)]
    if order_type == "sz":
        for k in range(1, n - 1):
            cth = cosang(at(k + 1) - at(k - 1), normals[..., k - 1, :])
            cols[k - 1] = 1.5 * cth**2 - 0.5
        return torch.stack(cols, dim=-1)

    corr = order_type == "scdcorr"
    sqrt3 = math.sqrt(3.0)
    for i in range(n - 2):
        if bond_orders[i] == 1:
            if bond_orders[i + 1] == 1:
                p1, p2, p3 = at(i), at(i + 1), at(i + 2)
                local_z = _unit(p3 - p1)
                local_x = _unit(_cross(p1 - p2, p3 - p2))
                local_y = _cross(local_x, local_z)
                nv = normals[..., i, :]
                sxx = 0.5 * (3 * cosang(local_x, nv) ** 2 - 1)
                syy = 0.5 * (3 * cosang(local_y, nv) ** 2 - 1)
                cols[i] = -(2 * sxx + syy) / three
        else:
            p1, p2, p3, p4 = at(i - 1), at(i), at(i + 1), at(i + 2)
            a1 = 0.5 * (math.pi - torch.arccos(cosang(p1 - p2, p3 - p2)))
            a2 = 0.5 * (math.pi - torch.arccos(cosang(p2 - p3, p4 - p3)))
            local_z = _unit(p3 - p2)
            local_x = _unit(_cross(p1 - p2, local_z))
            local_y = _cross(local_x, local_z)
            n1 = normals[..., i, :]
            szz = 0.5 * (3 * cosang(local_z, n1) ** 2 - 1)
            syy = 0.5 * (3 * cosang(local_y, n1) ** 2 - 1)
            syz = 1.5 * cosang(local_y, n1) * cosang(local_z, n1)
            if corr:
                cols[i - 1] = -(torch.cos(a1) ** 2 * syy + torch.sin(a1) ** 2 * szz
                                - 2 * torch.cos(a1) * torch.sin(a1) * syz)
            else:
                cols[i - 1] = -(szz / 4 + 3 * syy / 4 - sqrt3 * syz / 2)
            local_x = _unit(_cross(p3 - p4, local_z))
            local_y = _cross(local_x, local_z)
            n2 = normals[..., min(i + 1, max(n - 2, 1) - 1), :]
            szz = 0.5 * (3 * cosang(local_z, n2) ** 2 - 1)
            syy = 0.5 * (3 * cosang(local_y, n2) ** 2 - 1)
            syz = 1.5 * cosang(local_y, n2) * cosang(local_z, n2)
            if corr:
                cols[i] = -(torch.cos(a2) ** 2 * syy + torch.sin(a2) ** 2 * szz
                            + 2 * torch.cos(a2) * torch.sin(a2) * syz)
            else:
                cols[i] = -(szz / 4 + 3 * syy / 4 + sqrt3 * syz / 2)
    return torch.stack(cols, dim=-1)


def _gather_rows(x, idx):
    """``x`` (B, L, C), ``idx`` (B, ...) int64 lipid ids -> (B, ..., C)."""
    B, C = x.shape[0], x.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return x.gather(1, flat).reshape(*idx.shape, C)


# ---------------------------------------------------------------------------
# The window function
# ---------------------------------------------------------------------------


class MembraneWindow(nn.Module):
    """Every frame of a window through the membrane pipeline.

    ``forward(transport, boxes (B, 3, 3), invs (B, 3, 3))`` takes a window
    of the spec's ``subset`` rows in any wire form and returns the
    reference's output dict, each entry with a leading frame axis:
    ``valid`` (B, L), ``overflow`` (B,), ``area``, ``mean_curv``,
    ``gauss_curv`` (B, L), ``normal``, ``thv`` (B, L, 3), ``n_neighbors``
    (B, L) int32, ``nb_ids`` (B, L, K) int32 (-1 where not a neighbour),
    ``nb_mask`` (B, L, K) and ``order[sp]``, one (B, n_sp, n - 2) a tail.
    Where ``overflow`` is set, that frame's results are undefined. No host
    sync: every constant is made here, on ``device``.

    Each stage is a :mod:`~molar_tpu_torch.tracing` span ``membrane.<stage>``
    (``unwrap_markers``, ``patches``, ``normals``, ``smooth`` holding
    ``smooth.fit``, ``smooth.voronoi`` and ``smooth.scatter``, ``order``,
    ``curv_smooth``) with a device event pair: ``membrane.patches@device``
    and ``membrane.smooth.voronoi@device`` are what ``portbench/``'s
    ``membrane_patches_ms_per_frame`` and ``membrane_voronoi_ms_per_frame``
    read."""

    def __init__(self, spec: MembraneSpec, patch_cap: int, device):
        super().__init__()
        opt = spec.options
        self.L = spec.n_lipids
        self.K = patch_cap
        self.triclinic = spec.triclinic
        self.options = opt
        self.cutoff2 = float(np.float32(opt.cutoff**2))
        self.species_names = list(spec.species_names)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.register_buffer("atom_first", i64(spec.atom_first))
        self.register_buffer("ex", torch.tensor([1.0, 0.0, 0.0], device=device))
        for name, (idx, seg) in (("head", spec.head), ("tail", spec.tail)):
            slots, w, _ = contiguous_segments_dense(seg, spec.masses[idx])
            self.register_buffer(f"{name}_rows", i64(idx[slots]))
            self.register_buffer(f"{name}_w", torch.as_tensor(w, device=device))
        self.sp_lipids = {sp: i64(spec.sp_lipids[sp]) for sp in self.species_names}
        self.sp_tails = {sp: [(i64(tl), orders) for tl, orders in spec.sp_tails[sp]]
                         for sp in self.species_names}
        self.gn = (None if opt.global_normal is None else
                   torch.as_tensor(np.asarray(opt.global_normal, np.float32), device=device))
        self.tables = _plane_tables(self.K + 4, torch.device(device))

    # -- stages --------------------------------------------------------------

    def _seg_com(self, u, name):
        """Mass-weighted centre of each lipid's marker rows: (B, L, 3)."""
        rows, w = getattr(self, f"{name}_rows"), getattr(self, f"{name}_w")
        lmax, L = w.shape
        g = u.index_select(1, rows).reshape(u.shape[0], lmax, L, 3)
        return (g * w[..., None]).sum(dim=1) / w.sum(dim=0)[:, None]

    def _patches(self, heads, mi):
        """Head-marker adjacency within the cutoff -> the top-K table:
        ``pid`` (B, L, K) int64 nearest first (a tie: the lower id), ``pmask``,
        ``overflow`` (B,). In chunks of frames."""
        B, L, K = heads.shape[0], self.L, self.K
        pids, masks, overflow = [], [], []
        step = max(1, BLOCK_ELEMS // (3 * L * L))
        for f in range(0, B, step):
            fr = slice(f, f + step)
            h = heads[fr]
            dm = mi(h[:, None, :, :] - h[:, :, None, :], fr)
            d2 = _dot3(dm, dm)
            del dm
            d2.diagonal(dim1=-2, dim2=-1).fill_(math.inf)
            adj = d2 <= self.cutoff2
            overflow.append((adj.sum(dim=2) > K).any(dim=1))
            d2.masked_fill_(~adj, math.inf)
            del adj
            vals, idx = torch.topk(d2, K, dim=2, largest=False, sorted=False)
            del d2
            idx, order = idx.sort(dim=2)
            vals, order = vals.gather(2, order).sort(dim=2, stable=True)
            idx = idx.gather(2, order)
            pmask = torch.isfinite(vals)
            pids.append(torch.where(pmask, idx, 0))
            masks.append(pmask)
        return torch.cat(pids), torch.cat(masks), torch.cat(overflow)

    @staticmethod
    def _reverse_slots(pid, pmask):
        """For lipid j's slot t holding i: the slot of i's patch holding j,
        and whether there is one -> (rev (B, L, K) int64, found)."""
        L = pid.shape[1]
        their = _gather_rows(torch.where(pmask, pid, -1), pid)  # (B, L, K, K)
        me = torch.arange(L, device=pid.device)[None, :, None, None]
        hit = their == me
        return hit.int().argmax(dim=3), hit.any(dim=3) & pmask

    def _smooth_pass(self, markers, normals, pid, pmask, valid, mi, rev, last):
        """One ``_smooth()`` pass over the padded (B, L, K) patch table.
        Invalid NEIGHBOURS stay in the fits and clips; only own validity
        gates."""
        B, L, K = pid.shape
        valid = valid & pmask.any(dim=2)

        with tracing.span("membrane.smooth.fit", device=markers.device):
            # local frames: columns (n x ex), (n x (n x ex)), -n
            c0 = _cross(normals, self.ex.expand_as(normals))
            c1 = _cross(normals, c0)
            A = to_lab = torch.stack([c0, c1, -normals], dim=-1)  # (B, L, 3, 3)
            det = (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
                   - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
                   + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))
            sing = ~torch.isfinite(det) | (torch.abs(det) < 1e-12)
            valid = valid & ~sing
            safed = torch.where(sing, 1.0, det)
            inv = torch.stack([
                torch.stack([A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1],
                             A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2],
                             A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]], -1),
                torch.stack([A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2],
                             A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0],
                             A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]], -1),
                torch.stack([A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0],
                             A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1],
                             A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]], -1),
            ], dim=-2) / safed[..., None, None]

            # min-image displacements to every patch member, local coords
            mpk = _gather_rows(markers, pid)  # (B, L, K, 3)
            rel = mi(mpk - markers[:, :, None, :])
            local = _mat3(inv[:, :, None], rel)
            x, y, z = local[..., 0], local[..., 1], local[..., 2]

            # quadric z = Ax^2+By^2+Cxy+Dx+Ey+F, masked normal equations
            Pm = torch.stack([x * x, y * y, x * y, x, y, torch.ones_like(x)], dim=-1)
            Pm = torch.where(pmask[..., None], Pm, 0.0)
            zm = torch.where(pmask, z, 0.0)
            zm = torch.where(torch.isfinite(zm), zm, 0.0)
            Pm = torch.where(torch.isfinite(Pm), Pm, 0.0)
            Mn = (Pm[..., :, None] * Pm[..., None, :]).sum(dim=2)
            rhs = (Pm * zm[..., None]).sum(dim=2)
            Mn = torch.where(valid[..., None, None], Mn, torch.eye(6, device=Mn.device))
            coefs, pd = _solve6_cholesky(Mn, rhs)
            valid = valid & pd

            a, b, c, d, e, f = (coefs[..., k] for k in range(6))
            E = 1 + d * d
            F = d * e
            G = 1 + e * e
            Lq = 2 * a
            Mq = c
            Nq = 2 * b
            Z = torch.where(valid, E * G - F * F, 1.0)
            gaussian = (Lq * Nq - Mq * Mq) / Z
            meanc = 0.5 * (E * Nq - 2 * F * Mq + G * Lq) / Z
            vn = _unit(torch.stack([d, e, -torch.ones_like(d)], dim=-1))
            new_normals = _mat3(to_lab, vn)

        with tracing.span("membrane.smooth.voronoi", device=markers.device):
            # Voronoi cells in the local tangent plane
            pts2 = torch.where(pmask[..., None], local[..., :2], 0.0)
            pts2 = torch.where(torch.isfinite(pts2), pts2, 0.0)
            has_edge, wall, edge1, edge2, edge_ok = _voronoi_planes(
                pts2, pmask & valid[..., None], self.tables)
            valid = valid & ~wall

            # neighbour ids: bisector planes owning an edge of the cell
            nb_mask = has_edge
            nb_ids = torch.where(nb_mask, pid, -1)

            def coef(k):
                return k[..., None]

            # area: one triangle (origin, e1, e2) per surviving edge on the
            # lifted surface
            def lift(pt):  # (B, L, P, 2) -> lab frame (B, L, P, 3)
                px, py = pt[..., 0], pt[..., 1]
                pz = (coef(a) * px * px + coef(b) * py * py + coef(c) * px * py
                      + coef(d) * px + coef(e) * py + coef(f))
                return _mat3(to_lab[:, :, None], torch.stack([px, py, pz], dim=-1))

            cr = _cross(lift(edge1), lift(edge2))
            areas = 0.5 * torch.where(edge_ok, torch.sqrt(_dot3(cr, cr)), 0.0).sum(dim=2)

        runaway = torch.abs(f) > 0.5
        valid = valid & ~runaway
        new_markers = markers
        if not last:
            with tracing.span("membrane.smooth.scatter", device=markers.device):
                # Lipids invalidated this pass keep their markers; valid
                # owners give member j their fitted projection of j.
                new_markers = torch.where(valid[..., None],
                                          markers + f[..., None] * to_lab[..., :, 2], markers)
                zs = (coef(a) * x * x + coef(b) * y * y + coef(c) * x * y + coef(d) * x
                      + coef(e) * y + coef(f))
                fit_pts = mpk + (zs - z)[..., None] * to_lab[:, :, None, :, 2]
                rslot, found = rev
                give = found & torch.gather(valid, 1, pid.reshape(B, -1)).reshape(B, L, K)
                got = _gather_rows(fit_pts.reshape(B, L * K, 3), pid * K + rslot)
                sm_n = 1.0 + give.sum(dim=2).float()
                sm_p = new_markers + torch.where(give[..., None], got, 0.0).sum(dim=2)
                new_markers = torch.where(valid[..., None], sm_p / sm_n[..., None], new_markers)
        return new_markers, new_normals, valid, nb_ids, nb_mask, meanc, gaussian, areas

    def _curvature_smoothing(self, nb_ids, nb_mask, valid, meanc, gaussc):
        """Mean over ``n_shells_smoothing`` shells of the Voronoi graph: the
        dense (L, L) graph, shells by products, in chunks of frames."""
        B, L, K = nb_ids.shape
        ns = self.options.n_shells_smoothing
        out_m, out_g = [], []
        step = max(1, BLOCK_ELEMS // (L * L))
        rows = torch.arange(L, device=nb_ids.device)[None, :, None]
        for s in range(0, B, step):
            fr = slice(s, s + step)
            n = nb_ids[fr].shape[0]
            tgt = torch.where(nb_mask[fr], nb_ids[fr].long(), L)
            flat = torch.where(nb_mask[fr], rows * L + tgt, L * L).reshape(n, -1)
            neib = nb_ids.new_zeros(n, L * L + 1, dtype=torch.float32)
            neib = neib.scatter_(1, flat, 1.0)[:, :-1].reshape(n, L, L)
            reach = neib
            for _ in range(ns - 1):
                grown = torch.matmul(reach, neib)
                reach = torch.maximum(reach, torch.minimum(grown, grown.new_ones(())))
            wm = (reach > 0) & valid[fr][:, None, :]
            cnt = wm.sum(dim=2)
            has = valid[fr] & (cnt > 0)
            for src, out in ((meanc, out_m), (gaussc, out_g)):
                tot = torch.where(wm, src[fr][:, None, :], 0.0).sum(dim=2)
                out.append(torch.where(has, (src[fr] + tot) / (cnt + 1), src[fr]))
        return torch.cat(out_m), torch.cat(out_g)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        opt = self.options
        L = self.L
        dev = self.ex.device
        with tracing.span("membrane.unwrap_markers", device=dev):
            coords = decode_window_coords(transport)
            B = coords.shape[0]
            if self.triclinic:
                corr = _frame_corrections(boxes)

                def mi(v, fr=slice(None)):
                    pad = (1,) * (v.dim() - 2)
                    n = boxes[fr].shape[0]
                    return _min_image_tric(v, boxes[fr].reshape(n, *pad, 3, 3),
                                           invs[fr].reshape(n, *pad, 3, 3),
                                           corr[fr].reshape(n, *pad, 26, 3))
            else:
                ext = torch.diagonal(boxes, dim1=-2, dim2=-1)

                def mi(v, fr=slice(None)):
                    e = ext[fr]
                    return _min_image_ortho(v, e.reshape(e.shape[0], *(1,) * (v.dim() - 2), 3))

            # 1. unwrap each lipid to its first atom's image; 2. markers
            ref = coords.index_select(1, self.atom_first)
            u = ref + mi(coords - ref)
            heads = self._seg_com(u, "head")
            tails = self._seg_com(u, "tail")

        with tracing.span("membrane.patches", device=dev):
            pid, pmask, overflow = self._patches(heads, mi)

        with tracing.span("membrane.normals", device=dev):
            # tail-head vectors + 2-pass normal seeding over the patch
            thv = _unit(heads - tails)
            vecs = thv
            for _ in range(2):
                vk = _gather_rows(vecs, pid)
                cos = _dot3(vecs[:, :, None, :], vk)
                keep = pmask & (cos >= 0)
                acc = vecs + torch.where(keep[..., None], vk, 0.0).sum(dim=2)
                vecs = _unit(acc)
            normals = vecs

        n_pass = max(opt.max_smooth_iter, 1)
        rev = self._reverse_slots(pid, pmask) if n_pass > 1 else None
        valid = torch.ones(B, L, dtype=torch.bool, device=coords.device)
        markers = heads
        for it in range(n_pass):
            with tracing.span("membrane.smooth", device=dev):
                (markers, normals, valid, nb_ids, nb_mask, meanc, gaussc,
                 areas) = self._smooth_pass(markers, normals, pid, pmask, valid, mi, rev,
                                            last=it == n_pass - 1)

        with tracing.span("membrane.order", device=dev):
            # 5. order parameters per species / tail (on unwrapped coords)
            order = {}
            for sp in self.species_names:
                lids = self.sp_lipids[sp]
                if self.gn is not None:
                    nrm = self.gn.expand(B, lids.shape[0], 3)
                else:
                    nrm = normals.index_select(1, lids)
                order[sp] = [_order_batch(opt.order_type, u[:, tl], nrm, orders)
                             for tl, orders in self.sp_tails[sp]]

        if opt.n_shells_smoothing >= 1:
            with tracing.span("membrane.curv_smooth", device=dev):
                meanc, gaussc = self._curvature_smoothing(nb_ids, nb_mask, valid, meanc, gaussc)

        return {
            "valid": valid,
            "overflow": overflow,
            "area": areas,
            "mean_curv": meanc,
            "gauss_curv": gaussc,
            "normal": normals,
            "thv": thv,
            "n_neighbors": nb_mask.sum(dim=2).int(),
            "nb_ids": nb_ids.int(),
            "nb_mask": nb_mask,
            "order": order,
        }


def to_numpy(outs):
    """A window's output dict (tensors on any device) as numpy arrays."""
    if isinstance(outs, torch.Tensor):
        return outs.cpu().numpy()
    if isinstance(outs, dict):
        return {k: to_numpy(v) for k, v in outs.items()}
    if isinstance(outs, (list, tuple)):
        return [to_numpy(v) for v in outs]
    return outs


# ---------------------------------------------------------------------------
# The host side
# ---------------------------------------------------------------------------


class MembraneDevice:
    """Window-batched execution of the membrane pipeline for one
    :class:`~molar_tpu_torch.membrane.spec.MembraneSpec`, with the group
    statistics of the spec's ``groups`` (``groups[name]``, a
    :class:`LipidGroup`) folded in by :meth:`accumulate`.

    ``MembraneDevice(membrane, patch_cap=..., engine=..., device=...)``
    takes a host :class:`~molar_tpu_torch.membrane.membrane.Membrane`
    instead (as the JAX package's ``MembraneDevice(membrane)``): the spec is
    :meth:`MembraneSpec.from_membrane`, the build frame the membrane's
    system, and :meth:`accumulate` folds into ``membrane.groups``, so
    ``membrane.finalize()`` writes the group files. Build it after the
    membrane's groups are set.

    ``build_coords`` (n_atoms, 3) and ``build_box`` (3, 3) are the build
    frame (global rows): they size ``patch_cap`` when it is None (1.25x the
    build frame's largest patch, rounded up to 8) and give every frame the
    build box when :meth:`compute_window` gets no boxes. A frame whose
    patches exceed the cap sets ``overflow``: rebuild with a larger cap.

    ``engine``: ``"device"`` runs on ``device`` (default: the first CUDA
    device; raises without one), ``"cpu"`` on the CPU, ``"auto"`` picks at
    the first window from the work of a window
    (:func:`~molar_tpu_torch.tasks.engine.pick_engine`) and prints its
    choice.
    """

    def __init__(self, spec, build_coords=None, build_box=None, patch_cap=None,
                 engine: str = "device", device=None):
        membrane = None
        if not isinstance(spec, MembraneSpec):  # a host Membrane
            membrane = spec
            if build_coords is not None or build_box is not None:
                raise MembraneError("MembraneDevice(membrane): the build frame is the "
                                    "membrane's own; pass patch_cap, engine and device "
                                    "by keyword")
            spec = MembraneSpec.from_membrane(membrane)
            build_coords = membrane.system.state.coords
            build_box = membrane.system.state.require_box().matrix
        opt = spec.options
        if opt.n_shells_patch > 0:
            raise MembraneError(
                "device membrane path does not support n_shells_patch > 0; "
                "use the host pipeline"
            )
        if engine not in ("auto", "cpu", "device"):
            raise MembraneError(f"MembraneDevice engine must be auto/cpu/device, got {engine!r}")
        L = spec.n_lipids
        for name, (_, seg) in (("head", spec.head), ("mid", spec.mid), ("tail", spec.tail)):
            if np.any(np.diff(seg) < 0) or not (np.bincount(seg, minlength=L) > 0).all():
                raise MembraneError(f"every lipid needs its {name} rows, in lipid order")
        self.spec = spec
        self.options = opt
        self.n_lipids = L
        self.subset = spec.subset
        self.species_names = spec.species_names
        self.species_of = spec.species_of
        self._sp_lipids = spec.sp_lipids
        self._triclinic = spec.triclinic
        self.build_box = np.asarray(build_box, np.float64)
        self.membrane = membrane
        self.groups = membrane.groups if membrane is not None else {
            name: LipidGroup(name, ids, {spec.species_names[spec.species_of[i]] for i in ids})
            for name, ids in spec.groups.items()
        }
        if patch_cap is None:
            patch_cap = self._estimate_patch_cap(build_coords)
        # (clamped: the top-K table needs K <= L whatever the caller asked for)
        self.patch_cap = max(1, min(int(patch_cap), L))
        self.engine = engine
        self._device = device
        self.engine_resolved = None
        self.window_fn = None
        if engine != "auto":
            self._resolve(engine)

    def _resolve(self, engine: str) -> None:
        from ..tasks.engine import engine_device

        # the caller's device serves the card's engine only: a "host" or
        # "cpu" verdict runs on the CPU whatever device was named
        if engine == "device" and self._device is not None:
            dev = self._device
        else:
            dev = engine_device(engine)
        self.engine_resolved = engine
        self.device = torch.device(dev)
        self.window_fn = MembraneWindow(self.spec, self.patch_cap, self.device)

    def _per_frame_flops(self) -> float:
        """Rough operation count of one frame: the L x L head-distance
        matrix and patch search (~10 a pair), the candidate-vertex Voronoi
        over K^2 plane pairs (~40 each) and the 6x6 fit (~1e3) a lipid."""
        L, K = float(self.n_lipids), float(self.patch_cap)
        return L * (10.0 * L + 40.0 * K * K + 1000.0)

    def _estimate_patch_cap(self, build_coords) -> int:
        """Max patch count on the build frame, x1.25, rounded to 8, on the
        host (the reference's ``box.shortest_vector`` semantics)."""
        box = PeriodicBox(self.build_box)
        idx, seg = self.spec.head
        sub = np.asarray(build_coords)[self.subset].astype(np.float64)
        ref = sub[self.spec.atom_first]
        u = ref + box.shortest_vector(sub - ref)
        w = self.spec.masses[idx].astype(np.float64)
        L = self.n_lipids
        wsum = np.bincount(seg, weights=w, minlength=L)
        heads = np.stack(
            [np.bincount(seg, weights=w * u[idx, k], minlength=L) for k in range(3)], axis=-1
        ) / wsum[:, None]
        dm = box.shortest_vector((heads[:, None, :] - heads[None, :, :]).reshape(-1, 3))
        adj = (dm * dm).sum(-1).reshape(L, L) <= self.options.cutoff**2
        np.fill_diagonal(adj, False)
        kmax = int(adj.sum(1).max(initial=0))
        return min(max((int(kmax * 1.25) + 7) // 8 * 8, 8), L)

    def check_boxes(self, boxes) -> None:
        """Raise when a frame's box is tilted but the build box was not (the
        window function's minimum image is the orthorhombic form then)."""
        if self._triclinic:
            return
        off = np.abs(np.asarray(boxes, np.float64) * (1 - np.eye(3))[None])
        if off.max(initial=0.0) > 1e-5:
            raise MembraneError(
                "MembraneDevice.compute_window: per-frame box is not orthorhombic "
                f"(off-diagonal max {off.max():.2e}) but this MembraneDevice was built from an "
                "orthorhombic box: rebuild it with a triclinic build-frame box"
            )

    def resolve_engine(self, frames: int) -> None:
        """Resolve ``engine="auto"`` for windows of ``frames`` frames."""
        if self.window_fn is not None:
            return
        from ..tasks.engine import pick_engine

        flops = self._per_frame_flops()
        self._resolve(pick_engine(flops, frames))
        print(f"MembraneDevice: engine auto -> {self.engine_resolved} ({flops:.3g} operations a "
              f"frame x {frames} frames)", file=sys.stderr)

    def compute_window(self, coords, boxes=None):
        """The pipeline over one window. ``coords``: (B, n_subset, 3) f32
        rows of :attr:`subset`, or a wire-form transport tuple from
        ``TrajectoryReader.iter_windows(subset=...)``; ``boxes`` (B, 3, 3),
        None for the build box every frame. Returns the output dict of
        :class:`MembraneWindow` as numpy arrays."""
        if not isinstance(coords, tuple):
            B = coords.shape[0]
        else:  # (ints, scale) or (frame0, deltas, scale)
            B = coords[0].shape[0] if len(coords) == 2 else coords[1].shape[0] + 1
        self.resolve_engine(B)
        bs = (np.broadcast_to(self.build_box, (B, 3, 3)) if boxes is None
              else np.asarray(boxes, np.float64))
        self.check_boxes(bs)
        # inverses on the host in f64, shipped f32 beside the matrices
        window = transport_to_torch((coords, bs.astype(np.float32),
                                     np.linalg.inv(bs).astype(np.float32)), self.device)
        return to_numpy(self.window_fn(*window))

    def accumulate(self, outs) -> None:
        """Fold a window's outputs (numpy or tensors) into the group
        statistics (the array form of the reference's ``frame_update``, the
        same Welford streams). An overflowed window raises."""
        outs = to_numpy(outs)
        if bool(np.any(outs["overflow"])):
            raise MembraneError(
                f"patch capacity {self.patch_cap} overflowed; rebuild "
                "MembraneDevice with a larger patch_cap"
            )
        # Each group's lipids, once a window; the last slot (False) is what a
        # neighbour id of -1 (no neighbour) reads.
        in_groups = []
        for gr in self.groups.values():
            in_group = np.zeros(self.n_lipids + 1, bool)
            in_group[list(gr.lipid_ids)] = True
            in_groups.append((gr, in_group))
        for fr in range(outs["valid"].shape[0]):
            valid = outs["valid"][fr]
            tilt = _tilt_deg(outs["normal"][fr], outs["thv"][fr])
            for gr, in_group in in_groups:
                self._group_update(gr, in_group, fr, outs, valid, tilt)

    def merge_stats_from(self, other: "MembraneDevice") -> None:
        """Fold ``other``'s accumulated group statistics into this one's
        (``Membrane.merge_stats_from``). The frame-sharded shape of the
        membrane workload: each shard streams its slice of the trajectory
        through its own :class:`MembraneDevice`, and the per-group Welford
        accumulators merge afterwards, exactly up to float rounding and in
        any order. Groups and species must match."""
        merge_groups(self.groups, other.groups)

    def _group_update(self, gr: LipidGroup, in_group, fr, outs, valid, tilt):
        nb_ids = outs["nb_ids"][fr]
        nb_mask = outs["nb_mask"][fr]
        for sp in gr.species_names:
            st = gr.per_species[sp]
            spm = self.species_of == self.species_names.index(sp)
            sel = in_group[:-1] & valid & spm
            idx = np.nonzero(sel)[0]
            st["count"].add(len(idx))
            if len(idx) == 0:
                continue
            st["area"].add(float(np.mean(outs["area"][fr][idx])))
            st["tilt"].add(float(np.mean(tilt[idx])))
            st["mean_curv"].add(float(np.mean(outs["mean_curv"][fr][idx])))
            st["gauss_curv"].add(float(np.mean(outs["gauss_curv"][fr][idx])))
            st["n_neighbors"].add(float(np.mean(outs["n_neighbors"][fr][idx])))
            # neighbour species fractions (neighbours restricted to the group)
            ids = nb_ids[idx].astype(np.intp)
            ok = nb_mask[idx] & in_group[ids]
            total = int(ok.sum())
            if total:
                by_species = np.bincount(self.species_of[ids[ok]],
                                         minlength=len(self.species_names))
                for s in gr.species_names:
                    st["neib_fractions"][s].add(
                        int(by_species[self.species_names.index(s)]) / total)
            # order profiles: mean over the group's valid lipids of the species
            sp_l = self._sp_lipids[sp]
            rows = np.nonzero(sel[sp_l])[0]
            tails = outs["order"][sp]
            if len(rows) and len(tails):
                if st["order"] is None:
                    st["order"] = [_RunningStats((t.shape[-1],)) for t in tails]
                for k, t in enumerate(tails):
                    st["order"][k].add(np.mean(t[fr][rows], axis=0))
