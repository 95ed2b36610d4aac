"""Plain PyTorch reference of the lipid-membrane analysis of one frame: the
published analysis (molar's ``molar_membrane``, ``Membrane::compute`` with
one smoothing pass, ``lipid_molecule.rs``, ``voronoi_cell.rs`` and
``Measure::lipid_tail_order``), written again here as dense tensor code.

Per frame: every lipid unwrapped to the image nearest its first atom; its
head and tail markers the mass-weighted centres of their atoms (the tail
marker of the last carbon of each tail); its patch every other lipid
whose head marker lies within the cutoff under the minimum image, found by
brute force; its normal the unit tail-to-head vector, averaged twice over
the patch members pointing the same way (dot product >= 0); its local
frame the columns ``n x e_x``, ``n x (n x e_x)``, ``-n`` (as the published
code builds it, not orthonormalised); the quadric ``z = a x^2 + b y^2 +
c xy + d x + e y + f`` fitted to the patch in that frame by the normal
equations (Cholesky); mean and Gaussian curvature from its fundamental
forms; the new normal; the 2D Voronoi cell of the lipid among its patch,
cut by half-planes out of a +-10 nm square, its Voronoi neighbours the
members whose bisector bounds it with an edge, and its area as the
triangle fan of the cell's vertices lifted onto the quadric; and each
tail's order parameters (``sz``, ``scd`` or ``scdcorr``, with the
double-bond correction) against the new normal. A lipid is invalid without a patch,
with a singular frame, a fit that is not positive definite, a cell that
reaches the square, or ``|f| > 0.5``.

Every product is a matrix product (the normal seeding, the local frames,
the normal equations, the side of a cell's vertices, the lift, each
direction against the normal in the order parameters), so the dtype and
the products' precision that the caller sets decide that arithmetic:
float64 for the reference; float32 with every product's operands rounded
to TF32's 10-bit mantissa (``tf32=True``) for its control. TF32 itself is
off inside :func:`analyse`; the rounding is done here instead: these
products are too small for cuBLAS to take the tensor cores, so allowing
TF32 leaves most of them in full float32.

Departures from the published analysis: orthorhombic boxes only; the mid
marker, which it computes and no step reads, is not computed; one
smoothing pass (``max_smooth_iter`` 1, the default), whose closing marker
update is read by nothing and is not computed; no patch shells and no
curvature smoothing (``n_shells_patch`` and ``n_shells_smoothing`` 0, the
defaults); no principal curvatures (not compared).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

#: The published Voronoi cell's tolerance (a cut that changes nothing) and
#: the half side of the square it starts from (nm).
VORONOI_TOL = 1e-10
VORONOI_BOUND = 10.0
#: Rows of the (L, L) distance matrix a block.
_BLOCK_ROWS = 1024


@contextlib.contextmanager
def _tf32_off():
    """Full float32 products inside the block (TF32 off for matmuls and
    cuDNN), the caller's settings restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _tf32(x):
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, tf32: bool):
    """``a @ b``, its operands rounded to TF32 first where ``tf32``."""
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


@dataclass
class Lipids:
    """The static structure of one species' lipids: ``rows`` (L, A) every
    lipid's atom rows in the frame (the first its reference atom);
    ``masses`` (A,) one lipid's atom masses; ``head`` and ``tail_end``
    atom offsets within a lipid; ``tails`` one ``(carbon offsets, bond
    orders)`` a tail (bond orders 1 or 2, one fewer than carbons)."""

    rows: torch.Tensor
    masses: torch.Tensor
    head: list
    tail_end: list
    tails: list


def _dot(a, b, tf32: bool):
    """Row-wise dot products of (L, 3) ``a`` and ``b``, as products."""
    return _mm(a[:, None, :], b[:, :, None], tf32)[:, 0, 0]


def _unit(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n == 0, torch.ones_like(n), n)


def _min_image(v, sides):
    return v - sides * torch.round(v / sides)


def _marker(u, masses, offsets):
    w = masses[offsets]
    return (u[:, offsets] * w[:, None]).sum(1) / w.sum()


def patches(heads, sides, cutoff: float, band: float):
    """Brute-force patches of the head markers ``heads`` (L, 3): (adjacency
    (L, L) bool without the diagonal, and the lipids with a pair within
    ``band`` nm of the cutoff, whose patch float32 arithmetic may decide
    either way)."""
    L = heads.shape[0]
    adj = torch.zeros(L, L, dtype=torch.bool, device=heads.device)
    near = torch.zeros(L, dtype=torch.bool, device=heads.device)
    for s in range(0, L, _BLOCK_ROWS):
        d = _min_image(heads[None, :, :] - heads[s:s + _BLOCK_ROWS, None, :], sides)
        dist = torch.linalg.vector_norm(d, dim=-1)
        rows = torch.arange(s, min(s + _BLOCK_ROWS, L), device=heads.device)
        dist[torch.arange(len(rows), device=heads.device), rows] = math.inf
        adj[s:s + _BLOCK_ROWS] = dist <= cutoff
        near[s:s + _BLOCK_ROWS] = (torch.abs(dist - cutoff) < band).any(1)
    return adj, near


def voronoi_cells(points, pmask, tf32: bool = False):
    """The 2D Voronoi cell of the origin among ``points`` (L, K, 2) (those
    of ``pmask``), cut out of the square of half side
    :data:`VORONOI_BOUND` by the bisector half-planes ``(p/2) . x <=
    |p/2|^2`` one slot after another (Sutherland-Hodgman, every lipid at
    once) -> (vertices (L, V, 2), counts (L,), whether an edge of the
    square is left (L,), the slots whose bisector bounds the cell with an
    edge of nonzero length (L, K): the Voronoi neighbours)."""
    L, K = pmask.shape
    V = K + 5
    dev, dt = points.device, points.dtype
    b = VORONOI_BOUND
    verts = torch.zeros(L, V, 2, dtype=dt, device=dev)
    verts[:, :4] = torch.tensor([[-b, -b], [b, -b], [b, b], [-b, b]], dtype=dt, device=dev)
    # The owner of each vertex's outgoing edge: -1 a side of the square,
    # else the cutting slot.
    owner = torch.full((L, V), -1, dtype=torch.long, device=dev)
    count = torch.full((L,), 4, dtype=torch.long, device=dev)
    slot = torch.arange(V, device=dev)[None, :]
    for k in range(K):
        nx, ny = 0.5 * points[:, k, 0], 0.5 * points[:, k, 1]
        c = nx * nx + ny * ny
        live = slot < count[:, None]
        d = _mm(verts, torch.stack([nx, ny], -1)[..., None], tf32)[..., 0] - c[:, None]
        inside = d < VORONOI_TOL
        all_in = (inside | ~live).all(1)
        all_out = ~(inside & live).any(1)
        cut = pmask[:, k] & (c >= VORONOI_TOL) & ~all_in & ~all_out
        nxt = torch.where(slot + 1 < count[:, None], slot + 1, 0)
        d_n = d.gather(1, nxt)
        v_n = verts.gather(1, nxt[..., None].expand(-1, -1, 2))
        in_n = inside.gather(1, nxt)
        keep = inside & live
        cross = (inside != in_n) & live
        t = d / torch.where(cross, d - d_n, torch.ones_like(d))
        hit = verts + t[..., None] * (v_n - verts)
        n_out = keep.long() + cross.long()
        at = torch.cumsum(n_out, 1) - n_out
        trash = torch.full_like(at, V)
        new_v = torch.zeros(L, V + 1, 2, dtype=dt, device=dev)
        new_o = torch.full((L, V + 1), -1, dtype=torch.long, device=dev)
        pos_a = torch.where(keep, at, trash)
        pos_b = torch.where(cross, at + keep.long(), trash)
        new_v.scatter_(1, pos_a[..., None].expand(-1, -1, 2), verts)
        new_o.scatter_(1, pos_a, owner)
        new_v.scatter_(1, pos_b[..., None].expand(-1, -1, 2), hit)
        # A cut leaving the cell starts the new edge; one entering it
        # continues the old one.
        new_o.scatter_(1, pos_b, torch.where(inside, torch.full_like(owner, k), owner))
        verts = torch.where(cut[:, None, None], new_v[:, :V], verts)
        owner = torch.where(cut[:, None], new_o[:, :V], owner)
        count = torch.where(cut, n_out.sum(1), count)
    live = slot < count[:, None]
    wall = ((owner < 0) & live).any(1)
    nxt = torch.where(slot + 1 < count[:, None], slot + 1, 0)
    edge = live & (verts.gather(1, nxt[..., None].expand(-1, -1, 2)) != verts).any(-1)
    owns = torch.zeros(L, K + 1, dtype=torch.bool, device=dev)
    owns.scatter_(1, torch.where(edge & (owner >= 0), owner, K), True)
    return verts, count, wall, owns[:, :K]


def _p2(cos):
    return 0.5 * (3.0 * cos * cos - 1.0)


def _cosine(a, b, tf32: bool):
    den = torch.sqrt(_dot(a, a, tf32) * _dot(b, b, tf32))
    num = _dot(a, b, tf32)
    return torch.clamp(num / torch.where(den == 0, torch.ones_like(den), den), -1, 1)


def tail_order(order_type: str, carbons, normals, bond_orders, tf32: bool = False):
    """Order parameters of carbons 1 .. n-2 of tails ``carbons`` (L, n, 3)
    against ``normals`` (L, 3) -> (L, n - 2). ``sz``: P2 of the angle of
    C(k+1) - C(k-1) with the normal; ``scd`` / ``scdcorr``: from the ideal
    hydrogens' frame at a saturated carbon, -(2 Sxx + Syy) / 3; at each
    carbon of a double bond the published correction by the half
    supplement of its bond angle (``scdcorr``) or its fixed 120-degree form
    (``scd``)."""
    n = carbons.shape[1]
    c = [carbons[:, k] for k in range(n)]
    out = []

    def cos(a, b):
        return _cosine(a, b, tf32)

    for k in range(1, n - 1):
        if order_type == "sz":
            out.append(_p2(cos(c[k + 1] - c[k - 1], normals)))
            continue
        before, after = bond_orders[k - 1], bond_orders[k]
        if before == 1 and after == 1:
            z = _unit(c[k + 1] - c[k - 1])
            x = _unit(torch.linalg.cross(c[k - 1] - c[k], c[k + 1] - c[k]))
            y = torch.linalg.cross(x, z)
            out.append(-(2.0 * _p2(cos(x, normals)) + _p2(cos(y, normals))) / 3.0)
            continue
        first = after == 2  # carbon k opens the double bond k=k+1
        p1, p2, p3, p4 = (c[k - 1], c[k], c[k + 1], c[k + 2]) if first else \
            (c[k - 2], c[k - 1], c[k], c[k + 1])
        z = _unit(p3 - p2)
        if first:
            half = 0.5 * (math.pi - torch.arccos(cos(p1 - p2, p3 - p2)))
            x = _unit(torch.linalg.cross(p1 - p2, z))
            sign = -1.0
        else:
            half = 0.5 * (math.pi - torch.arccos(cos(p2 - p3, p4 - p3)))
            x = _unit(torch.linalg.cross(p3 - p4, z))
            sign = 1.0
        y = torch.linalg.cross(x, z)
        szz, syy = _p2(cos(z, normals)), _p2(cos(y, normals))
        syz = 1.5 * cos(y, normals) * cos(z, normals)
        if order_type == "scdcorr":
            ch, sh = torch.cos(half), torch.sin(half)
            out.append(-(ch * ch * syy + sh * sh * szz + sign * 2.0 * ch * sh * syz))
        else:
            out.append(-(szz / 4 + 3 * syy / 4 + sign * math.sqrt(3.0) * syz / 2))
    return torch.stack(out, 1)


@_tf32_off()
def analyse(coords, sides, lipids: Lipids, cutoff: float, order_type: str = "scdcorr",
            band: float = 0.0, tf32: bool = False) -> dict:
    """The analysis of one frame: ``coords`` (n_atoms, 3) and the
    orthorhombic box ``sides`` (3,) in the dtype and on the device of the
    computation. Returns per lipid ``valid``, ``area`` (nm^2),
    ``mean_curv``, ``gauss_curv`` (1/nm, 1/nm^2), ``normal`` (L, 3),
    ``thv`` (L, 3) the unit tail-to-head vector, ``order`` (one (L, n - 2)
    a tail), ``heads`` (L, 3), ``n_patch``, ``nb_ids`` (L, K) the Voronoi
    neighbours' lipid ids (-1 elsewhere), ``n_neighbors`` and
    ``undecidable``: a lipid whose patch, or that of a member of it (the
    normal's second pass reads theirs), has a pair within ``band`` nm of
    the cutoff, or whose ``|f|`` lies within ``band`` of 0.5. ``tf32``:
    float32 products on TF32 operands (the control)."""
    dt, dev = coords.dtype, coords.device
    x = coords[lipids.rows]                                   # (L, A, 3)
    u = x[:, :1] + _min_image(x - x[:, :1], sides)
    masses = lipids.masses.to(dtype=dt, device=dev)
    heads = _marker(u, masses, lipids.head)
    tails = _marker(u, masses, lipids.tail_end)
    L = heads.shape[0]

    adj, near = patches(heads, sides, cutoff, band)
    undecidable = near | (adj & near[None, :]).any(1)
    adj_f = adj.to(dt)

    thv = _unit(heads - tails)
    normals = thv
    for _ in range(2):
        same = adj_f * (_mm(normals, normals.T, tf32) >= 0).to(dt)
        normals = _unit(normals + _mm(same, normals, tf32))

    n_patch = adj.sum(1)
    K = max(int(n_patch.max()), 1)
    order_by = torch.sort(adj.to(torch.int8), dim=1, descending=True, stable=True).indices
    pid = order_by[:, :K]
    pmask = torch.arange(K, device=dev)[None, :] < n_patch[:, None]

    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev).expand(L, 3)
    c0 = torch.linalg.cross(normals, ex)
    c1 = torch.linalg.cross(normals, c0)
    to_lab = torch.stack([c0, c1, -normals], dim=-1)         # (L, 3, 3), columns
    det = torch.linalg.det(to_lab)
    singular = ~torch.isfinite(det) | (torch.abs(det) < 1e-12)
    eye = torch.eye(3, dtype=dt, device=dev).expand(L, 3, 3)
    to_local = torch.linalg.inv(torch.where(singular[:, None, None], eye, to_lab))

    rel = _min_image(heads[pid] - heads[:, None, :], sides)  # (L, K, 3)
    local = _mm(rel, to_local.transpose(1, 2), tf32)
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    design = torch.stack([lx * lx, ly * ly, lx * ly, lx, ly, torch.ones_like(lx)], -1)
    design = design * pmask[..., None].to(dt)
    normal_eq = _mm(design.transpose(1, 2), design, tf32)    # (L, 6, 6)
    rhs = _mm(design.transpose(1, 2), (lz * pmask.to(dt))[..., None], tf32)
    valid = (n_patch > 0) & ~singular
    normal_eq = torch.where(valid[:, None, None], normal_eq,
                            torch.eye(6, dtype=dt, device=dev).expand(L, 6, 6))
    chol, info = torch.linalg.cholesky_ex(normal_eq)
    valid &= info == 0
    coefs = torch.cholesky_solve(rhs, torch.where((info == 0)[:, None, None], chol,
                                                  torch.eye(6, dtype=dt, device=dev)))[..., 0]
    a, b, c, d, e, f = coefs.unbind(-1)
    E, F, G = 1 + d * d, d * e, 1 + e * e
    Lq, Mq, Nq = 2 * a, c, 2 * b
    Z = torch.where(valid, E * G - F * F, torch.ones_like(E))
    gauss = (Lq * Nq - Mq * Mq) / Z
    mean = 0.5 * (E * Nq - 2 * F * Mq + G * Lq) / Z
    vn = _unit(torch.stack([d, e, -torch.ones_like(d)], -1))
    new_normals = _mm(to_lab, vn[..., None], tf32)[..., 0]

    cuts = pmask & valid[:, None]
    verts, count, wall, nb = voronoi_cells(local[..., :2], cuts, tf32)
    V = verts.shape[1]
    vx, vy = verts[..., 0], verts[..., 1]
    vz = (a[:, None] * vx * vx + b[:, None] * vy * vy + c[:, None] * vx * vy
          + d[:, None] * vx + e[:, None] * vy + f[:, None])
    lifted = _mm(torch.stack([vx, vy, vz], -1), to_lab.transpose(1, 2), tf32)  # (L, V, 3)
    slot = torch.arange(V, device=dev)[None, :]
    nxt = torch.where(slot + 1 < count[:, None], slot + 1, 0)
    following = lifted.gather(1, nxt[..., None].expand(-1, -1, 3))
    tri = torch.linalg.vector_norm(torch.linalg.cross(lifted, following), dim=-1)
    area = 0.5 * torch.where(slot < count[:, None], tri, torch.zeros_like(tri)).sum(1)
    area = torch.where(count >= 3, area, torch.zeros_like(area))
    valid &= ~wall & (torch.abs(f) <= 0.5)
    undecidable |= torch.abs(torch.abs(f) - 0.5) < band

    order = [tail_order(order_type, u[:, offsets], new_normals, bonds, tf32)
             for offsets, bonds in lipids.tails]
    return {"valid": valid, "area": area, "mean_curv": mean, "gauss_curv": gauss,
            "normal": new_normals, "thv": thv, "order": order, "heads": heads,
            "n_patch": n_patch, "nb_ids": torch.where(nb, pid, -1), "n_neighbors": nb.sum(1),
            "undecidable": undecidable}
