"""Batched geometric measures in torch.

Counterpart of ``molar_tpu.ops.measure``: every function is plain tensor
code, broadcast over leading frame dims, with the JAX package's numerics.
PBC centres accumulate closest images relative to atom 0; the Kabsch
rotation keeps Horn's quaternion key matrix, a Gershgorin shift and 60
power iterations (always a proper rotation, no reflection fix needed);
inertia moments ascend and the third axis is the cross of the first two.
Per-segment reductions use the dense slot-major layout of
:func:`contiguous_segments_dense` (one gather on the atom axis, a short
sum over the slot axis). Products run in full fp32 (``config`` turns TF32
off).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config  # noqa: F401  (pins fp32 matmuls)

__all__ = [
    "contiguous_segments_dense",
    "dense_segment_sum",
    "dense_segment_com_gyration",
    "center",
    "center_pbc",
    "gyration",
    "inertia_tensor",
    "inertia",
    "rmsd",
    "rmsd_mw",
    "kabsch",
    "fit_transform",
    "apply_transform",
    "fit_rmsd",
    "min_image",
    "inv3x3",
]


def inv3x3(m):
    """Closed-form (adjugate) 3x3 inverse, batched over leading dims."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)],
        dim=-2,
    )
    return adj / det[..., None, None]


def _matvec(m, v):
    """``m @ v`` for (..., 3, 3) against (..., 3), elementwise and summed."""
    return (m * v[..., None, :]).sum(dim=-1)


def min_image(vec, boxes, invs, corrections=None, pbc=(True, True, True)):
    """Batched minimum image: ``vec`` (..., 3), ``boxes``/``invs``
    broadcastable (..., 3, 3) against vec's batch dims, ``corrections``
    (..., K, 3) or None, ``pbc`` static.

    Inverse transform, round (half to even) on the periodic axes, forward
    transform; then, under full PBC, the first shortest correction
    candidate replaces the result only when strictly shorter (zero rows are
    no-ops)."""
    frac = _matvec(invs, vec)
    if all(pbc):
        frac = frac - torch.round(frac)
    elif any(pbc):
        frac = torch.stack([f - torch.round(f) if per else f
                            for f, per in zip(frac.unbind(-1), pbc)], dim=-1)
    start = _matvec(boxes, frac)
    if corrections is None or not all(pbc):
        return start
    cands = start[..., None, :] + corrections
    n2 = (cands * cands).sum(dim=-1)
    start2 = (start * start).sum(dim=-1)
    best = torch.argmin(n2, dim=-1, keepdim=True)
    cand_best = torch.gather(cands, -2, best[..., None].expand(*best.shape, 3))[..., 0, :]
    cand_n2 = torch.gather(n2, -1, best)[..., 0]
    return torch.where((cand_n2 < start2)[..., None], cand_best, start)


def contiguous_segments_dense(segment_ids, weights=None):
    """Static slot-major dense layout for sorted contiguous segment ids
    (host, numpy).

    Every run is padded to the longest run, so per-segment sums become one
    gather plus a short dense masked sum. Returns ``(idx, w, counts)``:
    ``idx`` ``(Lmax * nseg,)`` int32 gather indices, slot-major (a gathered
    ``(..., n)`` array reshapes to ``(..., Lmax, nseg)``); ``w`` ``(Lmax,
    nseg)`` float32 with ``weights`` at live slots and 0 at padding
    (padding indices point at the run's last atom); ``counts`` the run
    lengths. Each segment's sum has at most Lmax terms, so its float32
    error does not grow with n.
    """
    seg = np.asarray(segment_ids)
    n = seg.shape[0]
    starts = np.flatnonzero(np.diff(seg, prepend=seg[0] - 1))
    ends = np.append(starts[1:], n)
    counts = (ends - starts).astype(np.int64)
    lmax = int(counts.max())
    slot = np.arange(lmax)[:, None]
    idx = np.minimum(starts[None, :] + slot, ends[None, :] - 1)
    w = (slot < counts[None, :]).astype(np.float32)
    if weights is not None:
        w = w * np.asarray(weights, np.float32)[idx]
    return idx.reshape(-1).astype(np.int32), w, counts


def dense_segment_sum(values, idx, w):
    """Per-segment weighted sums over the last axis: ``values`` (..., n)
    with ``(idx, w)`` from :func:`contiguous_segments_dense` -> (..., nseg)."""
    lmax, nseg = w.shape
    g = values.index_select(-1, idx).reshape(values.shape[:-1] + (lmax, nseg))
    return (g * w).sum(dim=-2)


def dense_segment_com_gyration(coords, idx, w):
    """Per-segment centre of mass and radius of gyration: ``coords`` (...,
    n, 3) with ``(idx, w)`` from :func:`contiguous_segments_dense`, ``w``
    carrying the masses -> ``(com (..., nseg, 3), gyr (..., nseg))``. One
    gather on the atom axis; the sums run over the slot axis, then over
    x, y, z in that order."""
    lmax, nseg = w.shape
    msum = w.sum(dim=0)
    g = coords.index_select(-2, idx).reshape(coords.shape[:-2] + (lmax, nseg, 3))
    wk = w[..., None]
    com = (g * wk).sum(dim=-3) / msum[:, None]
    d = g - com[..., None, :, :]
    s = (d * d * wk).sum(dim=-3)
    g2 = s[..., 0] + s[..., 1] + s[..., 2]
    return com, torch.sqrt(g2 / msum)


def center(coords, weights=None):
    """(..., n, 3) -> (..., 3). Center of mass (weights (n,)) or geometry."""
    if weights is None:
        return coords.mean(dim=-2)
    w = weights / weights.sum()
    return torch.einsum("n,...ni->...i", w, coords)


def _centered(coords, masses, boxes, invs, corrections, pbc):
    """(displacements from the (PBC) centre of mass, the centre)."""
    if boxes is None:
        c = center(coords, masses)
        return coords - c[..., None, :], c
    c = center_pbc(coords, masses, boxes, invs, corrections, pbc)
    d = min_image(
        coords - c[..., None, :],
        boxes[..., None, :, :],
        invs[..., None, :, :],
        None if corrections is None else corrections[..., None, :, :],
        pbc,
    )
    return d, c


def center_pbc(coords, weights, boxes, invs, corrections=None, pbc=(True, True, True)):
    """PBC-aware centre: closest images relative to atom 0, then the
    average. ``boxes``/``invs`` (..., 3, 3) per frame, coords (..., n, 3)."""
    ref = coords[..., 0:1, :]
    img = ref + min_image(
        coords - ref,
        boxes[..., None, :, :],
        invs[..., None, :, :],
        None if corrections is None else corrections[..., None, :, :],
        pbc,
    )
    return center(img, weights)


def gyration(coords, masses, boxes=None, invs=None, corrections=None, pbc=(True, True, True)):
    """Radius of gyration (..., n, 3) -> (...,)."""
    d, _ = _centered(coords, masses, boxes, invs, corrections, pbc)
    w = masses / masses.sum()
    return torch.sqrt(torch.einsum("n,...n->...", w, (d * d).sum(dim=-1)))


def inertia_tensor(coords, masses, boxes=None, invs=None, corrections=None,
                   pbc=(True, True, True)):
    """(..., 3, 3) inertia tensor ``sum m (r^2 I - r r^T)`` about the (PBC)
    centre of mass, and that centre (..., 3)."""
    d, c = _centered(coords, masses, boxes, invs, corrections, pbc)
    r2 = (d * d).sum(dim=-1)
    outer = torch.einsum("...ni,...nj,n->...ij", d, d, masses)
    tr = torch.einsum("...n,n->...", r2, masses)
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device)
    return tr[..., None, None] * eye - outer, c


def inertia(coords, masses, boxes=None, invs=None, corrections=None, pbc=(True, True, True)):
    """(moments ascending, axes as right-handed columns, centre of mass).
    The sign of each of the first two axes is the eigensolver's."""
    t, c = inertia_tensor(coords, masses, boxes, invs, corrections, pbc)
    vals, vecs = torch.linalg.eigh(t)
    third = torch.linalg.cross(vecs[..., :, 0], vecs[..., :, 1], dim=-1)
    return vals, torch.stack([vecs[..., :, 0], vecs[..., :, 1], third], dim=-1), c


def rmsd(coords1, coords2):
    """(..., n, 3) x (..., n, 3) -> (...,). Plain (unweighted) RMSD."""
    d = coords1 - coords2
    return torch.sqrt((d * d).sum(dim=-1).mean(dim=-1))


def rmsd_mw(coords1, coords2, masses):
    w = masses / masses.sum()
    d = coords1 - coords2
    return torch.sqrt(torch.einsum("n,...n->...", w, (d * d).sum(dim=-1)))


def _quat_to_rot(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def kabsch(centered1, centered2, masses, iters: int = 60):
    """Optimal rotation R (..., 3, 3) minimizing ``sum m |R p1 - p2|^2`` for
    COM-centered (..., n, 3) inputs (Horn's method, shifted power
    iteration on the 4x4 key matrix)."""
    m = masses / masses.sum()
    s = torch.einsum("...ni,...nj,n->...ij", centered2, centered1, m)
    s00, s01, s02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s10, s11, s12 = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    s20, s21, s22 = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    k = torch.stack(
        [
            torch.stack([s00 + s11 + s22, s21 - s12, s02 - s20, s10 - s01], -1),
            torch.stack([s21 - s12, s00 - s11 - s22, s01 + s10, s02 + s20], -1),
            torch.stack([s02 - s20, s01 + s10, s11 - s00 - s22, s12 + s21], -1),
            torch.stack([s10 - s01, s02 + s20, s12 + s21, s22 - s00 - s11], -1),
        ],
        dim=-2,
    )
    # Gershgorin shift: lambda_max of K + shift*I is the largest in
    # magnitude, so plain power iteration converges to it.
    shift = k.abs().sum(dim=(-2, -1), keepdim=True)
    ks = k + shift * torch.eye(4, dtype=k.dtype, device=k.device)
    q = torch.full(k.shape[:-2] + (4,), 0.5, dtype=k.dtype, device=k.device)
    for _ in range(iters):
        v = (ks @ q[..., None])[..., 0]
        q = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return _quat_to_rot(q)


def fit_transform(coords1, coords2, masses):
    """(R, t) superimposing coords1 onto coords2, mass-weighted."""
    cm1 = center(coords1, masses)
    cm2 = center(coords2, masses)
    r = kabsch(coords1 - cm1[..., None, :], coords2 - cm2[..., None, :], masses)
    t = cm2 - (r @ cm1[..., None])[..., 0]
    return r, t


def apply_transform(coords, r, t):
    """(..., n, 3) under the affine (..., 3, 3), (..., 3)."""
    return coords @ r.transpose(-1, -2) + t[..., None, :]


def fit_rmsd(mobile, ref, masses):
    """RMSD of ``mobile`` (..., n, 3) frames to ``ref`` (n, 3) after the
    optimal mass-weighted fit. Returns (rmsd (...,), R, t)."""
    r, t = fit_transform(mobile, ref.expand(mobile.shape), masses)
    return rmsd_mw(apply_transform(mobile, r, t), ref, masses), r, t
