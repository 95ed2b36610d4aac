"""Batched geometric measures in torch: the headline's RMSD fit.

Counterpart of ``molar_tpu.ops.measure`` (``center``, ``rmsd_mw``,
``kabsch``, ``fit_transform``, ``apply_transform``, ``fit_rmsd``), broadcast
over leading frame dims. The Kabsch rotation keeps the JAX package's form —
Horn's quaternion key matrix, a Gershgorin shift and 60 power iterations —
for parity: it always yields a proper rotation (no reflection fix needed).
Products run in full fp32 (``config`` turns TF32 off).
"""

from __future__ import annotations

import torch

from .. import config  # noqa: F401  (pins fp32 matmuls)

__all__ = ["center", "rmsd_mw", "kabsch", "fit_transform", "apply_transform", "fit_rmsd"]


def center(coords, weights=None):
    """(..., n, 3) -> (..., 3). Center of mass (weights (n,)) or geometry."""
    if weights is None:
        return coords.mean(dim=-2)
    w = weights / weights.sum()
    return torch.einsum("n,...ni->...i", w, coords)


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
