"""Plain PyTorch reference of the fit, the RMSD, the centre of mass and the
periodic ``within`` search.

Independent of the program: a Kabsch fit by SVD, and a brute-force search
over the 27 lattice images of the wrapped sources, exact for any box (a
pair within the cutoff, with both points in the unit cell, needs an image
shift of -1, 0 or 1 along each box vector). Every large product is a
matrix product, so the dtype and the matmul precision that the caller sets
decide the arithmetic: float64 for the reference, float32 with TF32 on for
its control.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

_SHIFTS = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.float64)
# Sources a block of targets is held against: targets x images under this.
_BLOCK_ELEMS = 1 << 27


def fit_rmsd(mobile: torch.Tensor, ref: torch.Tensor, masses: torch.Tensor):
    """Mass-weighted optimal superposition of ``mobile`` (n, 3) onto ``ref``
    -> (rmsd after the fit, R, t) with ``x -> R x + t``; all in the inputs'
    dtype."""
    w = (masses / masses.sum())[None, :]
    cm1 = (w @ mobile)[0]
    cm2 = (w @ ref)[0]
    p1, p2 = mobile - cm1, ref - cm2
    h = (p1 * w.T).T @ p2  # sum m p1 p2^T
    u, _, vt = torch.linalg.svd(h.cpu())
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    fix = torch.diag(torch.tensor([1.0, 1.0, float(d)], dtype=h.dtype))
    r = (vt.T @ fix @ u.T).to(mobile.device)
    t = cm2 - r @ cm1
    fitted = mobile @ r.T + t
    rmsd = torch.sqrt((w @ ((fitted - ref) ** 2).sum(dim=1, keepdim=True))[0, 0])
    return rmsd, r, t


def rmsd_mw(a: torch.Tensor, b: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    w = (masses / masses.sum())[None, :]
    return torch.sqrt((w @ ((a - b) ** 2).sum(dim=1, keepdim=True))[0, 0])


def com(coords: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    w = (masses / masses.sum())[None, :]
    return (w @ coords)[0]


def heights(box: np.ndarray) -> np.ndarray:
    """Perpendicular heights of the cell (columns are the box vectors)."""
    m = np.asarray(box, np.float64)
    vol = abs(np.linalg.det(m))
    return np.array([vol / np.linalg.norm(np.cross(m[:, (k + 1) % 3], m[:, (k + 2) % 3]))
                     for k in range(3)])


def min_distance(coords: torch.Tensor, src: np.ndarray, box: np.ndarray,
                 reach: float) -> torch.Tensor:
    """Each atom's shortest periodic distance to the atoms ``src`` -> (n,),
    exact wherever it is at most ``reach``; above it, a value above
    ``reach``. ``coords`` (n, 3) in the dtype of the arithmetic."""
    dt, dev = coords.dtype, coords.device
    m = torch.as_tensor(np.asarray(box, np.float64), dtype=dt, device=dev)
    inv = torch.as_tensor(np.linalg.inv(np.asarray(box, np.float64)), dtype=dt, device=dev)
    frac = coords @ inv.T
    frac = frac - torch.floor(frac)
    wrapped = frac @ m.T
    fs = frac[torch.as_tensor(src, device=dev)]
    ws = wrapped[torch.as_tensor(src, device=dev)]
    # An image shifted +1 along a vector can reach the cell only from a
    # source within ``reach`` of that face, and -1 from the opposite one.
    c = torch.as_tensor((reach + 1e-3) / heights(box), dtype=dt, device=dev)
    images = []
    for s in _SHIFTS:
        keep = torch.ones(len(src), dtype=torch.bool, device=dev)
        for k in range(3):
            if s[k] > 0:
                keep &= fs[:, k] < c[k]
            elif s[k] < 0:
                keep &= fs[:, k] > 1 - c[k]
        if bool(keep.any()):
            shift = torch.as_tensor(s, dtype=dt, device=dev) @ m.T
            images.append(ws[keep] + shift)
    b = torch.cat(images)
    b2 = (b * b).sum(dim=1)
    out = []
    step = max(1, _BLOCK_ELEMS // len(b))
    for s in range(0, len(wrapped), step):
        a = wrapped[s:s + step]
        g = torch.addmm(b2[None, :], a, b.T, beta=1, alpha=-2)  # |b|^2 - 2 a.b
        out.append(g.min(dim=1).values + (a * a).sum(dim=1))
    return torch.sqrt(torch.clamp_min(torch.cat(out), 0.0))


def within_sets(dmin: np.ndarray, cutoff: float, band: float):
    """(atoms within the cutoff, atoms within ``band`` nm of it): the second
    set is the one a float32 program may decide either way."""
    d = np.asarray(dmin, np.float64)
    return np.flatnonzero(d <= cutoff), np.flatnonzero(np.abs(d - cutoff) <= band)
