"""The work a roofline share owes, counted from the inputs alone, so that the
count is the same whatever implements the search.

* A within search of ``sources`` against every atom owes, each frame, the
  candidate pairs of a periodic cell grid whose cells are at least a cutoff
  high: each source against every atom of the 27 cells around its own.
* Lee-Richards SASA owes, each frame, its overlapping sphere pairs (ordered,
  ``|xi - xj| < ri + rj``) times the slices.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..frozen import bounds
from ..reference.geometry import heights


def candidate_pairs(frames: np.ndarray, box: np.ndarray, sources: np.ndarray,
                    cutoff: float) -> int:
    """Candidate pairs of a within search over ``frames`` (B, n, 3)."""
    m = np.asarray(box, np.float64)
    dims = np.maximum(np.floor(heights(m) / cutoff).astype(np.int64), 1)
    inv = np.linalg.inv(m)
    total = 0
    for x in frames:
        frac = (np.asarray(x, np.float64) @ inv.T) % 1.0
        cell = np.minimum((frac * dims).astype(np.int64), dims - 1)
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        grid = np.bincount(flat, minlength=int(np.prod(dims))).reshape(tuple(dims))
        near = np.zeros_like(grid)
        for s in itertools.product((-1, 0, 1), repeat=3):
            near += np.roll(grid, s, axis=(0, 1, 2))
        total += int(near.reshape(-1)[flat[sources]].sum())
    return total


def search_work(frames: np.ndarray, box, sources, cutoff: float) -> dict:
    """FLOPs and bytes of a window's within search: the coordinates read
    once, the (B, n) byte mask written once."""
    b, n = frames.shape[:2]
    pairs = candidate_pairs(frames, box, sources, cutoff)
    return {"flops": bounds.FLOPS_PER_CANDIDATE_PAIR * pairs, "bytes": b * n * (12 + 1),
            "items": pairs}


@torch.no_grad()
def overlapping_pairs(frames: torch.Tensor, radii: torch.Tensor, block: int = 2048) -> int:
    """Ordered overlapping pairs over ``frames`` (B, n, 3), in float64 on
    their device."""
    total = 0
    r = radii.to(torch.float64)
    for x in frames.to(torch.float64):
        for s in range(0, len(x), block):
            d2 = ((x[s:s + block, None, :] - x[None, :, :]) ** 2).sum(-1)
            reach = r[s:s + block, None] + r[None, :]
            total += int((d2 < reach * reach).sum()) - min(block, len(x) - s)
    return total


def sasa_work(frames: torch.Tensor, radii: torch.Tensor, n_slices: int,
              n_residues: int) -> dict:
    """FLOPs and bytes of a window of Lee-Richards SASA: coordinates and
    radii in, per-residue areas out."""
    b, n = frames.shape[:2]
    pairs = overlapping_pairs(frames, radii)
    return {"flops": bounds.FLOPS_PER_SASA_TRIPLE * pairs * n_slices,
            "bytes": b * n * 12 + n * 4 + b * n_residues * 4, "items": pairs}
