"""Shrake-Rupley SASA in torch: sphere sampling, one frame or a window.

Counterpart of ``molar_tpu.ops.sasa``, the approximate companion of the
exact Lee-Richards :mod:`.sasa_lr`: each solvent-expanded sphere carries a
fixed Fibonacci point set; a point is accessible iff it lies outside every
neighbour sphere. Per-atom area = 4 pi R^2 * accessible fraction. Sampling
error ~ O(1/sqrt(P)) per atom (~1 % at P = 960).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config  # noqa: F401  (pins fp32 products)
from .sasa_lr import _dense_pairs, _fill_lists

DEFAULT_PROBE = 0.14


def fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) well-distributed unit sphere points (golden spiral)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = np.pi * (1 + 5**0.5)
    theta = golden * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    ).astype(np.float32)


def neighbor_matrix(coords, radii, cap: int = 64):
    """Host helper (numpy): (N, cap) neighbour indices (-1 padded) of
    overlapping solvent-expanded spheres, each row in index order. Returns
    (matrix, overflowed)."""
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(radii, np.float64)
    owners, others = _dense_pairs(coords, radii, 0.0)
    return _fill_lists(owners, others, len(coords), cap)


@torch.no_grad()
def shrake_rupley(coords, radii, neighbors, n_points: int = 960):
    """Per-atom SASA.

    ``coords`` (N, 3) or a window (B, N, 3), ``radii`` (N,), ``neighbors``
    (N, K) int (-1 padded, built on the host per frame or reused across a
    window when the topology is stable). Computes where ``coords`` lives.
    """
    coords = torch.as_tensor(coords)
    device, dtype = coords.device, coords.dtype
    radii = torch.as_tensor(radii, dtype=dtype, device=device)
    neighbors = torch.as_tensor(neighbors, device=device)
    pts = torch.as_tensor(fibonacci_sphere(n_points), dtype=dtype, device=device)  # (P, 3)
    nb = neighbors.clamp_min(0).long()  # (N, K)
    nb_valid = neighbors >= 0
    nr2 = (radii[nb] ** 2)[:, :, None]

    def one_frame(c):
        sp = c[:, None, :] + radii[:, None, None] * pts[None, :, :]  # (N, P, 3)
        nc = c[nb]  # (N, K, 3)
        d2 = ((sp[:, None, :, :] - nc[:, :, None, :]) ** 2).sum(dim=-1)  # (N, K, P)
        buried = (nb_valid[:, :, None] & (d2 < nr2)).any(dim=1)  # (N, P)
        frac = 1.0 - buried.to(dtype).mean(dim=1)
        return 4.0 * math.pi * radii**2 * frac

    if coords.dim() == 2:
        return one_frame(coords)
    return torch.stack([one_frame(c) for c in coords])
