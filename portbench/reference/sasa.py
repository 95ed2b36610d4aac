"""Plain PyTorch reference of exact Lee-Richards SASA with z-slices.

Each sphere (radius = vdW + probe) is cut into ``n_slices`` slabs at the
midpoints of equal steps over its diameter; in each slab the arcs of the
sphere's circle that overlapping neighbours' circles cover are united, and
the exposed angle times R times the slab height is the slab's area (the
measure of ``molar_tpu_torch/ops/sasa_host.py``, written again here as
dense tensor code). Neighbours are the spheres that overlap, found by a
dense distance matrix from a matrix product, so the dtype and matmul
precision the caller sets decide that step as they decide the rest.
"""

from __future__ import annotations

import math

import torch

# (rows x slices x 2 neighbour slots) elements of one block.
_BLOCK_ELEMS = 1 << 25


def neighbours(coords: torch.Tensor, radii: torch.Tensor):
    """Overlapping pairs ``|xi - xj| < ri + rj``, i != j -> ((n, K) indices,
    (n, K) valid), K the most any atom has."""
    n = len(coords)
    c2 = (coords * coords).sum(dim=1)
    d2 = torch.addmm(c2[None, :] + c2[:, None], coords, coords.T, beta=1, alpha=-2)
    reach = radii[:, None] + radii[None, :]
    hit = (d2 < reach * reach)
    hit.fill_diagonal_(False)
    counts = hit.sum(dim=1)
    k = max(int(counts.max()), 1) if n else 1
    order = torch.sort(hit.to(torch.int8), dim=1, descending=True, stable=True).indices[:, :k]
    valid = torch.arange(k, device=coords.device)[None, :] < counts[:, None]
    return order, valid


def atom_areas(coords: torch.Tensor, radii: torch.Tensor, n_slices: int) -> torch.Tensor:
    """Per-atom accessible area of one frame (n, 3), in the inputs' dtype."""
    nbr, valid = neighbours(coords, radii)
    n, k = nbr.shape
    pi = math.pi
    ks = torch.arange(n_slices, dtype=coords.dtype, device=coords.device) + 0.5
    step = max(1, _BLOCK_ELEMS // (n_slices * 2 * k))
    out = []
    for s in range(0, n, step):
        ci, ri = coords[s:s + step], radii[s:s + step]
        nb, ok = nbr[s:s + step], valid[s:s + step]
        cj, rj = coords[nb], radii[nb]                      # (R, K, 3), (R, K)
        dx = cj[..., 0] - ci[:, None, 0]
        dy = cj[..., 1] - ci[:, None, 1]
        d = torch.sqrt(dx * dx + dy * dy)[:, None, :]       # (R, 1, K)
        theta = torch.atan2(dy, dx)[:, None, :]
        dz = 2 * ri / n_slices
        zrel = -ri[:, None] + dz[:, None] * ks[None, :]     # (R, S): z - zi
        rk2 = ri[:, None] ** 2 - zrel ** 2
        rk = torch.sqrt(torch.clamp_min(rk2, 0.0))[:, :, None]
        dzj = ci[:, None, 2:3] + zrel[:, :, None] - cj[:, None, :, 2]
        cj2 = rj[:, None, :] ** 2 - dzj * dzj
        rc = torch.sqrt(torch.clamp_min(cj2, 0.0))
        act = ok[:, None, :] & (cj2 > 0) & (rk2 > 0)[:, :, None]
        full = (act & (d + rk <= rc)).any(dim=2)
        covers = act & ~(d >= rk + rc) & ~(d + rk <= rc) & ~(d + rc <= rk)
        cos = (d * d + rk * rk - rc * rc) / torch.where(covers, 2 * d * rk, 1.0)
        half = torch.acos(torch.clamp(cos, -1.0, 1.0))
        lo, hi = theta - half, theta + half
        # Each covering arc as at most two pieces inside [-pi, pi]; an
        # absent piece is empty (lo = pi, hi = -pi).
        lo1 = torch.where(covers, torch.clamp_min(lo, -pi), pi)
        hi1 = torch.where(covers, torch.clamp_max(hi, pi), -pi)
        wrap_lo, wrap_hi = covers & (lo < -pi), covers & (hi > pi)
        lo2 = torch.where(wrap_lo, lo + 2 * pi, torch.where(wrap_hi, -pi, pi))
        hi2 = torch.where(wrap_lo, pi, torch.where(wrap_hi, hi - 2 * pi, -pi))
        los, his = torch.cat([lo1, lo2], dim=2), torch.cat([hi1, hi2], dim=2)
        los, order = torch.sort(los, dim=2)
        his = torch.gather(his, 2, order)
        reach = torch.cummax(his, dim=2).values
        prev = torch.cat([torch.full_like(reach[:, :, :1], -pi), reach[:, :, :-1]], dim=2)
        union = torch.clamp_min(his - torch.maximum(los, prev), 0.0).sum(dim=2)
        exposed = torch.where((rk2 > 0) & ~full, 2 * pi - union, 0.0)
        out.append(exposed.sum(dim=1) * ri * dz)
    return torch.cat(out) if out else coords.new_zeros(0)


def residue_areas(coords, radii, residue_of, n_residues: int, n_slices: int) -> torch.Tensor:
    """Per-residue sums of :func:`atom_areas`; ``residue_of`` (n,) int64."""
    a = atom_areas(coords, radii, n_slices)
    return torch.zeros(n_residues, dtype=a.dtype, device=a.device).index_add_(0, residue_of, a)
