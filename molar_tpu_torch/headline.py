"""The trajectory headline on torch: RMSD fit + 0.5 nm PBC ``within`` search.

The port of ``bench.py``'s window function and its streaming loop. Per frame of a
streamed XTC window: a mass-weighted Kabsch fit and RMSD of the "protein"
selection against the reference, a periodic ``within`` mask of every atom
against that selection (the ghost-slab CUDA kernel on the card), its count,
and a uint32 membership checksum ``sum(idx + 1)`` mod 2^32 that catches any
set difference, not just a count difference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import convert
from .io.xtc import XtcHandler
from .ops.measure import fit_rmsd
from .ops.neighbor import estimate_caps, within_mask
from .tasks.trajectory import TrajectoryReader, decode_window_coords, run_with_overflow_retry


def make_system(n_atoms: int, n_protein: int, box_side: float, seed: int = 0):
    """Synthetic solvated-protein-like system (``bench.py:make_system``):
    a uniform-density ball of "protein" atoms (indices ``0..n_protein-1``)
    in the middle of a water box, ~n_atoms / box_side^3 atoms per nm^3.
    Returns (coords (n, 3) f32, masses (n,) f32)."""
    rng = np.random.default_rng(seed)
    water = rng.uniform(0, box_side, (n_atoms - n_protein, 3)).astype(np.float32)
    density = n_atoms / box_side**3
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    protein = (box_side / 2 + d * r).astype(np.float32)
    coords = np.concatenate([protein, water])
    masses = rng.uniform(1.0, 16.0, n_atoms).astype(np.float32)
    return coords, masses


def write_trajectory(path: str, coords0, box_matrix, n_frames: int, sigma: float = 0.02,
                     seed: int = 1) -> None:
    """Random-walk trajectory from ``coords0`` (``bench.py:make_trajectory``)."""
    rng = np.random.default_rng(seed)
    c = coords0.copy()
    with XtcHandler(path, "w") as w:
        for k in range(n_frames):
            c = c + rng.normal(0, sigma, c.shape).astype(np.float32)
            w.write_raw(c, box_matrix, step=k, time=float(k))


def base_caps(xtc_path: str, inv, dims, protein_idx) -> tuple[int, int]:
    """Frame-0 exact occupancies (source cap, target cap) that size tier 0.
    Drift beyond the tier margins is absorbed by the overflow retry."""
    with XtcHandler(xtc_path) as h:
        c0 = h.read_frame(0).coords
    cap, tcap, _ = estimate_caps(c0, inv, dims, protein_idx, margin=1.0, round_to=1)
    return cap, tcap


def caps_for(cap0: int, tcap0: int, tier: int) -> tuple[int, int]:
    """Capacity tier ``tier``: x1.2 margin, x1.5 per tier, +2 slots, rounded
    up to a multiple of 8 (``bench.py:caps_for``)."""
    g = 1.5**tier
    cap = (int(cap0 * 1.2 * g) + 2 + 7) // 8 * 8
    tcap = (int(tcap0 * 1.2 * g) + 2 + 7) // 8 * 8
    return cap, tcap


class FitWithinWindow(nn.Module):
    """Per-frame RMSD fit + within search over one decoded window.

    Buffers: ``ref`` (n_sel, 3), ``masses`` (n_sel,), ``protein_idx``
    (n_sel,) int64. Static: ``cutoff``, ``dims``, ``cap``, ``tgt_cap``.
    """

    def __init__(self, ref, masses, protein_idx, cutoff: float, dims, cap: int, tgt_cap: int):
        super().__init__()
        self.register_buffer("ref", ref)
        self.register_buffer("masses", masses)
        self.register_buffer("protein_idx", protein_idx)
        self.cutoff = cutoff
        self.dims = tuple(dims)
        self.cap = cap
        self.tgt_cap = tgt_cap

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        """-> per frame (rmsd f32, count i64, checksum i64 in [0, 2^32),
        overflow bool), each of shape (B,)."""
        coords = decode_window_coords(transport)
        rmsd, _, _ = fit_rmsd(coords[:, self.protein_idx], self.ref, self.masses)
        ids1 = torch.arange(1, coords.shape[1] + 1, device=coords.device)
        counts, checks, overflows = [], [], []
        for b in range(coords.shape[0]):
            mask, ofl = within_mask(
                coords[b], None, self.protein_idx, self.cutoff, boxes[b], invs[b],
                dims=self.dims, cap=self.cap, tgt_cap=self.tgt_cap,
            )
            counts.append(mask.sum())
            # torch has no uint32 sum: int64 sum, then wrap to 32 bits.
            checks.append((ids1 * mask).sum() & 0xFFFFFFFF)
            overflows.append(ofl)
        return rmsd, torch.stack(counts), torch.stack(checks), torch.stack(overflows)


def run(xtc_path, ref, masses, protein_idx, box, cutoff, dims, caps0, window, device):
    """Stream ``xtc_path`` in i8-delta windows through
    :class:`FitWithinWindow`, retrying overflowed windows over four capacity
    tiers (``bench.py``'s settings). ``caps0`` = :func:`base_caps`. Returns
    (frame ids, rmsd, count, checksum) numpy arrays in stream order, and the
    retried window count."""

    def build(tier):
        return convert.from_numpy(
            ref, masses, protein_idx, box.matrix, cutoff, caps_for(*caps0, tier), dims, device
        )

    results, retried = run_with_overflow_retry(
        TrajectoryReader([xtc_path]), window, build, device,
        overflow_of=lambda r: r[3], n_tiers=4, quantized="delta",
    )
    ids = np.concatenate([np.asarray(i) for i, _ in results])
    rmsd, count, check = (
        torch.cat([r[k] for _, r in results]).cpu().numpy() for k in range(3)
    )
    return ids, rmsd, count, check, retried
