"""The trajectory headline on torch: RMSD fit + 0.5 nm PBC ``within`` search.

The port of ``bench.py``'s window function and its streaming loop. Per frame of a
streamed XTC window: a mass-weighted Kabsch fit and RMSD of the "protein"
selection against the reference, a periodic ``within`` mask of every atom
against that selection, its count, and a uint32 membership checksum
``sum(idx + 1)`` mod 2^32 that catches any set difference, not just a count
difference. The search takes one of three routes (:data:`SEARCHES`), fixed
when the window function is built (:func:`convert.from_numpy` picks it from
the box): the ghost-slab CUDA kernels (binning and stencil, once per
window), the per-pair min-image CUDA kernel over the same binning (once per
window; orthorhombic boxes, full PBC), or the triclinic correction path
(any box, correction candidates from each frame's own box).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import convert
from .io.xtc import XtcHandler
from .ops.measure import fit_rmsd
from .ops.neighbor import estimate_caps, within_mask, within_mask_window
from .ops.neighbor_rows import within_mask_rows_window
from .tasks import trajectory
from .tasks.trajectory import TrajectoryReader, decode_window_coords, run_with_overflow_retry

#: The search routes of :class:`FitWithinWindow`.
SEARCHES = ("ghost", "rows", "corrections")

# The 26 lattice combinations (i, j, k) != 0, unpruned: a frame's correction
# candidates are these times its own box columns (zero-cost rows for the
# pruned ones), so a box that changes from frame to frame stays exact.
_IJK = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
                 if (i, j, k) != (0, 0, 0)], dtype=np.float32)


def make_system(n_atoms: int, n_protein: int, box, seed: int = 0):
    """Synthetic solvated-protein-like system (``bench.py:make_system``,
    generalised to any box): "water" uniform in the box's fractional
    coordinates, and a uniform-density ball of "protein" atoms (indices
    ``0..n_protein-1``) at the box centre, at the box's mean density
    n_atoms / V. ``box`` is a (3, 3) matrix whose columns are the box
    vectors. Returns (coords (n, 3) f32, masses (n,) f32)."""
    m = np.asarray(box, dtype=np.float64)
    rng = np.random.default_rng(seed)
    water = (rng.uniform(0, 1, (n_atoms - n_protein, 3)) @ m.T).astype(np.float32)
    density = n_atoms / abs(np.linalg.det(m))
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    protein = (m @ np.full(3, 0.5) + d * r).astype(np.float32)
    coords = np.concatenate([protein, water])
    masses = rng.uniform(1.0, 16.0, n_atoms).astype(np.float32)
    return coords, masses


# Residues the protein rows of :func:`label_topology` cycle through.
_PROTEIN_RESIDUES = (
    ("ALA", ("N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O")),
    ("GLY", ("N", "H", "CA", "HA1", "HA2", "C", "O")),
    ("SER", ("N", "H", "CA", "HA", "CB", "HB1", "HB2", "OG", "HG", "C", "O")),
)


# The fewest ions :func:`label_topology` adds (more fill what waters leave).
_MIN_IONS = 10


def label_topology(n_atoms: int, n_protein: int):
    """A topology for :func:`make_system`'s rows: the first ``n_protein``
    as protein residues (ALA, GLY, SER in turn, with their atom names; the
    last one cut where the rows end), then SOL waters (OW, HW1, HW2), then
    at least ten ions (NA and CL in turn) to fill the rows. Elements
    and masses are guessed from the names, as a structure file's reader
    does -> :class:`~molar_tpu_torch.core.topology.Topology`."""
    from .convert import topology_from_numpy
    from .core import periodic_table as pt

    names, resnames, resid = [], [], []
    r = 0
    while len(names) < n_protein:
        resname, atoms = _PROTEIN_RESIDUES[r % len(_PROTEIN_RESIDUES)]
        r += 1
        take = atoms[: n_protein - len(names)]
        names += take
        resnames += [resname] * len(take)
        resid += [r] * len(take)
    n_ions = _MIN_IONS + (n_atoms - n_protein - _MIN_IONS) % 3
    n_water = (n_atoms - n_protein - n_ions) // 3
    names += ["OW", "HW1", "HW2"] * n_water
    resnames += ["SOL"] * (3 * n_water)
    resid += [r + 1 + k // 3 for k in range(3 * n_water)]
    ions = ["NA", "CL"] * n_ions
    names += ions[:n_ions]
    resnames += ions[:n_ions]
    resid += [r + 1 + n_water + k for k in range(n_ions)]
    chain = ["A"] * n_protein + ["W"] * (3 * n_water) + ["I"] * n_ions
    guess = {key: pt.guess_element_from_name(*key) for key in set(zip(names, resnames))}
    z = np.array([guess[key] for key in zip(names, resnames)])
    resid = np.asarray(resid)
    n = len(names)
    return topology_from_numpy(names, resnames, resid, resid - 1, chain, pt.ELEMENT_MASSES[z],
                               np.zeros(n), np.ones(n), np.zeros(n), z)


def write_trajectory(path: str, coords0, box_matrix, n_frames: int, sigma: float = 0.02,
                     seed: int = 1) -> None:
    """Random-walk trajectory from ``coords0`` (``bench.py:make_trajectory``)."""
    rng = np.random.default_rng(seed)
    c = coords0.copy()
    with XtcHandler(path, "w") as w:
        for k in range(n_frames):
            c = c + rng.normal(0, sigma, c.shape).astype(np.float32)
            w.write_raw(c, box_matrix, step=k, time=float(k))


def base_caps(xtc_path: str, inv, dims, protein_idx) -> tuple[int, int, int]:
    """Frame-0 exact occupancies (source cap, target cap, occupied target
    cells) that size tier 0. Drift beyond the tier margins is absorbed by
    the overflow retry."""
    with XtcHandler(xtc_path) as h:
        c0 = h.read_frame(0).coords
    return estimate_caps(c0, inv, dims, protein_idx, margin=1.0, round_to=1)


def caps_for(cap0: int, tcap0: int, cells0: int, tier: int) -> tuple[int, int, int]:
    """Capacity tier ``tier`` (``bench.py:caps_for``): the caps get a x1.2
    margin, x1.5 per tier, +2 slots, rounded up to a multiple of 8; the
    occupied-target-cell slots a x1.25 margin, x1.5 per tier, rounded up to
    a multiple of 256, at least 512. Held against the headline's own data
    on an NVIDIA H100's host (``chip_smoke.py``, the ``headline_caps``
    line): over its 256-frame walk the fullest frame needs 1.21 / 1.13 /
    1.42 times frame 0's counts, and tier 0 holds it (46 of 48, 26 of 32,
    742 of 768); what drifts further goes to the retry."""
    g = 1.5**tier
    cap = (int(cap0 * 1.2 * g) + 2 + 7) // 8 * 8
    tcap = (int(tcap0 * 1.2 * g) + 2 + 7) // 8 * 8
    cells = max(512, (int(cells0 * 1.25 * g) + 255) // 256 * 256)
    return cap, tcap, cells


class FitWithinWindow(nn.Module):
    """Per-frame RMSD fit + within search over one decoded window.

    Buffers: ``ref`` (n_sel, 3), ``masses`` (n_sel,), ``protein_idx``
    (n_sel,) int64, and for the correction route ``ijk`` (26, 3), the
    lattice combinations. Static: ``cutoff``, ``dims``, ``cap``,
    ``tgt_cap``, ``search`` (one of :data:`SEARCHES`) and, for the
    correction route, ``max_tgt_cells`` (its sparse-target slots).
    """

    def __init__(self, ref, masses, protein_idx, cutoff: float, dims, cap: int, tgt_cap: int,
                 search: str = "ghost", max_tgt_cells: int = 512):
        super().__init__()
        if search not in SEARCHES:
            raise ValueError(f"search must be one of {SEARCHES}, got {search!r}")
        self.register_buffer("ref", ref)
        self.register_buffer("masses", masses)
        self.register_buffer("protein_idx", protein_idx)
        if search == "corrections":
            self.register_buffer("ijk", torch.from_numpy(_IJK))
        self.cutoff = cutoff
        self.dims = tuple(dims)
        self.cap = cap
        self.tgt_cap = tgt_cap
        self.search = search
        self.max_tgt_cells = max_tgt_cells

    def frame_corrections(self, boxes):
        """(B, 26, 3) correction candidates of each frame's box: ``i*a + j*b
        + k*c`` for the 26 combinations, elementwise (the JAX package's
        ``selection/compiled.py`` form)."""
        ijk = self.ijk[None]
        return (ijk[:, :, 0:1] * boxes[:, None, :, 0] + ijk[:, :, 1:2] * boxes[:, None, :, 1]
                + ijk[:, :, 2:3] * boxes[:, None, :, 2])

    @torch.no_grad()
    def masks(self, coords, boxes, invs):
        """Per-frame within masks of decoded ``coords`` (B, N, 3) against
        the selection -> (masks (B, N) bool, overflow (B,) bool). The ghost
        and row routes search the whole window in one call (two kernel
        launches); the correction route goes frame by frame."""
        if self.search != "corrections":
            window = within_mask_window if self.search == "ghost" else within_mask_rows_window
            return window(coords, None, self.protein_idx, self.cutoff, boxes, invs, self.dims,
                          cap=self.cap, tgt_cap=self.tgt_cap)
        corr = self.frame_corrections(boxes)
        masks, overflows = [], []
        for b in range(coords.shape[0]):
            mask, ofl = within_mask(coords[b], None, self.protein_idx, self.cutoff, boxes[b],
                                    invs[b], corrections=corr[b], dims=self.dims, cap=self.cap,
                                    tgt_cap=self.tgt_cap, max_tgt_cells=self.max_tgt_cells)
            masks.append(mask)
            overflows.append(ofl)
        return torch.stack(masks), torch.stack(overflows)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        """-> per frame (rmsd f32, count i64, checksum i64 in [0, 2^32),
        overflow bool), each of shape (B,)."""
        coords = decode_window_coords(transport)
        rmsd, _, _ = fit_rmsd(coords[:, self.protein_idx], self.ref, self.masses)
        masks, overflows = self.masks(coords, boxes, invs)
        ids1 = torch.arange(1, coords.shape[1] + 1, device=coords.device)
        # torch has no uint32 sum: int64 sum, then wrap to 32 bits.
        checks = (ids1 * masks).sum(dim=1) & 0xFFFFFFFF
        return rmsd, masks.sum(dim=1), checks, overflows


def run(xtc_path, ref, masses, protein_idx, box, cutoff, dims, caps0, window, device,
        search: str = "ghost", mesh=None):
    """Stream ``xtc_path`` in windows of the shipped wire form
    (:data:`~molar_tpu_torch.tasks.trajectory.WIRE`) through
    :class:`FitWithinWindow`, retrying overflowed windows over four capacity
    tiers (``bench.py``'s settings). ``box`` is the host
    :class:`~molar_tpu_torch.core.pbc.PeriodicBox` that picks the route
    with ``search`` (:func:`convert.from_numpy`); ``dims`` =
    :func:`~molar_tpu_torch.ops.neighbor.grid_dims_for`; ``caps0`` =
    :func:`base_caps`. ``mesh`` (a list of devices or a
    :class:`~molar_tpu_torch.parallel.mesh.MeshWindowRunner`) shards each
    window's frames over its devices (``bench.py --mesh``); ``device`` is
    then its first. Returns (frame ids, rmsd, count, checksum) numpy
    arrays in stream order, and the retried window count."""

    def build(tier):
        return convert.from_numpy(
            ref, masses, protein_idx, box.matrix, cutoff, caps_for(*caps0, tier), dims, device,
            search=search,
        )

    results, retried = run_with_overflow_retry(
        TrajectoryReader([xtc_path]), window, build, device,
        overflow_of=lambda r: r[3], n_tiers=4, quantized=trajectory.WIRE, mesh=mesh,
    )
    ids = np.concatenate([np.asarray(i) for i, _ in results])
    rmsd, count, check = (
        torch.cat([r[k] for _, r in results]).cpu().numpy() for k in range(3)
    )
    return ids, rmsd, count, check, retried
