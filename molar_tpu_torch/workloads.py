"""The selection workloads on torch: CA-RMSD, per-residue COM and gyration,
protein-ligand contact lists, and the three fused into one window program.

The port of ``benchmarks/workloads.py``'s ``wl_ca_rmsd``, ``wl_com_splits``,
``wl_contacts`` and ``wl_fused``: a solvated protein whose trajectory streams
from an XTC file in i8-delta windows that carry only the selection's atom
rows (``TrajectoryReader`` -> ``WindowPipeline`` -> one ``nn.Module`` a
workload), each reduced to the check scalar that the single-core C++
program ``benchmarks/native_workloads.cpp`` prints for the same file, so
every run can be held against an independent implementation.

The synthetic system is laid out deterministically, so its selections are
index arithmetic and need no selection language: protein atoms
``0..n_protein-1`` named N, CA, C, O in turn (mass 12, a residue every 4
atoms), then water OW, HW1, HW2 in turn (masses 16, 1, 1); the stand-in
ligand is the first 50 water oxygens.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import time

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from . import build, convert, headline
from .ops.measure import dense_segment_com_gyration, fit_rmsd
from .ops.neighbor import contact_pairs_dense_window, contact_pairs_window
from .tasks.trajectory import (
    AnalysisError, TrajectoryReader, WindowPipeline, auto_window, decode_window_coords,
)

#: The workloads :func:`run` knows, and the name the native program gives each.
WORKLOADS = {"ca_rmsd": "ca_rmsd", "com_splits": "com_gyr", "contacts": "contacts",
             "fused": "fused"}

CUTOFF = 0.4          # nm, the contact distance
MAX_PAIRS = 1 << 14   # pair-list capacity a frame
GRID_CAP = 64         # targets a cell, when the cell grid is used
DENSE_LIMIT = 1 << 21  # n_src * n_tgt up to which the dense matrix is used
N_LIGAND = 50
SASA_SLICES = 32      # written into the sidecar; the SASA workload is not ported
#: van der Waals radius of carbon in nm as ``molar_tpu``'s ``Topology.vdw()``
#: gives it: 1.7 A (``molar_tpu/core/periodic_table.py:68``) times 0.1 in
#: float32 (``:94``); the sidecar's radii are this plus the 0.14 nm probe.
CARBON_VDW_NM = np.float32(0.17)
PROBE_NM = 0.14
#: Relative tolerance of a check scalar against the native program's: both
#: decode the same float32 frames; summation order and float64 arithmetic
#: differ (``benchmarks/workloads.py``'s ``CHECK_RTOL``).
CHECK_RTOL = 2e-3


@dataclasses.dataclass(frozen=True)
class System:
    """A system as numpy arrays: ``coords`` (n, 3) f32, ``masses`` (n,) f32,
    ``box`` (3, 3) f32 (columns are the box vectors), and the index sets
    its selections give: ``ca`` ("name CA"), ``protein`` ("resname ALA"),
    ``segment_ids`` (the residue run of each protein atom, from 0), ``ow``
    ("name OW")."""

    coords: np.ndarray
    masses: np.ndarray
    box: np.ndarray
    ca: np.ndarray
    protein: np.ndarray
    segment_ids: np.ndarray
    ow: np.ndarray

    @property
    def n_atoms(self) -> int:
        return len(self.coords)

    @property
    def ligand(self) -> np.ndarray:
        return self.ow[:N_LIGAND]


def synth_system(n_atoms: int, n_protein: int, box_side: float = 8.0, seed: int = 0) -> System:
    """The synthetic solvated protein of ``benchmarks/workloads.py``
    (``_synth_system``), same draws in the same order: a uniform ball of
    protein atoms at the box centre at the system's mean density, water
    uniform in a cubic box of ``box_side`` nm."""
    rng = np.random.default_rng(seed)
    density = n_atoms / box_side**3
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    protein = (box_side / 2 + d * r).astype(np.float32)
    water = rng.uniform(0, box_side, (n_atoms - n_protein, 3)).astype(np.float32)
    water_mass = np.where(np.arange(n_atoms - n_protein) % 3 == 0, 16.0, 1.0)
    return System(
        coords=np.concatenate([protein, water]),
        masses=np.concatenate([np.full(n_protein, 12.0), water_mass]).astype(np.float32),
        box=np.diag([box_side] * 3).astype(np.float32),
        ca=np.arange(1, n_protein, 4),
        protein=np.arange(n_protein),
        segment_ids=(np.arange(n_protein) // 4).astype(np.int32),
        ow=np.arange(n_protein, n_atoms, 3),
    )


def write_xtc(system: System, path: str, n_frames: int) -> None:
    """A 0.01 nm random walk from the system's coordinates, seed 1
    (``benchmarks/workloads.py``'s ``_write_xtc``)."""
    headline.write_trajectory(path, system.coords, system.box, n_frames, sigma=0.01, seed=1)


def _stage(name: str):
    """A named range on the profiler's timeline (free when none records)."""
    return record_function(f"stage:{name}")


class CaRmsd(nn.Module):
    """RMSD of each frame's CA atoms after the mass-weighted fit onto the
    reference. The window ships the CA rows only. Buffers: ``ref`` (n_ca,
    3), ``masses`` (n_ca,). -> (rmsd (B,),)."""

    def __init__(self, ref, masses):
        super().__init__()
        self.register_buffer("ref", ref)
        self.register_buffer("masses", masses)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        with _stage("decode"):
            coords = decode_window_coords(transport)
        with _stage("fit_rmsd"):
            return (fit_rmsd(coords, self.ref, self.masses)[0],)


class ComSplits(nn.Module):
    """Centre of mass and radius of gyration of every residue of every
    frame, in the dense segment layout. Buffers: ``idx`` (Lmax * nseg,)
    gather indices into the window's rows, ``w`` (Lmax, nseg) masses.
    -> (com (B, nseg, 3), gyr (B, nseg))."""

    def __init__(self, idx, w):
        super().__init__()
        self.register_buffer("idx", idx)
        self.register_buffer("w", w)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        with _stage("decode"):
            coords = decode_window_coords(transport)
        with _stage("com_gyration"):
            return dense_segment_com_gyration(coords, self.idx, self.w)


class Contacts(nn.Module):
    """The protein-ligand contact list of every frame. Buffers: ``src`` and
    ``tgt``, row numbers within the window's rows. The direct distance
    matrix when ``n_src * n_tgt <= DENSE_LIMIT``, else the cell grid with
    ``dims``. -> (count (B,), overflow (B,)); :meth:`pairs` gives the lists."""

    def __init__(self, src, tgt, dims, cutoff: float, max_pairs: int, cap: int):
        super().__init__()
        self.register_buffer("src", src)
        self.register_buffer("tgt", tgt)
        self.dims = tuple(dims)
        self.cutoff = cutoff
        self.max_pairs = max_pairs
        self.cap = cap
        self.dense = src.shape[0] * tgt.shape[0] <= DENSE_LIMIT

    @torch.no_grad()
    def pairs(self, coords, boxes, invs):
        """Decoded ``coords`` (B, n, 3) -> (pairs (B, max_pairs, 2) row
        numbers, distances, count, overflow)."""
        if self.dense:
            return contact_pairs_dense_window(coords, self.src, self.tgt, self.cutoff, boxes, invs,
                                              max_pairs=self.max_pairs)
        return contact_pairs_window(coords, self.src, self.tgt, self.cutoff, boxes, invs,
                                    dims=self.dims, cap=self.cap, max_pairs=self.max_pairs)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        with _stage("decode"):
            coords = decode_window_coords(transport)
        with _stage("contacts"):
            return self.pairs(coords, boxes, invs)[2:]


class Fused(nn.Module):
    """The three workloads over one stream of the union of their rows:
    submodules ``ca_rmsd``, ``com_splits`` and ``contacts`` whose indices
    are row numbers within the union, and ``ca`` (n_ca,), the CA rows.
    ``benchmarks/workloads.py``'s ``wl_fused`` reduces residues with scatter
    sums; this uses the dense segment layout of :class:`ComSplits` (one
    code path, the same numbers to float precision).
    -> (rmsd (B,), gyr (B, nseg), count (B,), overflow (B,))."""

    def __init__(self, ca, ca_rmsd: CaRmsd, com_splits: ComSplits, contacts: Contacts):
        super().__init__()
        self.register_buffer("ca", ca)
        self.ca_rmsd = ca_rmsd
        self.com_splits = com_splits
        self.contacts = contacts

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        with _stage("decode"):
            coords = decode_window_coords(transport)
        with _stage("fit_rmsd"):
            rmsd = fit_rmsd(coords[:, self.ca], self.ca_rmsd.ref, self.ca_rmsd.masses)[0]
        with _stage("com_gyration"):
            gyr = dense_segment_com_gyration(coords, self.com_splits.idx, self.com_splits.w)[1]
        with _stage("contacts"):
            count, overflow = self.contacts.pairs(coords, boxes, invs)[2:]
        return rmsd, gyr, count, overflow


def _checks(name: str, outs) -> dict:
    """The check scalars of a stream's per-window results, as the native
    program defines them: mean RMSD; mean over frames of the mean
    per-residue gyration; mean contact count. Raises on a pair-list
    overflow and on a stream without a single contact."""
    cols = [torch.cat(col).cpu().numpy() for col in zip(*outs)]
    if name == "ca_rmsd":
        return {"check": float(cols[0].mean())}
    if name == "com_splits":
        return {"check": float(cols[1].mean(axis=1).mean())}
    count, overflow = cols[-2:]
    if overflow.any():
        raise AnalysisError(f"{name}: the pair list overflowed its capacity: the result is "
                            "truncated")
    if count.sum() == 0:
        raise AnalysisError(f"{name}: no contact in the whole stream: a broken search or "
                            "broken inputs")
    if name == "contacts":
        return {"check": float(count.mean())}
    return {"check": float(cols[0].mean()), "check_com": float(cols[1].mean(axis=1).mean()),
            "check_contacts": float(count.mean())}


def run(name: str, system: System, xtc: str, window: int, device):
    """Stream ``xtc`` through workload ``name`` on ``device`` in i8-delta
    windows of ``window`` frames (0: :func:`auto_window` sizes it from the
    subset) that carry only the workload's rows; one synchronize, at the
    end. Returns (frames, seconds of the stream, check scalars)."""
    model, subset = convert.workload_from_numpy(name, system, device)
    window = auto_window(xtc, subset, requested=window)
    pipe = WindowPipeline(TrajectoryReader([xtc]), window, model, device, quantized="delta",
                          subset=subset)
    frames, outs = 0, []
    t0 = time.perf_counter()
    for ids, res in pipe.run():
        outs.append(res)
        frames += len(ids)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return frames, seconds, _checks(name, outs)


def write_native_meta(system: System, path: str) -> None:
    """The sidecar ``benchmarks/native_workloads.cpp`` reads beside the XTC
    file: the selections, masses, radii and segments of the workloads
    (``benchmarks/workloads.py``'s ``_write_native_meta``, byte for byte)."""
    radii = np.full(len(system.protein), CARBON_VDW_NM, np.float32) + PROBE_NM
    with open(path, "wb") as f:
        def i32(v):
            f.write(struct.pack("<i", int(v)))

        def arr(a, dt):
            f.write(np.ascontiguousarray(a, dt).tobytes())

        i32(0x4D4F4C41)
        i32(system.n_atoms)
        i32(len(system.ca))
        arr(system.ca, np.int32)
        arr(system.coords[system.ca], np.float32)
        arr(system.masses[system.ca], np.float32)
        i32(len(system.protein))
        arr(system.protein, np.int32)
        arr(system.segment_ids, np.int32)
        i32(int(system.segment_ids[-1]) + 1)
        arr(system.masses[system.protein], np.float32)
        arr(radii, np.float32)
        i32(len(system.ligand))
        arr(system.ligand, np.int32)
        arr(np.diag(system.box), np.float32)
        arr(np.float32(CUTOFF), np.float32)
        i32(SASA_SLICES)


def run_native(name: str, xtc: str, meta: str) -> dict:
    """Workload ``name`` through the single-core C++ program on the same
    file and sidecar -> its JSON record (``fps``, ``check``, ...). Run it
    after the device passes, never beside them: it shares the host's cores
    with the decode thread."""
    exe = build.build_native_workloads()
    out = subprocess.run([str(exe), WORKLOADS[name], xtc, meta, "0", os.devnull], check=True,
                         capture_output=True, text=True, timeout=1800).stdout
    return json.loads(out.splitlines()[-1])


def native_mismatches(checks: dict, native: dict, rtol: float = CHECK_RTOL) -> list[str]:
    """The check scalars that are not within ``rtol`` (relative) of the
    native program's, as ``"key: got vs want"`` strings."""
    return [f"{k}: {v} vs {native[k]}" for k, v in checks.items()
            if abs(v - native[k]) > rtol * abs(native[k])]
