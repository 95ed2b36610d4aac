"""The workloads on torch: CA-RMSD, per-residue COM and gyration,
protein-ligand contact lists, the three fused into one window program, the
per-residue exact Lee-Richards SASA time series, and the membrane analysis
of a synthetic bilayer.

The port of ``benchmarks/workloads.py``'s ``wl_ca_rmsd``, ``wl_com_splits``,
``wl_contacts``, ``wl_fused`` and ``wl_sasa``: a solvated protein whose
trajectory streams from an XTC file in windows (``tasks.trajectory.WIRE``) that carry
only the selection's atom rows (``TrajectoryReader`` -> ``WindowPipeline`` -> one ``nn.Module`` a
workload), each reduced to the check scalar that the single-core C++
program ``benchmarks/native_workloads.cpp`` prints for the same file, so
every run can be held against an independent implementation.

The synthetic system is laid out deterministically, so its selections are
index arithmetic and need no selection language: protein atoms
``0..n_protein-1`` named N, CA, C, O in turn (mass 12, a residue every 4
atoms), then water OW, HW1, HW2 in turn (masses 16, 1, 1); the stand-in
ligand is the first 50 water oxygens.

The membrane workload (``wl_membrane(device=True)``) runs on its own
system, a flat bilayer (:func:`synth_bilayer`), through
``membrane.MembraneDevice``, and is held against
``benchmarks/native_membrane.cpp`` on the same decoded frames.
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
from .io.xtc import XtcHandler
from .membrane import MembraneDevice, MembraneOptions, MembraneSpec, SpeciesTemplate
from .membrane.device import to_numpy
from .ops import sasa_lr
from .ops.measure import dense_segment_com_gyration, dense_segment_sum, fit_rmsd
from .ops.neighbor import DENSE_LIMIT, contact_pairs_dense_window, contact_pairs_window
from .tasks import trajectory
from .tasks.trajectory import (
    AnalysisError, TrajectoryReader, WindowPipeline, auto_window, decode_window_coords,
    run_with_overflow_retry,
)

#: The workloads :func:`run` knows, and the name the native program gives each.
WORKLOADS = {"ca_rmsd": "ca_rmsd", "com_splits": "com_gyr", "contacts": "contacts",
             "fused": "fused", "sasa": "sasa", "membrane": "membrane"}

CUTOFF = 0.4          # nm, the contact distance
MAX_PAIRS = 1 << 14   # pair-list capacity a frame
GRID_CAP = 64         # targets a cell, when the cell grid is used
N_LIGAND = 50
SASA_SLICES = 32      # z-slices an atom of the SASA workload (and of the sidecar)
SASA_TIERS = 3        # capacity tiers of the SASA workload's lists
SASA_WINDOW = 16      # frames a window of the SASA stream when none is asked for
#: van der Waals radius of carbon in nm as ``molar_tpu``'s ``Topology.vdw()``
#: gives it: 1.7 A (``molar_tpu/core/periodic_table.py:68``) times 0.1 in
#: float32 (``:94``); the sidecar's radii are this plus the 0.14 nm probe.
CARBON_VDW_NM = np.float32(0.17)
PROBE_NM = 0.14
#: Relative tolerance of a check scalar against the native program's: both
#: decode the same float32 frames; summation order and float64 arithmetic
#: differ (``benchmarks/workloads.py``'s ``CHECK_RTOL``).
CHECK_RTOL = 2e-3
#: The membrane check scalars against the native program's, label ->
#: (rtol, atol) (``benchmarks/workloads.py``'s ``MEMBRANE_TOL``): curvature
#: is ~0 on a flat bilayer, so its bound is led by atol.
MEMBRANE_TOL = {
    "check_area": (1e-2, 0.0),
    "check_mean": (5e-2, 5e-4),
    "check_order": (5e-2, 2e-3),
}
#: Frames a window of the membrane stream when none is asked for. From a
#: sweep on an NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py``), medians of
#: 3 passes at 4 / 8 / 16 / 32 / 64 frames: 72 lipids 193 / 342 / 713 / 858
#: / 1,376 fps (a window costs ~15 ms of host enqueue whatever its length),
#: 4,608 lipids 86 / 95 / 100 / 104 fps (to 32, the file's length).
MEMBRANE_WINDOW = 64


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
    def pairs(self, coords, boxes, invs, plain: bool = False):
        """Decoded ``coords`` (B, n, 3) -> (pairs (B, max_pairs, 2) row
        numbers, distances, count, overflow). ``plain`` runs the grid form
        frame by frame (its plain version)."""
        if self.dense:
            return contact_pairs_dense_window(coords, self.src, self.tgt, self.cutoff, boxes, invs,
                                              max_pairs=self.max_pairs)
        return contact_pairs_window(coords, self.src, self.tgt, self.cutoff, boxes, invs,
                                    dims=self.dims, cap=self.cap, max_pairs=self.max_pairs,
                                    plain=plain)

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


def sasa_radii(n: int) -> np.ndarray:
    """The SASA workload's radii, vdW + probe, in float64 as
    ``benchmarks/workloads.py``'s ``wl_sasa`` forms them (every protein
    atom of the synthetic system is a carbon)."""
    return np.full(n, CARBON_VDW_NM, np.float32).astype(np.float64) + PROBE_NM


def sasa_caps(k0: int, cell0: int, tier: int) -> tuple[int, int]:
    """``(k_cap, cell_cap)`` of capacity tier ``tier`` from the frame-0
    exact counts (``wl_sasa``'s ``build_fn``): a x1.25 margin, x1.5 a tier,
    rounded up to a multiple of 16 and of 8."""
    g = 1.5**tier
    return (int(k0 * 1.25 * g) + 15) // 16 * 16, (int(cell0 * 1.25 * g) + 7) // 8 * 8


class Sasa(nn.Module):
    """Exact Lee-Richards SASA of every residue of every frame: the lists
    are rebuilt on the device for every frame (no skin, no drift check),
    the per-atom areas summed over each residue in the dense segment
    layout. The window ships the protein rows only. Buffers: ``radii``
    (n,), ``idx`` (Lmax * nseg,) and ``w`` (Lmax, nseg) of the residues.
    Static: ``extents`` (the box diagonal; a non-periodic grid), ``dims``,
    the frame-0 counts ``k0`` / ``cell0`` and the ``tier`` that sizes the
    caps (:func:`sasa_caps`). -> (areas (B, nseg), overflow (B,)); where
    ``overflow`` is set the frame's areas are undefined."""

    def __init__(self, radii, idx, w, extents, dims, k0: int, cell0: int,
                 n_slices: int = SASA_SLICES, tier: int = 0):
        super().__init__()
        self.register_buffer("radii", radii)
        self.register_buffer("idx", idx)
        self.register_buffer("w", w)
        self.extents = tuple(float(e) for e in extents)
        self.dims = tuple(dims)
        self.k0, self.cell0 = k0, cell0
        self.n_slices = n_slices
        self.tier = tier
        self.k_cap, self.cell_cap = sasa_caps(k0, cell0, tier)

    def at_tier(self, tier: int) -> "Sasa":
        """The same workload at capacity tier ``tier`` (the buffers shared)."""
        return Sasa(self.radii, self.idx, self.w, self.extents, self.dims, self.k0, self.cell0,
                    self.n_slices, tier)

    @torch.no_grad()
    def forward(self, transport, boxes, invs):
        with _stage("decode"):
            coords = decode_window_coords(transport)
        with _stage("lists"):
            nbr, overflow = sasa_lr.neighbor_lists_device(
                coords, self.radii, self.extents, self.dims, self.cell_cap, self.k_cap)
        with _stage("sasa"):
            areas = sasa_lr.sasa(coords, self.radii, nbr, n_slices=self.n_slices)
        with _stage("residues"):
            return dense_segment_sum(areas, self.idx, self.w), overflow


def _membrane_checks(spec, outs) -> dict:
    """``check_area`` / ``check_mean`` / ``check_order`` of a membrane
    stream's window outputs (numpy): means over frames x valid lipids, as
    ``native_membrane.cpp`` prints them. Raises when no lipid is valid in
    the whole stream (an empty accumulation would time nothing)."""
    n_valid = 0
    a_sum = m_sum = o_sum = 0.0
    o_n = 0
    for o in outs:
        v = np.asarray(o["valid"], bool)  # (B, L)
        n_valid += int(v.sum())
        a_sum += float(np.asarray(o["area"])[v].sum())
        m_sum += float(np.asarray(o["mean_curv"])[v].sum())
        for sp in spec.species_names:
            vsp = v[:, spec.sp_lipids[sp]]  # (B, n_sp)
            for t in o["order"][sp]:
                t = np.asarray(t)
                o_sum += float(np.where(vsp[..., None], t, 0.0).sum())
                o_n += int(vsp.sum()) * t.shape[-1]
    if n_valid == 0:
        raise AnalysisError(
            "membrane workload: ZERO valid lipids across the whole stream — "
            "trivially empty accumulation; the fps would measure nothing"
        )
    return {"check_area": a_sum / n_valid, "check_mean": m_sum / n_valid,
            "check_order": (o_sum / o_n) if o_n else 0.0}


def _checks(name: str, outs, spec=None) -> dict:
    """The check scalars of a stream's per-window results, as the native
    program defines them: mean RMSD; mean over frames of the mean
    per-residue gyration; mean contact count; mean total area a frame; the
    membrane's three means (``spec`` its :class:`MembraneSpec`). Raises on
    a pair-list overflow, on a stream without a single contact, on a frame
    without area and on a membrane stream without a valid lipid."""
    if name == "membrane":
        return _membrane_checks(spec, outs)
    cols = [torch.cat(col).cpu().numpy() for col in zip(*outs)]
    if name == "sasa":
        total = cols[0].sum(axis=1)
        if cols[1].any():
            raise AnalysisError("sasa: a frame's lists overflowed: its areas are undefined")
        if not (total > 0).all():
            raise AnalysisError("sasa: a frame without area: broken lists or broken slicing")
        return {"check": float(total.mean())}
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


def run(name: str, system: System, xtc: str, window: int, device, mesh=None):
    """Stream ``xtc`` through workload ``name`` on ``device`` in windows of
    ``window`` frames (0: :func:`auto_window` sizes it from the subset;
    :data:`SASA_WINDOW` for ``sasa``, whose pace the device sets) that
    carry only the workload's rows; one synchronize, at the end. A
    ``sasa`` window whose lists overflow is run again at the next of
    :data:`SASA_TIERS` capacity tiers, and the last tier's overflow
    raises. ``mesh`` (a list of devices, ``benchmarks/workloads.py
    --mesh``) shards each window's frames over its devices, and runs the
    membrane as one :class:`MembraneDevice` a device over contiguous
    slices of frames, merged (:func:`run_membrane_shards`); ``device`` is
    then ignored. Returns (frames, seconds of the stream, check
    scalars)."""
    if mesh is not None:
        device = torch.device(list(mesh)[0])
    if name == "membrane":
        devs = [MembraneDevice(system.spec, system.coords, system.box, device=d)
                for d in (mesh or [device])]
        if mesh is not None:
            return run_membrane_shards(devs, xtc, window)
        return run_membrane(devs[0], xtc, window)
    model, subset = convert.workload_from_numpy(name, system, device)
    reader = TrajectoryReader([xtc])
    frames, outs = 0, []
    t0 = time.perf_counter()
    if name == "sasa":
        results, _ = run_with_overflow_retry(
            reader, window or SASA_WINDOW, model.at_tier, device, overflow_of=lambda r: r[1],
            n_tiers=SASA_TIERS, quantized=trajectory.WIRE, subset=subset, mesh=mesh)
    else:
        results = WindowPipeline(reader, auto_window(xtc, subset, requested=window), model,
                                 device, quantized=trajectory.WIRE, subset=subset,
                                 mesh=mesh).run()
    for ids, res in results:
        outs.append(res)
        frames += len(ids)
    for d in mesh or [device]:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)
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


# ---------------------------------------------------------------- membrane


@dataclasses.dataclass(frozen=True)
class Bilayer:
    """A flat bilayer as numpy arrays: ``coords`` (n, 3) f32, ``box`` (3,
    3) f32, and the membrane's static structure ``spec``."""

    coords: np.ndarray
    box: np.ndarray
    spec: MembraneSpec

    def frames(self, n_frames: int) -> np.ndarray:
        """``n_frames`` frames, each the coordinates plus its own 0.01 nm
        noise from ``default_rng(0)`` (``wl_membrane``'s draws)."""
        rng = np.random.default_rng(0)
        return np.stack([self.coords + rng.normal(0, 0.01, self.coords.shape).astype(np.float32)
                         for _ in range(n_frames)])


def synth_bilayer(nx: int = 6, ny: int = 6) -> Bilayer:
    """``benchmarks/workloads.py``'s ``wl_membrane`` system: two leaflets
    of ``nx`` x ``ny`` lipids 0.8 nm apart, head planes 3.0 nm apart, each
    lipid the atoms P, G, C1-C4 of mass 12 along z, box ``(0.8 nx, 0.8 ny,
    6)``; options cutoff 2.0 nm, ``scdcorr``, one group "all", head "name
    P", mid "name G", the tail C1-C2-C3-C4."""
    spacing, z_mid = 0.8, 3.0
    coords = []
    for zdir in (1.0, -1.0):
        for i in range(nx):
            for j in range(ny):
                x, y = i * spacing, j * spacing
                for k in range(6):
                    coords.append([x, y, z_mid + zdir * (1.5 - 0.3 * k)])
    coords = np.asarray(coords, np.float32)
    box = np.diag([nx * spacing, ny * spacing, 6.0]).astype(np.float32)
    options = MembraneOptions(cutoff=2.0, order_type="scdcorr", groups=["all"], lipids={
        "LIP": {"whole": "resname LIP", "head": "name P", "mid": "name G",
                "tails": ["C1-C2-C3-C4"]}})
    n_lipids = 2 * nx * ny
    spec = MembraneSpec.from_templates(
        {"LIP": SpeciesTemplate(head=(0,), mid=(1,), tails=(((2, 3, 4, 5), (1, 1, 1)),))},
        [("LIP", 6 * i, 6) for i in range(n_lipids)],
        np.full(len(coords), 12.0, np.float32), box, options,
        groups={"all": list(range(n_lipids))})
    return Bilayer(coords, box, spec)


def write_membrane_xtc(bilayer: Bilayer, path: str, n_frames: int) -> None:
    """The bilayer's :meth:`Bilayer.frames` as an XTC file."""
    with XtcHandler(path, "w") as w:
        for k, frame in enumerate(bilayer.frames(n_frames)):
            w.write_raw(frame, bilayer.box, step=k, time=float(k))


class _BoxChecked:
    """``reader``'s windows, each window's boxes passed to ``check`` first,
    on the decode thread (an error reaches the consumer as that window)."""

    def __init__(self, reader, check):
        self.reader = reader
        self.check = check
        self.timings = reader.timings

    def iter_windows(self, *args, **kwargs):
        for window in self.reader.iter_windows(*args, **kwargs):
            self.check(window[1])
            yield window


def stream_membrane(dev: MembraneDevice, reader, window: int):
    """``reader``'s windows of ``dev``'s rows through ``dev``, each folded
    into its group statistics before the next is read -> (frames, the
    windows' outputs as numpy)."""
    dev.resolve_engine(window)
    pipe = WindowPipeline(_BoxChecked(reader, dev.check_boxes), window, dev.window_fn,
                          dev.device, quantized=trajectory.WIRE, subset=dev.subset)
    frames, outs = 0, []
    for ids, res in pipe.run():
        res = to_numpy(res)
        dev.accumulate(res)
        outs.append(res)
        frames += len(ids)
    return frames, outs


def last_frame_geometry(membrane, reader) -> None:
    """``reader``'s last frame through the host pipeline's geometry
    (``Membrane.compute_geometry``, folded into no group): after a card run
    ``membrane.write_vmd_visualization`` then draws what the host route's
    last frame draws. The frames are decoded again on the host."""
    last = None
    for _, last in reader.iter_states():
        pass
    if last is not None:
        membrane.system.set_state(last)
        membrane.compute_geometry()


def run_membrane(dev: MembraneDevice, xtc: str, window: int = 0):
    """The membrane workload through ``dev``: ``xtc``'s windows of
    ``window`` frames (:data:`MEMBRANE_WINDOW` when 0) of the spec's rows;
    each window's outputs come back to the host and are folded into
    ``dev``'s group statistics before the next is read. -> (frames,
    seconds, check scalars)."""
    t0 = time.perf_counter()
    frames, outs = stream_membrane(dev, TrajectoryReader([xtc]), window or MEMBRANE_WINDOW)
    return frames, time.perf_counter() - t0, _checks("membrane", outs, dev.spec)


def run_membrane_shards(devs, xtc: str, window: int = 0):
    """The membrane workload's frame-sharded shape (``wl_membrane(shards=)``):
    ``xtc``'s frames in ``len(devs)`` contiguous slices, slice k streamed
    through ``devs[k]`` (a :class:`MembraneDevice` each, on its own device
    or all on one), then every device's group statistics folded into
    ``devs[0]``'s (:meth:`MembraneDevice.merge_stats_from`). -> (frames,
    seconds, check scalars of every slice's outputs)."""
    with XtcHandler(xtc) as h:
        per = -(-h.n_frames // len(devs))
    t0 = time.perf_counter()
    frames, outs = 0, []
    for k, dev in enumerate(devs):
        reader = TrajectoryReader([xtc], begin=k * per, end=(k + 1) * per - 1)
        n, o = stream_membrane(dev, reader, window or MEMBRANE_WINDOW)
        frames += n
        outs += o
    for dev in devs[1:]:
        devs[0].merge_stats_from(dev)
    return frames, time.perf_counter() - t0, _checks("membrane", outs, devs[0].spec)


def write_membrane_native(spec: MembraneSpec, box, frames, path: str) -> None:
    """The sidecar ``benchmarks/native_membrane.cpp`` reads: the static
    structure of a single-species membrane, its options, the box diagonal
    and ``frames`` (full-system coordinates, the spec's rows taken here),
    byte for byte as ``benchmarks/workloads.py``'s
    ``_write_membrane_native``."""
    sp = spec.species_names[0]
    tl, orders = spec.sp_tails[sp][0]
    with open(path, "wb") as f:
        def i32(v):
            f.write(struct.pack("<i", int(v)))

        def ivec(a):
            a = np.ascontiguousarray(a, np.int32)
            i32(a.size)
            f.write(a.tobytes())

        i32(0x4D454D42)
        i32(len(spec.subset))
        i32(spec.n_lipids)
        i32(len(frames))
        ivec(spec.first)
        ivec(spec.atom_first)
        f.write(np.ascontiguousarray(spec.masses, np.float32).tobytes())
        for idx, seg in (spec.head, spec.mid, spec.tail):
            ivec(idx)
            ivec(seg)
        i32(tl.shape[1])
        ivec(tl)
        ivec(np.asarray(orders))
        opt = spec.options
        diag = np.diag(np.asarray(box))
        code = {"sz": 0, "scd": 1, "scdcorr": 2}[opt.order_type]
        f.write(np.asarray([opt.cutoff, diag[0], diag[1], diag[2], opt.max_smooth_iter,
                            opt.n_shells_smoothing, code], np.float32).tobytes())
        w = np.stack([c[spec.subset] for c in frames]).astype(np.float32)
        f.write(np.ascontiguousarray(w).tobytes())


def run_native_membrane(spec: MembraneSpec, box, frames, workdir: str) -> dict:
    """``benchmarks/native_membrane.cpp`` on ``frames`` (its sidecar written
    into ``workdir``) -> its JSON record (``fps``, ``check_area``,
    ``check_mean``, ``check_order``). Run it after the device passes."""
    exe = build.build_native_membrane()
    path = os.path.join(workdir, "membrane.bin")
    write_membrane_native(spec, box, frames, path)
    out = subprocess.run([str(exe), path], check=True, capture_output=True, text=True,
                         timeout=1800).stdout
    return json.loads(out.splitlines()[-1])


def membrane_mismatches(checks: dict, native: dict) -> list[str]:
    """The membrane check scalars outside :data:`MEMBRANE_TOL` of the
    native program's, as ``"key: got vs want"`` strings."""
    return [f"{k}: {checks[k]} vs {native[k]}" for k, (rtol, atol) in MEMBRANE_TOL.items()
            if abs(checks[k] - native[k]) > atol + rtol * abs(native[k])]
