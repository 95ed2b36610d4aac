#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``molar_tpu_torch``) on one NVIDIA GPU.

Drives the trajectory headline through the port's own entry points: a
100k-atom XTC streamed in windows of raw i16 ints, each frame fitted (mass-weighted
Kabsch RMSD of a 5k-atom "protein") and searched (0.5 nm periodic ``within``
of every atom against the protein), through each of the port's three search
routes: the hand-written ghost-slab CUDA kernels (a counting-sort binning of
the window into cells, then a 27-cell stencil, two launches a window) and
the hand-written per-pair min-image CUDA kernel over the same binning (two
launches a window too) on the headline's cubic box, and on a rhombic
dodecahedron of the same density the ghost-slab kernels again and the
triclinic correction path (plain torch), side by side.
Then the four selection workloads (CA-RMSD, per-residue COM and gyration,
protein-ligand contact lists, the three fused) stream a 50,000-atom solvated
protein over windows that carry only their selections' rows, the host side
of the stream is measured part by part, the exact Lee-Richards SASA
workload runs on the same system, the membrane pipeline runs on
``benchmarks/workloads.py``'s two bilayers (72 and 4,608 lipids), a
``WindowAnalysisTask`` counts VMD-like selections a frame on the headline's
trajectory, written with a structure file, espaloma charges a ligand
library and a peptide, trjconv writes the protein rows of the
workloads' file to DCD, through the function and the ``molar-torch`` CLI,
and the README's first lines (``System`` / ``Sel`` from a PDB, their
measures, selections, searches, SASA, DSSP and a per-frame
``AnalysisTask``) run on the headline system through a ``System`` on the
card against one on the CPU, and last the rest of the host half: TRR and
AMBER NetCDF streams, ``molar-torch last``, an SDF through perception, GAFF
and espaloma, a SAS mesh, the host membrane beside
``MembraneDevice(membrane)`` and ``molar-torch membrane`` and ``solvate`` on
both routes, and the examples.
Weights do not exist here but espaloma's, whose model file is in the
repository; the systems, molecules and trajectories are made from seeds.
Phases, one line each on stdout (the workloads a line each):

1. device: the card's name and power limit (``nvidia-smi``), the host's
   core count;
2. build: the CUDA kernels, the XTC codec and the native C++ reference,
   from the sources in this checkout;
3. ghost kernels vs plain: masks and overflow flags against the plain twin
   on the same CUDA tensors (exact equality) on the scenes of
   ``tests/torch_scenes.py`` (random, cutoff ties and their members, tiny
   and collapsed periodic grids, partial PBC, a crowded scene that needs
   chunked staging) and an overflow scene; then a full 64-frame headline
   window: the masks against the twin, the binning kernel's per-cell counts
   against ``torch.bincount`` and its per-cell members (positions and
   coordinates) against the plain plane build, the stencil kernel against
   its twin on the same cell records; each kernel's time, its twin's and its
   bound (bytes or operations, from this window's data);
4. main path: write the trajectory, stream it with overflow retry at the
   window ``auto_window`` picks, count kernel launches, check frame 0
   against the native C++ program and frames 0 / mid / last against the
   plain path run on the CPU, and report fps, the host decode / H2D /
   device split and the device's busy share;
5. stages: one resident window, stage by stage (decode, fit_rmsd, search,
   checksum), host enqueue and device time of each stage and the number of
   device operations, for the ghost route and for the row route;
6. rows kernel vs plain: the per-pair min-image search against its plain
   twin on the same CUDA tensors (exact equality) on the orthorhombic
   full-PBC scenes (a 2-cell axis among them), the tie scenes' members and
   an overflow scene, one frame each; the same scenes and the crowded one
   (chunked staging) as 4-frame windows, each frame in its own box, also
   against the ghost route's masks and, for the stencil kernel alone in its
   tiled and its block-per-cell launch, against its twin on the same cell
   records; then the 64-frame headline window the same way, with the
   kernel's time (both launches), its twin's, the whole call's and the
   bound (from this window's data). Kernel times are one CUDA-graph replay
   of many launches between two events, so that no host time is in them;
7. rows path: the main path's trajectory through ``search="rows"``:
   every frame's count and checksum equal the ghost path's, frames 0 / mid
   / last the CPU run of the row twin, frame 0 the native C++ program, no
   host sync inside a window of either route (as in 8), no sort, running
   maximum or scatter among the device's operations; fps, the device's
   busy share and the kernels' launches;
8. dodecahedron path: 100k atoms (a 5k-atom protein ball) in a rhombic
   dodecahedron at 100 atoms/nm^3, 64 frames in windows of 16 with overflow
   retry through both routes of a skewed box, the ghost-slab kernels (its
   default, two launches a window) and the sparse-target correction path
   (no launch): for each, frames 0 / mid / last against the same route on
   the CPU, no host sync inside a window
   (``torch.cuda.set_sync_debug_mode("error")`` over a window, and the
   window captured into a CUDA graph, whose replay equals the eager run),
   fps and the device's busy share; the two routes' masks equal but for
   sources within 1e-6 relative of the cutoff, and frame 0 of the ghost
   route on a seeded sample of 5,000 atoms against a float64 brute force
   over the lattice images;
9. workloads path: ``benchmarks/workloads.py``'s system at its defaults
   (50,000 atoms, a 4,000-atom protein, an 8 nm box, 0.4 nm contacts) over
   1,024 frames, each of the four workloads through
   ``molar_tpu_torch.workloads.run`` (``TrajectoryReader`` ->
   ``WindowPipeline`` with the subset -> its module) at the window
   ``auto_window`` picks: fps of 3 passes, host enqueue and device ms of a
   window by stage, device operations a frame, the top device operations,
   the device's busy share; the module on the CPU against the card on the
   first, a middle and the last window (RMSD within 1e-5, COM and gyration
   within 1e-5 relative, contact counts and pair lists equal); no host
   sync inside a window (as in 8), which is the test of the pair-list
   compaction (its time beside a ``nonzero_static`` a frame); no pair-list
   overflow and some contacts; then a sweep of the window size on
   ``ca_rmsd`` and ``contacts`` (one line a size), and last the
   single-core C++ program ``benchmarks/native_workloads.cpp`` on the same
   file and sidecar, whose check scalars the card's must match within 2e-3
   relative (it runs after the device passes, never beside them);
10. host stream: what the shipped host-side settings rest on, each
   compared inside this one process: the codec's decode threads (1 to every
   core) on the headline file and on a subset stream; the three wire forms
   (i8 deltas, raw i16, plain f32) in turns, decode alone and both streams
   end to end, the headline's results equal under all three; the host ms
   until a copy out of the pinned staging ring returns, beside ordinary
   memory; the feeder's
   and the consumer's host ms a window by part (``# feeder:`` lines) for
   the headline at 16 and 64 frames and ``ca_rmsd`` at 16 and 512, and
   at 16 also with the window function replayed from a CUDA graph (results
   equal);
   the headline's fps at windows of 16 to 128; the headline's cell
   occupancies over the trajectory against the tier-0 caps frame 0 sizes;
   the queue depth (windows decoded ahead, 1 to 4) on the headline and
   ``ca_rmsd`` at 512, results equal; the power iteration after which
   ``fit_rmsd``'s rotation stops changing, frame by frame, on both files;
11. sasa path: the exact Lee-Richards SASA workload on phase 9's system,
   64 frames (``benchmarks/workloads.py``'s default depth), 4,000 rows x 32
   slices, lists rebuilt on the device every frame: the caps and the tier,
   no overflow at tier 0, per-residue areas of the first and the last
   window against the module on the CPU (2e-5 nm^2), the element budget of
   a block swept, fps of 3 passes through ``workloads.run`` and of one by window
   size, device ms a frame by stage, top device operations, host enqueue,
   busy share, peak memory, no host sync inside a window (as in 8), the
   bound of ``sasa`` from this run's neighbour triples and the share
   reached; then ``native_workloads.cpp sasa`` on the same file and
   sidecar: check within 2e-3;
12. membrane path: ``benchmarks/workloads.py``'s membrane rows through
   ``workloads.run_membrane`` (``MembraneDevice`` on the card, the XTC
   streamed in windows of the bilayer's rows): ``membrane_dev`` (72
   lipids, 64 frames) and ``membrane_large`` (4,608 lipids, 27,648 atoms,
   32 frames): ``patch_cap`` and no overflow, fps of 3 passes, the window
   size swept (and, at 4,608 lipids, the chunk budget), one resident window
   by stage (device ms a frame, top device operations, host enqueue, busy
   share, peak memory), the window function on the CPU against the card on
   the first and the last window within the bars of
   ``tests/torch_scenes.MEMBRANE_BARS``, no host sync in a window (as in 8),
   the bound from this window's patch counts and the share reached; then
   ``benchmarks/native_membrane.cpp`` on the same decoded frames: check
   scalars within ``MEMBRANE_TOL``. Last the engine sweep: one window at
   72 / 288 / 1,152 / 4,608 lipids through ``compute_window`` on torch-CPU
   and on the card, and the floor of ``tasks.engine`` those times give;
13. selection path: the headline's rows labelled as a solvated protein
   (``headline.label_topology``: 5,000 protein atoms with residue and atom
   names, SOL waters, a few ions) and written as ``conf.gro`` with the
   port's GRO writer; a ``WindowAnalysisTask`` run through
   ``run(["-f", conf.gro, traj.xtc])`` at the window ``auto_window`` picks,
   3 passes, counts a frame (and a uint32 checksum) of ``name OW and within
   0.5 pbc of protein``, ``within 0.5 pbc of protein`` (the headline's
   search), ``resname SOL and 2.0 < z < 4.0``, ``within 1.0 pbc of [5.0,
   5.0, 5.0]`` and ``name CA``: the tiers, one ``cell_bins`` and one
   ``within_ghost`` launch a within node a window, the headline search's
   counts and checksums equal the main path's frame for frame, the rest
   equal the host evaluator on frames 0 / mid / last, ``eval_window`` on the
   first window equal the task's, no host sync in a window (as in 8), fps,
   host enqueue and device ms a window by node, top device operations and
   busy share; the host tier (a dynamic ``same``) on 3 frames and its fps;
   the dodecahedron file's first window through the headline search
   (correction route) equal phase 8's correction route's results;
14. espaloma path: the espaloma charge model (its widths fixed by the model
   file) on 1,000 seeded drug-like ligands of 20-80 atoms and on a
   120-residue ALA / GLY / SER / PHE peptide (``tests/torch_molecules.py``):
   ``espaloma_charges`` on the card molecule by molecule, then the same
   call part by part (featurise, H2D, forward, D2H, equilibrate), then the
   numpy walk on the host; e and s within 1e-5 and charges within 1e-4 of
   the numpy walk on every molecule, every total charge within 1e-4 of 0,
   the card against the torch-CPU forward on 20 molecules (1e-5); the
   molecules/s of both, the device ms and operations a molecule; the
   peptide's device ms against its FLOP bound; then the crossover sweep
   (peptides of 1 to 120 residues: the forward on the card against the
   numpy walk, in this process and with one BLAS thread in a fresh one);
15. trjconv path: phase 9's file (50,000 atoms, 1,024 frames) through
   ``io.trjconv.trjconv`` with the protein rows (``resname ALA``, the
   prefix decode and the contiguous slice), best of 3, its DCD within 1e-6
   nm of ``native_workloads.cpp trjconv``'s; then ``molar-torch info``
   (it must name the card; its lines printed) and ``molar-torch trjconv``
   on a GRO of the same system with ``--select "resname ALA"``, whose DCD
   must equal the function's byte for byte;
16. 1M path (run after 5): ``bench.py``'s 1,000,000-atom point (a
   20,000-atom protein, a 21.544 nm box, 32 frames) through
   ``headline.run`` at windows of 1, 2, 4, 8 and 16 frames (fps and the
   decode alone), the cap tiers against every frame of its file, frames 0
   / mid / last against the CPU and frame 0 against three runs of the
   native program (best and median), one window by stage, and both ghost
   kernels on that window against their twins, timed, with their bounds;
17. grid contacts (run after 9): ``workloads.Contacts`` above
   ``DENSE_LIMIT`` on phase 9's file (the 4,000 protein rows against the
   first 1,000 water oxygens), the window at once against its frame loop
   on the card (equal) and the CPU (pair sets of 32 frames), device and
   enqueue ms and device operations a window, no host sync, fps; the
   triclinic dense form on the dodecahedron's file, timed, against the CPU;
18. mesh (run after 13): the headline window (64 and 63 frames) through a
   ``MeshWindowRunner`` of ``frame_mesh()`` and of two shards on this
   card, equal to the unsharded window; the stream through
   ``headline.run(mesh=)`` equal to the main path; a ``WindowAnalysisTask``
   with ``--mesh 2`` equal to one without; the runner's host ms a window;
19. user API: the README's first lines on the headline system, through
   the user API on a ``System`` on the card (``device`` None) held against a
   ``System(..., device="cpu")`` of the same file (the host's numpy
   functions). Its first frame written as ``conf.pdb`` and ``conf.gro`` and
   read back by ``System.from_file`` (every column and the coordinates as
   each format stores them; read and write seconds); ``sys("protein")``'s
   measures with and without ``PBC_FULL`` (1e-6 relative, a rotation's
   entries 1e-6); then the per-call table: ``com``, ``gyration``,
   ``fit_transform`` and ``rmsd_mw`` (against the second frame),
   ``within_of`` the protein, ``select("index .. and within 0.5 pbc of
   protein")`` and ``distance_search`` against the protein on the first 100,
   5,000 and 100,000 atoms, and ``sasa`` of 100 and 1,000 atoms: the card's
   and the CPU's wall ms a call, the answers equal (sets and pair lists) or
   within the bars, each ``within`` launching ``cell_bins`` and
   ``within_ghost`` and never ``within_rows``; the voxel volume of 100
   atoms; the per-frame fit + ``rmsd_mw`` of the protein through
   ``AnalysisTask`` over ``conf.pdb`` and the headline XTC on each route
   (1e-5 nm; both fps); ``dssp("gmx")`` and ``dss()`` of an ideal
   100-residue alpha-helix built by NeRF (``tests/torch_structures.py``):
   ``H`` on every interior residue;
20. host half (run last): the headline's first 64 frames written as a TRR
   and an AMBER NetCDF by the port's writers and streamed, with the XTC's
   same frames, through phase 13's selection task: the TRR's and the
   NetCDF's counts and checksums equal the XTC's frame for frame, the
   NetCDF's coordinates within 1e-6 nm of the XTC's, one ``cell_bins`` and one
   ``within_ghost`` a within node a window on each stream, fps of each
   format; ``molar-torch last`` on the TRR (its GRO equal to the GRO
   writer's of the last frame); phase 14's first 200 ligands through an
   SDF written and read back (columns equal), ``perceive``,
   ``apply_ff("gaff")`` and ``("gaff2")`` and espaloma charges on the card
   from the topologies read back (within 1e-6 of phase 14's); ``Sel.sas_mesh``
   of 1,000 protein atoms beside ``ops.sasa_lr``'s exact area on the card;
   ``membrane_dev`` (72 lipids, 64 frames, leaflet groups) through the
   host ``Membrane``, ``MembraneDevice(membrane)`` on the card (group
   statistics within ``MEMBRANE_TOL`` of the host's) and ``molar-torch
   membrane`` on the card (its files within ``MEMBRANE_TOL`` of the host's,
   its ``--vmd`` drawing byte-equal to the host's) and with ``--device
   cpu`` (byte-equal to the host's); ``molar-torch
   solvate`` of the headline's protein in a tiled 216-water box on both
   routes (the same file); the times a ligand and each route's fps and
   seconds; last the six examples of ``molar_tpu_torch/examples`` on the
   card on generated inputs.

Each path resets every kernel's launch count just before it and reads the
counts just after: the ghost path must launch only the two ghost kernels,
the rows path the binning kernel and the row kernel once a window each and
never the ghost stencil, the dodecahedron path the two ghost kernels once
a window on its ghost route and none on its correction route, the
workloads, sasa, membrane, espaloma and trjconv paths none, the selection
path the two ghost
kernels once a ghost-route within node a window, the 1M path the two
ghost kernels at least once a window, the mesh path once a shard a
window, the user-API path each ghost kernel at least once for every
``within_of`` and ``within`` text it times (never the row kernel), and the
host-half path the two ghost kernels once a within node a window of the
TRR and NetCDF streams and once a window of the contacts example.

Any failure raises, and then the script exits non-zero without its last
line. The last line is ``{"ok": true, "device": {...}}``; the line before it
is the per-kernel JSON record (launches on the main path and on the
selection, 1M, mesh, user-API and host-half paths, time, the plain twin's time and
the bound, each per launch, and the same on the 1M window). The script needs a CUDA
device and imports no JAX.

The system is ``bench.py``'s headline at its defaults and is not an option
here: only the headline's frame count and number of timed passes are.

Usage: python3 chip_smoke.py [--frames 256] [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
# name -> (source, the TPU kernel it replaces as file:line).
KERNELS = {
    "cell_bins": ("molar_tpu_torch/csrc/cell_bin.cu", "molar_tpu/ops/neighbor_pallas.py:257"),
    "within_ghost": ("molar_tpu_torch/csrc/within_ghost.cu", "molar_tpu/ops/neighbor_pallas.py:200"),
    "within_rows": ("molar_tpu_torch/csrc/within_rows.cu", "molar_tpu/ops/neighbor_pallas.py:43"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): device
# memory bytes/s, and float32 FLOP/s outside the tensor cores (the kernels'
# arithmetic type). A kernel's bound is the larger of its bytes (each input
# read once, each output written once) and its operations over these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# bench.py's headline settings: --atoms, --protein, --box (nm), --cutoff (nm),
# and the window the port's ``auto_window`` picks at 100k atoms.
ATOMS = 100_000
PROTEIN = 5_000
BOX = 10.0
CUTOFF = 0.5
WINDOW = 64
# The dodecahedron path: image distance d with d^3 * sqrt(2)/2 = 1000 nm^3
# (the headline's volume, so 100 atoms/nm^3; a grid of 18 x 18 x 15 cells
# from the cell heights), 64 frames.
DODECA_D = (1000.0 * np.sqrt(2.0)) ** (1 / 3)
DODECA_DIMS = (18, 18, 15)
DODECA_FRAMES = 64
# It keeps the 16 frames a window it was first measured at (a 64-frame
# window would be the whole file), and two timed passes a route.
DODECA_WINDOW = 16
DODECA_REPEATS = 2
BRUTE_SAMPLE = 5000
STAGES = ("decode", "fit_rmsd", "search", "checksum")
# Profiled passes of a window tried before a trace that lacks a stage's
# device ranges fails the phase (the profiler has been seen to drop every
# device range of a profiled run).
PROFILE_TRIES = 3
# Passes of a window in one profiled trace of ``_workload_window``, the last
# one read: a trace can lack its first device operations, and a short
# window (``com_splits``: a dozen operations) has lost every range of two
# passes in three traces running on an NVIDIA H100 80GB HBM3, so more
# unread passes go first.
PROFILE_PASSES = 4
# The workloads path: benchmarks/workloads.py's defaults (--atoms, --protein,
# the 8 nm box), 1,024 frames, 3 timed passes a workload, and the window
# sizes of the sweep.
WL_ATOMS = 50_000
WL_PROTEIN = 4_000
WL_BOX = 8.0
WL_FRAMES = 1024
WL_REPEATS = 3
WL_SWEEP = (16, 32, 64, 128, 256, 512, 1024)
WL_STAGES = {"ca_rmsd": ("ca_rmsd.decode", "ca_rmsd.fit_rmsd"),
             "com_splits": ("com_splits.decode", "com_splits.com_gyration"),
             "contacts": ("contacts.decode", "contacts.contacts"),
             "fused": ("fused.decode", "fused.fit_rmsd", "fused.com_gyration", "fused.contacts")}
# How each per-frame output of a workload's module is held against the CPU
# run: "abs" within 1e-5, "rel" within 1e-5 relative, "equal".
WL_OUTPUTS = {"ca_rmsd": (("rmsd", "abs"),),
              "com_splits": (("com", "rel"), ("gyr", "rel")),
              "contacts": (("count", "equal"), ("overflow", "equal")),
              "fused": (("rmsd", "abs"), ("gyr", "rel"), ("count", "equal"),
                        ("overflow", "equal"))}


def _wire():
    """The wire form the port's streams ship."""
    from molar_tpu_torch.tasks import trajectory

    return trajectory.WIRE


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"# {label}: {body}", flush=True)


def import_port():
    """The port package of THIS checkout (never an installed copy)."""
    if not all((HERE / src).is_file() for src, _ in KERNELS.values()):
        raise SystemExit(f"chip_smoke.py: no port sources beside the script ({HERE})")
    sys.path.insert(0, str(HERE))
    import molar_tpu_torch

    if pathlib.Path(molar_tpu_torch.__file__).resolve().parent.parent != HERE:
        raise SystemExit(f"molar_tpu_torch resolved outside {HERE}")
    return molar_tpu_torch


# ---------------------------------------------------------------- phase 1


def phase_device(port):
    import torch

    device = port.require_cuda()
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[device.index]
    print(smi, flush=True)
    phase("device", name=repr(name), count=torch.cuda.device_count(),
          nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          host_cpu_count=os.cpu_count(), host_cpus_usable=len(os.sched_getaffinity(0)))
    return device, name, smi


# ---------------------------------------------------------------- phase 2


def phase_build():
    from molar_tpu_torch import build

    t0 = time.perf_counter()
    lib, log = build.build_kernels()
    t_kernel = time.perf_counter() - t0
    codec = build.build_codec()
    native = build.build_native_baseline()
    native_wl = build.build_native_workloads()
    ptxas = " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line
    )
    phase("build", kernel_s=round(t_kernel, 3),
          total_s=round(time.perf_counter() - t0, 3),
          artifacts=",".join(p.name for p in (lib, codec, native, native_wl)), ptxas=repr(ptxas))
    return native


# ---------------------------------------------------------------- phase 3


def _cuda_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(fn, n: int) -> float:
    """Device ms of one ``fn()``: ``n`` calls captured into a CUDA graph, two
    events around one replay. Nothing is enqueued by the host between the
    launches, so a slow host does not show up as kernel time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: (wall ms, device-busy ms as the
    union of kernel and copy intervals, top device ops by self time, the
    names of all ops with device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:"))
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    ops = _device_ops(prof)
    return wall * 1e3, busy / 1e3, ops[:4], [k for k, _ in ops]


def _device_ops(prof):
    """The operations of a profiled run with device time of their own (raw
    kernel names and stage ranges left out) -> [(name, self device ms)],
    the largest first."""
    ops = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith(("void ", "(anon", "stage:"))),
                 key=lambda kv: -kv[1])
    return [(k, round(v / 1e3, 4)) for k, v in ops]


def _scenes_vs_plain(device, label, scenes, search):
    """A search on the card against its plain twin on the same CUDA tensors:
    exact mask and overflow-flag equality on ``scenes`` plus one whose caps
    are too small, and the tie scenes' members. ``search(coords, src, tgt,
    cutoff, box, inv, dims, pbc, cap, tgt_cap, plain)`` runs one frame.
    Returns the names checked."""
    import torch

    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import grid_dims_for

    from torch_scenes import TIE_MEMBERS, scene

    def t(a):
        return torch.as_tensor(a, device=device)

    checked = []
    for name, over_cap in [(n, None) for n in scenes] + [("random19", 2)]:
        coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
        cap = over_cap or cap
        box = PeriodicBox(np.diag(sides))
        args_ = (t(coords), None if src is None else t(src), t(tgt), cutoff,
                 t(box.matrix), t(box.inv), grid_dims_for(box, cutoff), pbc, cap, cap)
        mk, ok_ = search(*args_, False)
        mp, op_ = search(*args_, True)
        torch.cuda.synchronize()
        tag = f"{label} {name}" + (" (overflow)" if over_cap else "")
        ofl = bool(ok_)
        if ofl != bool(op_):
            raise AssertionError(f"{tag}: overflow flags differ (kernel {ofl}, plain {bool(op_)})")
        if ofl != bool(over_cap):
            raise AssertionError(f"{tag}: overflow flag is {ofl}")
        if not ofl and not torch.equal(mk, mp):
            raise AssertionError(f"{tag}: kernel mask != plain mask "
                                 f"({int((mk != mp).sum())} of {mk.numel()} differ)")
        if name in TIE_MEMBERS and not over_cap:
            got = src[mk.cpu().numpy()].tolist()
            if got != TIE_MEMBERS[name]:
                raise AssertionError(f"{tag}: members {got} != {TIE_MEMBERS[name]}")
        checked.append("overflow" if over_cap else name)
    return checked


def _bound(nbytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _near(tcount, dims, tcap: int):
    """Targets (up to ``tcap`` a cell) in each cell's 27 neighbour cells
    under full PBC, from per-cell counts (..., n_cells), aliased offsets of
    1- and 2-cell axes counted as often as the kernels visit them."""
    from molar_tpu_torch.ops.neighbor_ghost import _image_cells

    cells, _, ok = _image_cells(dims, (True,) * 3, tcount.device)
    return (tcount.clamp(max=tcap)[..., cells] * ok).sum(dim=-2)


def _pairs(scount, tcount, dims, cap: int, tcap: int) -> int:
    """Candidate pairs of a full-PBC 27-cell stencil: every source (up to
    ``cap`` a cell) against the targets of its 27 neighbour cells."""
    return int((scount.clamp(max=cap) * _near(tcount, dims, tcap)).sum())


def _headline_window(device):
    """A full headline window (:data:`WINDOW` frames) at tier-0 caps: frame 0 of the main
    path's system plus a seeded 0.02 nm random walk, as
    ``headline.write_trajectory`` makes it -> (coords (WINDOW, N, 3), protein
    indices, boxes, invs (device tensors), dims, cap, tgt_cap)."""
    import torch

    from molar_tpu_torch import headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import estimate_caps, grid_dims_for

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, _ = headline.make_system(ATOMS, PROTEIN, box.matrix)
    dims = grid_dims_for(box, CUTOFF)
    pidx = np.arange(PROTEIN)
    cap, tcap, _ = headline.caps_for(
        *estimate_caps(coords0, box.inv, dims, pidx, margin=1.0, round_to=1), 0)
    c0, tgt, bm, bi = (torch.as_tensor(a, device=device) for a in (coords0, pidx, box.matrix,
                                                                   box.inv))
    steps = np.random.default_rng(1).normal(0, 0.02, (WINDOW, ATOMS, 3))
    coords = (c0[None] + torch.as_tensor(np.cumsum(steps, axis=0), device=device)).float()
    boxes, invs = bm.expand(WINDOW, 3, 3).contiguous(), bi.expand(WINDOW, 3, 3).contiguous()
    return coords, tgt, boxes, invs, dims, cap, tcap


def _window_work(counts, dims, cap: int, tcap: int):
    """What a stencil over a window's cell records has to touch, from its
    per-cell counts (B, 2, n_cells) -> (candidate pairs, live sources,
    occupied target slots): a source is live when its 27-cell
    neighbourhood holds a target; the others keep the mask's zero."""
    scount, tcount = counts[:, 0].clamp(max=cap), counts[:, 1].clamp(max=tcap)
    live_src = int((scount * (_near(tcount, dims, tcap) > 0)).sum())
    return _pairs(scount, tcount, dims, cap, tcap), live_src, int(tcount.sum())


def phase_kernel_vs_plain(device):
    """The two ghost kernels against their plain twins: every shared scene
    through ``within_mask``, then a full headline window through
    each kernel and the whole window search. Returns the kernel records of
    both."""
    import torch

    from molar_tpu_torch.ops import neighbor_ghost as ng
    from molar_tpu_torch.ops.neighbor import (
        _cutoff2, _search_args, within_mask, within_mask_window,
    )

    from torch_scenes import GHOST_SCENES, blocked_members, cell_members

    def search(c, s, tg, cut, bm, bi, dims, pbc, cap, tcap, plain):
        return within_mask(c, s, tg, cut, bm, bi, dims=dims, cap=cap, tgt_cap=tcap, pbc=pbc,
                           plain=plain)

    checked = _scenes_vs_plain(device, "kernel_vs_plain", GHOST_SCENES, search)

    coords, tgt, boxes, invs, dims, cap, tcap = _headline_window(device)
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    full = (True,) * 3
    window = (coords, None, tgt, CUTOFF, boxes, invs, dims, cap, tcap)
    masks, ofl = within_mask_window(*window)
    pmasks, pofl = within_mask_window(*window, plain=True)
    if ofl.any() or pofl.any() or not torch.equal(masks, pmasks):
        raise AssertionError("headline window: kernels and plain twin disagree or overflow")

    bins_args = (coords, None, tgt, boxes, invs, dims, cap, tcap)
    src_rec, tgt_rec, counts, bofl = ng.cell_bins(*bins_args)
    bins_err, members = 0.0, 0
    for f in range(WINDOW):
        sa = _search_args(coords[f], None, tgt, boxes[f], invs[f], dims)
        tflat = (sa[7] * ny + sa[8]) * nz + sa[9]
        want = blocked_members(coords[f], None, tgt, boxes[f], invs[f], dims, cap, tcap)
        for k, (flat, rec, (pos, xyz)) in enumerate(zip((sa[3], tflat), (src_rec[f], tgt_rec[f]),
                                                        want)):
            if not torch.equal(counts[f, k], torch.bincount(flat.long(), minlength=n_cells).int()):
                raise AssertionError(f"headline window frame {f}: binning counts != bincount")
            got_pos, got_xyz = cell_members(rec, counts[f, k], rec.shape[1])
            if not torch.equal(got_pos, pos):
                raise AssertionError(f"headline window frame {f}: cell members differ")
            bins_err = max(bins_err, float((got_xyz - xyz).abs().max()))
            members += int((pos >= 0).sum())
    if bofl.any() or bins_err:
        raise AssertionError(f"headline window: binning overflow {bofl.tolist()} or records "
                             f"off by {bins_err}")

    c2 = _cutoff2(CUTOFF)
    stencil_args = (src_rec, tgt_rec, counts, boxes, dims, cap, tcap, full, c2, ATOMS)
    kmask = ng.within_ghost(*stencil_args)
    stencil_err = int((kmask.int() - ng._bins_stencil(*stencil_args).int()).abs().max())
    if stencil_err or not torch.equal(kmask, masks):
        raise AssertionError("headline window: stencil kernel != its twin on the same records")
    checked.append("headline_window")

    runs = {k: [] for k in ("bins", "bins_plain", "stencil", "stencil_plain", "call",
                            "call_plain")}
    for order in ((False, True), (True, False)):
        for kernel in order:
            if kernel:
                runs["bins"].append(_cuda_ms(lambda: ng.cell_bins(*bins_args), 50))
                runs["stencil"].append(_cuda_ms(lambda: ng.within_ghost(*stencil_args), 50))
                runs["call"].append(_cuda_ms(lambda: within_mask_window(*window), 50))
            else:
                runs["bins_plain"].append(_cuda_ms(lambda: ng._cell_bins_plain(*bins_args), 2))
                runs["stencil_plain"].append(
                    _cuda_ms(lambda: ng._bins_stencil(*stencil_args), 2))
                runs["call_plain"].append(
                    _cuda_ms(lambda: within_mask_window(*window, plain=True), 2))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}

    # Bytes each function must move: its inputs read once, its outputs
    # written once. The binning writes every point's record. The stencil
    # needs every count, the target records, and the source records of the
    # live cells only (a target in their 27-cell neighbourhood): the other
    # sources keep the mask's zero.
    n_pts = WINDOW * (ATOMS + PROTEIN)
    pairs, live_src, occupied = _window_work(counts, dims, cap, tcap)
    coord_bytes = coords.numel() * 4 + tgt.numel() * 8 + 2 * boxes.numel() * 4
    bins_bound = _bound(coord_bytes + n_pts * 16 + counts.numel() * 4 + WINDOW, n_pts * 40)
    stencil_bytes = ((live_src + occupied) * 16 + counts.numel() * 4
                     + boxes.numel() * 4 + WINDOW * ATOMS)
    stencil_bound = _bound(stencil_bytes, pairs * 9)
    whole_bound = _bound(coord_bytes + WINDOW * ATOMS + WINDOW, pairs * 9)
    phase("kernel_vs_plain", scenes=len(checked), all_equal=True, names=",".join(checked),
          window=f"frames={WINDOW},n={ATOMS},tgt={PROTEIN},dims={dims},cap={cap},tgt_cap={tcap}",
          members_checked=members, candidate_pairs=pairs, live_sources=live_src,
          stencil_bytes=stencil_bytes,
          bins_ms=ms["bins"], bins_plain_ms=ms["bins_plain"], **{
              f"bins_{k}": v for k, v in bins_bound.items()},
          stencil_ms=ms["stencil"], stencil_plain_ms=ms["stencil_plain"], **{
              f"stencil_{k}": v for k, v in stencil_bound.items()},
          call_ms=ms["call"], call_plain_ms=ms["call_plain"], **{
              f"call_{k}": v for k, v in whole_bound.items()},
          call_ms_per_frame=ms["call"] / WINDOW,
          runs_ms=repr({k: [round(x, 5) for x in v] for k, v in runs.items()}))
    per_launch = {"frames_per_launch": WINDOW, "library_ms": None}
    return {
        "cell_bins": {"max_abs_err": bins_err, "ms": ms["bins"], "plain_ms": ms["bins_plain"],
                      **bins_bound, **per_launch},
        "within_ghost": {"max_abs_err": stencil_err, "ms": ms["stencil"],
                         "plain_ms": ms["stencil_plain"], **stencil_bound, **per_launch},
    }


# ---------------------------------------------------------------- phase 4


def _cpu_parity(path, results, ref, masses, pidx, box, dims, caps0, search="ghost"):
    """Frames 0 / mid / last through the plain path on the CPU (tier raised
    until the search does not overflow), against the card's per-frame
    ``results`` (rmsd, count, checksum) -> (count and checksum mismatches,
    largest RMSD error). ``box`` and ``search`` pick the route as on the
    card."""
    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.tasks.trajectory import _invert_boxes

    rmsd, count, check = results
    parity, rmsd_err = 0, 0.0
    for k in sorted({0, len(count) // 2, len(count) - 1}):
        with XtcHandler(path) as h:
            fr = h.read_frame(k)
        boxes = fr.box.matrix[None]
        window = convert.transport_to_torch((fr.coords[None], boxes, _invert_boxes(boxes)), "cpu")
        for tier in range(4):
            model = convert.from_numpy(ref, masses, pidx, box.matrix, CUTOFF,
                                       headline.caps_for(*caps0, tier), dims, "cpu", search=search)
            r_cpu, n_cpu, chk_cpu, ofl = model(*window)
            if not bool(ofl[0]):
                break
        else:
            raise AssertionError(f"frame {k}: the CPU reference overflows at every tier")
        parity += int(int(n_cpu[0]) != int(count[k])) + int(int(chk_cpu[0]) != int(check[k]))
        rmsd_err = max(rmsd_err, abs(float(r_cpu[0]) - float(rmsd[k])))
    return parity, rmsd_err


def phase_main_path(device, args, native_exe, workdir):
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, auto_window

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, masses = headline.make_system(ATOMS, PROTEIN, box.matrix)
    pidx = np.arange(PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    path = os.path.join(workdir, "traj.xtc")
    t0 = time.perf_counter()
    headline.write_trajectory(path, coords0, box.matrix, args.frames)
    t_write = time.perf_counter() - t0
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    if auto_window(path) != WINDOW:
        raise AssertionError(f"auto_window picks {auto_window(path)} frames for the headline, "
                             f"the smoke runs {WINDOW}")

    # Host side alone: decode every window.
    reader = TrajectoryReader([path])
    t0 = time.perf_counter()
    windows = list(reader.iter_windows(WINDOW, quantized=_wire()))
    t_decode = time.perf_counter() - t0
    wire_mb = sum(
        sum(a.nbytes for a in w[0]) if isinstance(w[0], tuple) else w[0].nbytes for w in windows
    ) / 1e6
    # Copies alone: every window to the card through pinned buffers.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_windows = [convert.transport_to_torch(w, device, non_blocking=True) for w in windows]
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    model0 = convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF,
                                headline.caps_for(*caps0, 0), dims, device)
    del windows

    # The main path: a warm-up window, the launch counter to 0, then the
    # timed passes through the user's entry point.
    model0(*dev_windows[0])
    torch.cuda.synchronize()
    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(args.repeats, lambda: headline.run(
        path, ref, pmass, pidx, box, CUTOFF, dims, caps0, WINDOW, device))
    launches = _launches()
    if launches.pop("within_rows"):
        raise AssertionError("the ghost path launched the row kernel")
    if len(ids) != args.frames or not np.array_equal(ids, np.arange(args.frames)):
        raise AssertionError(f"stream returned frames {ids[:4]}... ({len(ids)})")
    windows = args.repeats * -(-args.frames // WINDOW)
    if min(launches.values()) < windows:
        raise AssertionError(f"ghost kernels launched {launches} times for {windows} windows")
    if not (np.isfinite(rmsd).all() and (count > 0).all()):
        raise AssertionError("non-finite RMSD or empty within set")

    # Compute alone: every window already on the card.
    def compute_all():
        for w in dev_windows:
            model0(*w)

    compute_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_all()
    torch.cuda.synchronize()
    t_compute = time.perf_counter() - t0
    prof_wall, prof_busy, prof_top, _ = _device_profile(
        lambda: [model0(*w) for w in dev_windows[:2]])

    # Parity: frame 0 against the native C++ program; frames 0 / mid / last
    # against the plain path on the CPU.
    native = json.loads(subprocess.run(
        [str(native_exe), path, str(PROTEIN), str(CUTOFF)],
        check=True, capture_output=True, text=True, timeout=600,
    ).stdout)
    native_parity = abs(int(native["within0"]) - int(count[0]))
    parity, rmsd_err = _cpu_parity(path, (rmsd, count, check), ref, pmass, pidx, box, dims,
                                   caps0)
    phase("main_path", frames=args.frames, window=WINDOW,
          caps_tier0=headline.caps_for(*caps0, 0), dims=dims,
          e2e_fps=[round(p, 3) for p in passes], e2e_fps_best=max(passes),
          e2e_fps_median=float(np.median(passes)),
          compute_only_fps=args.frames / t_compute, windows_retried=retried,
          host_decode_s=t_decode, h2d_s=t_h2d, device_compute_s=t_compute,
          profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, top_device_ops=repr(prof_top),
          wire_mb=round(wire_mb, 3), write_s=round(t_write, 3),
          native_fps=native["fps"], within0=int(count[0]), native_within0=native["within0"],
          mean_rmsd=float(np.mean(rmsd)), rmsd_max_abs_err_vs_cpu=rmsd_err,
          parity_diff=parity, native_parity_diff=native_parity, launches=launches)
    if parity or native_parity or rmsd_err > 1e-5:
        raise AssertionError(f"parity failed: parity_diff={parity} "
                             f"native_parity_diff={native_parity} rmsd_err={rmsd_err}")
    return launches, model0, dev_windows[0], (ids, rmsd, count, check), int(native["within0"])


# ---------------------------------------------------------------- phase 5


def _stage_device_ms(prof, last_pass_from=None):
    """Device ms of a profiled pass by the ``stage:`` range each device
    operation ran in ("outside" for none), and the number of device
    operations. A stage's device work is what runs inside its innermost
    range on the device's timeline (one stream; a range may hold another). The
    profiler ties no kernel launched through ctypes to a host-side range,
    so the device-side ranges are the ones read. When the trace holds
    several passes, ``last_pass_from`` names the stage a pass begins with:
    only what ran from its last range on is read."""
    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if last_pass_from is not None:
        lo = max(e.time_range.start for e in device if e.name == f"stage:{last_pass_from}")
        device = [e for e in device if e.time_range.start >= lo]
    ranges = [(e.name[6:], e.time_range.start, e.time_range.end)
              for e in device if e.name.startswith("stage:")]
    ops = [e.time_range for e in device if not e.name.startswith("stage:")]
    by_stage = {}
    for tr in ops:
        # the innermost range holding the operation (ranges may nest)
        name = min(((hi - lo, n) for n, lo, hi in ranges if lo <= tr.start and tr.end <= hi),
                   default=(0, "outside"))[1]
        by_stage[name] = by_stage.get(name, 0.0) + (tr.end - tr.start) / 1e3
    return by_stage, len(ops)


def phase_stages(model, window, label="stages"):
    """One resident window through the steps of ``FitWithinWindow.forward``,
    stage by stage, on ``model``'s search route: host enqueue ms of each
    stage (host clock, no profiler, no synchronize inside the pass), device
    ms of each stage (the kernels ``torch.profiler`` attributes to it, in a
    second pass), and the number of device operations in the window."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from molar_tpu_torch.ops.measure import fit_rmsd
    from molar_tpu_torch.tasks.trajectory import decode_window_coords

    m = model
    host = dict.fromkeys(STAGES, 0.0)

    def window_pass(label: bool):
        def stage(name, fn, *a):
            t0 = time.perf_counter()
            with record_function(f"stage:{name}") if label else contextlib.nullcontext():
                out = fn(*a)
            host[name] += (time.perf_counter() - t0) * 1e3
            return out

        transport, boxes, invs = window
        coords = stage("decode", decode_window_coords, transport)
        stage("fit_rmsd", fit_rmsd, coords[:, m.protein_idx], m.ref, m.masses)
        masks, _ = stage("search", m.masks, coords, boxes, invs)
        ids1 = torch.arange(1, coords.shape[1] + 1, device=coords.device)
        stage("checksum", lambda: (masks.sum(dim=1), (ids1 * masks).sum(dim=1) & 0xFFFFFFFF))

    window_pass(False)
    torch.cuda.synchronize()
    host.update(dict.fromkeys(STAGES, 0.0))
    t0 = time.perf_counter()
    window_pass(False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    host_ms = dict(host)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window_pass(True)
        torch.cuda.synchronize()
    by_stage, n_ops = _stage_device_ms(prof)
    device_ms = {**dict.fromkeys(STAGES + ("outside",), 0.0), **by_stage}
    if not n_ops or device_ms["search"] <= 0:
        raise AssertionError("the profiler saw no device work in the window's stages")
    frames = window[1].shape[0]
    phase(label, route=m.search, frames=frames,
          atoms=decode_window_coords(window[0]).shape[1], wall_ms=wall,
          host_enqueue_ms=sum(host_ms.values()),
          device_ms=sum(device_ms.values()), device_ops=n_ops,
          device_ops_per_frame=n_ops / frames,
          host_ms=repr({k: round(v, 4) for k, v in host_ms.items()}),
          stage_device_ms=repr({k: round(v, 4) for k, v in device_ms.items()}))


# ---------------------------------------------------------------- phase 6


def _rows_window_equal(tag, call):
    """One window through the row route on the card: the masks and flags of
    ``within_mask_rows_window`` against ``plain=True`` (the plane twin) and
    the ghost route, and the stencil kernel alone, tiled and a block per
    cell, against its twin on the same cell records. ``call``: the window
    search's arguments (coords, src, tgt, cutoff, boxes, invs, dims, cap,
    tgt_cap). Returns (the stencil's arguments, its largest difference from
    its twin)."""
    import torch

    from molar_tpu_torch.ops import neighbor_ghost as ng
    from molar_tpu_torch.ops import neighbor_rows as nr
    from molar_tpu_torch.ops.neighbor import _cutoff2, within_mask_window

    masks, ofl = nr.within_mask_rows_window(*call)
    pmasks, pofl = nr.within_mask_rows_window(*call, plain=True)
    gmasks, gofl = within_mask_window(*call)
    if ofl.any() or pofl.any() or gofl.any():
        raise AssertionError(f"{tag}: overflow (kernel {ofl.tolist()}, plain {pofl.tolist()})")
    if not masks.any() or not torch.equal(masks, pmasks) or not torch.equal(masks, gmasks):
        raise AssertionError(f"{tag}: masks differ ({int((masks != pmasks).sum())} from the "
                             f"plane twin, {int((masks != gmasks).sum())} from the ghost route)")
    coords, src, tgt, cutoff, boxes, invs, dims, cap, tcap = call
    src_rec, tgt_rec, counts, _ = ng.cell_bins(coords, src, tgt, boxes, invs, dims, cap, tcap)
    stencil = (src_rec, tgt_rec, counts, boxes, dims, cap, tcap, _cutoff2(cutoff), masks.shape[1])
    twin = nr._rows_bins_stencil(*stencil)
    err = 0
    for cells in (nr.CELLS_PER_BLOCK, 1):
        got = nr.within_rows(*stencil, cells_per_block=cells)
        err = max(err, int((got.int() - twin.int()).abs().max()))
        if err or not torch.equal(got, masks):
            raise AssertionError(f"{tag}: stencil kernel ({cells} cells a block) != its twin "
                                 f"on the same records ({int((got != twin).sum())} differ)")
    return stencil, err


def phase_rows_vs_plain(device):
    """The per-pair min-image search against its plain twins: the row
    scenes one frame each (ties and overflow among them), the row scenes
    and the crowded one as windows, then the headline window with
    the kernel's, the twins' and the whole call's times in turns plain /
    kernel / kernel / plain, and the bound. Returns the kernel's record."""
    import torch

    from molar_tpu_torch.ops import neighbor_rows as nr

    from torch_scenes import ROW_SCENES, window

    def search(c, s, tg, cut, bm, bi, dims, pbc, cap, tcap, plain):
        return nr.within_mask_rows(c, s, tg, cut, bm, bi, dims, cap=cap, tgt_cap=tcap,
                                   plain=plain)

    checked = _scenes_vs_plain(device, "rows_vs_plain", ROW_SCENES, search)
    for name in ROW_SCENES + ["crowded"]:
        coords, src, tgt, cutoff, boxes, invs, _, cap, dims = window(name)
        d = [None if a is None else torch.as_tensor(a, device=device)
             for a in (coords, src, tgt, boxes, invs)]
        _rows_window_equal(f"rows_vs_plain window {name}",
                           (*d[:3], cutoff, *d[3:], dims, cap, cap))
        checked.append(f"window:{name}")

    coords, tgt, boxes, invs, dims, cap, tcap = _headline_window(device)
    call = (coords, None, tgt, CUTOFF, boxes, invs, dims, cap, tcap)
    stencil, max_err = _rows_window_equal("rows_vs_plain headline window", call)
    checked.append("headline_window")

    tiles = sorted({1, 4, 8, 16, 32, nr.CELLS_PER_BLOCK})
    runs = {k: [] for k in ("kernel", "plain", "call", "call_plain",
                            *(f"cells_per_block_{t}" for t in tiles))}
    for order in ((False, True), (True, False)):
        for kernel in order:
            if kernel:
                runs["kernel"].append(_graph_ms(lambda: nr.within_rows(*stencil), 20))
                for t in tiles:
                    runs[f"cells_per_block_{t}"].append(
                        _graph_ms(lambda: nr.within_rows(*stencil, cells_per_block=t), 20))
                runs["call"].append(_graph_ms(lambda: nr.within_mask_rows_window(*call), 20))
            else:
                runs["plain"].append(_cuda_ms(lambda: nr._rows_bins_stencil(*stencil), 2))
                runs["call_plain"].append(
                    _cuda_ms(lambda: nr.within_mask_rows_window(*call, plain=True), 1))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}

    # Bytes the stencil must move: every count, the source records of the
    # live cells (a target in their 27-cell neighbourhood; the other sources
    # keep the mask's zero), the occupied target records, the boxes, the
    # mask. Operations: the kernel's own count a candidate pair.
    counts = stencil[2]
    pairs, live_src, occupied = _window_work(counts, dims, cap, tcap)
    nbytes = ((live_src + occupied) * 16 + counts.numel() * 4 + boxes.numel() * 4
              + WINDOW * ATOMS)
    bound = _bound(nbytes, pairs * nr.FLOPS_PER_PAIR)
    coord_bytes = coords.numel() * 4 + tgt.numel() * 8 + 2 * boxes.numel() * 4
    whole_bound = _bound(coord_bytes + WINDOW * ATOMS + WINDOW, pairs * nr.FLOPS_PER_PAIR)
    phase("rows_vs_plain", scenes=len(checked), all_equal=True,
          window=f"frames={WINDOW},n={ATOMS},tgt={PROTEIN},dims={dims},cap={cap},tgt_cap={tcap}",
          cells_per_block=nr.CELLS_PER_BLOCK, stencil_ms=ms["kernel"],
          stencil_block_per_cell_ms=ms["cells_per_block_1"],
          stencil_ms_by_cells_per_block=repr({t: round(ms[f"cells_per_block_{t}"], 5)
                                              for t in tiles}),
          stencil_plain_ms=ms["plain"],
          call_ms=ms["call"], call_plain_ms=ms["call_plain"],
          call_ms_per_frame=ms["call"] / WINDOW, candidate_pairs=pairs,
          flops_per_pair=nr.FLOPS_PER_PAIR, live_sources=live_src, stencil_bytes=nbytes, **bound,
          share_of_bound=bound["bound_ms"] / ms["kernel"],
          **{f"call_{k}": v for k, v in whole_bound.items()},
          runs_ms=repr({k: [round(x, 5) for x in v] for k, v in runs.items()}),
          names=",".join(checked))
    return {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["plain"], **bound,
            "block_per_cell_ms": ms["cells_per_block_1"], "frames_per_launch": WINDOW,
            "library_ms": None}


# ---------------------------------------------------------------- phases 7-8


def _no_sync_window(model, window):
    """One window through ``model`` without a host sync -> host enqueue ms.

    Two checks. Every sync that torch's sync debug mode sees is an error.
    That mode does not see every sync, so the window is also captured into
    a CUDA graph: capture fails at any call that would wait on the device
    (a synchronize, a blocking copy, a read of a device value). The graph's
    replay must then give the eager run's results. (A device-side sleep
    ahead of the window cannot tell a sync from a full launch queue: the
    queue holds about a thousand launches, a window enqueues thousands.)"""
    import torch

    want = model(*window)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        model(*window)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = model(*window)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the window's CUDA graph replay differs from the eager run")
    del graph, got
    return enqueue_ms


def _timed_passes(repeats, fn):
    """Run ``fn`` ``repeats`` times -> (last result, fps of each pass)."""
    import torch

    passes = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        passes.append(len(out[0]) / (time.perf_counter() - t0))
    return out, passes


def _wrappers():
    from molar_tpu_torch.ops import neighbor_ghost, neighbor_rows

    return {"cell_bins": neighbor_ghost.cell_bins, "within_ghost": neighbor_ghost.within_ghost,
            "within_rows": neighbor_rows.within_rows}


def _reset_launches():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def _launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


def phase_rows_path(device, args, path, ghost, native_within0, ghost_model, ghost_window):
    """The main path's trajectory through the row route (``search="rows"``:
    the binning kernel and the row kernel, once a window each), and no host
    sync in a window of either route."""
    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, masses = headline.make_system(ATOMS, PROTEIN, box.matrix)
    pidx = np.arange(PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    model = convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF, headline.caps_for(*caps0, 0),
                               dims, device, search="rows")
    if model.search != "rows":
        raise AssertionError(f"the cubic box with search='rows' took route {model.search}")
    windows = TrajectoryReader([path]).iter_windows(WINDOW, quantized=_wire())
    dev_windows = [convert.transport_to_torch(next(windows), device) for _ in range(2)]
    enqueue_ms = _no_sync_window(model, dev_windows[0])
    ghost_enqueue_ms = _no_sync_window(ghost_model, ghost_window)

    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(args.repeats, lambda: headline.run(
        path, ref, pmass, pidx, box, CUTOFF, dims, caps0, WINDOW, device, search="rows"))
    launches = _launches()
    n_windows = args.repeats * -(-args.frames // WINDOW)
    if (launches["within_ghost"] or launches["cell_bins"] != launches["within_rows"]
            or launches["within_rows"] < n_windows
            or (not retried and launches["within_rows"] != n_windows)):
        raise AssertionError(f"rows path: launches {launches} for {n_windows} windows "
                             f"({retried} retried): expected one cell_bins and one within_rows "
                             f"a window and no within_ghost")
    prof_wall, prof_busy, prof_top, prof_ops = _device_profile(
        lambda: [model(*w) for w in dev_windows])
    plane_ops = [k for k in prof_ops
                 if any(w in k for w in ("sort", "cummax", "scatter", "index_put"))]
    if plane_ops:
        raise AssertionError(f"rows path: plane-build operations on the card: {plane_ops}")
    gids, grmsd, gcount, gcheck = ghost
    if not np.array_equal(ids, gids):
        raise AssertionError("rows path: frame ids differ from the ghost path's")
    vs_ghost = int((count != gcount).sum() + (check != gcheck).sum())
    rmsd_vs_ghost = float(np.abs(rmsd - grmsd).max())
    parity, rmsd_err = _cpu_parity(path, (rmsd, count, check), ref, pmass, pidx, box, dims,
                                   caps0, search="rows")
    native_parity = abs(native_within0 - int(count[0]))
    phase("rows_path", frames=len(ids), window=WINDOW, dims=dims,
          caps_tier0=headline.caps_for(*caps0, 0), e2e_fps=[round(p, 3) for p in passes],
          e2e_fps_best=max(passes), e2e_fps_median=float(np.median(passes)),
          windows_retried=retried, profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, top_device_ops=repr(prof_top),
          within0=int(count[0]), native_within0=native_within0,
          frames_differing_from_ghost=vs_ghost, rmsd_max_abs_diff_vs_ghost=rmsd_vs_ghost,
          parity_diff=parity, native_parity_diff=native_parity,
          rmsd_max_abs_err_vs_cpu=rmsd_err, launches=launches,
          launches_per_window=launches["within_rows"] / n_windows, device_op_names=len(prof_ops),
          plane_build_ops=len(plane_ops), no_sync_window=True, window_enqueue_ms=enqueue_ms,
          ghost_no_sync_window=True,
          ghost_window_enqueue_ms=ghost_enqueue_ms)
    if vs_ghost or parity or native_parity or rmsd_err > 1e-5:
        raise AssertionError(f"rows path parity failed: vs_ghost={vs_ghost} parity_diff={parity} "
                             f"native_parity_diff={native_parity} rmsd_err={rmsd_err}")
    return launches["within_rows"], model, dev_windows[0]


def phase_dodecahedron(device, workdir):
    """A rhombic dodecahedron through both routes of a skewed box: the ghost
    kernels (the default on its height-sized grid) and the triclinic
    correction path (asked for by name), each streamed and timed."""
    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

    from torch_scenes import brute_within, dodecahedron, outside_band

    box = PeriodicBox(dodecahedron(DODECA_D))
    dims = grid_dims_for(box, CUTOFF)
    if dims != DODECA_DIMS:
        raise AssertionError(f"dodecahedron grid {dims}, expected {DODECA_DIMS}")
    coords0, masses = headline.make_system(ATOMS, PROTEIN, box.matrix)
    pidx = np.arange(PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    path = os.path.join(workdir, "dodeca.xtc")
    headline.write_trajectory(path, coords0, box.matrix, DODECA_FRAMES)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    models = {search: convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF,
                                         headline.caps_for(*caps0, 0), dims, device,
                                         search=search)
              for search in ("ghost", "corrections")}
    if [m.search for m in models.values()] != ["ghost", "corrections"]:
        raise AssertionError(f"the dodecahedron took routes {[m.search for m in models.values()]}")
    dev_windows = [convert.transport_to_torch(w, device) for w in
                   TrajectoryReader([path]).iter_windows(DODECA_WINDOW, quantized=_wire())]
    n_windows = len(dev_windows)
    routes = {}
    for search, model in models.items():
        enqueue_ms = _no_sync_window(model, dev_windows[0])
        _reset_launches()
        (ids, rmsd, count, check, retried), passes = _timed_passes(
            DODECA_REPEATS, lambda: headline.run(path, ref, pmass, pidx, box, CUTOFF, dims,
                                                 caps0, DODECA_WINDOW, device, search=search))
        launches = _launches()
        per_pass = n_windows + retried
        want = ({"cell_bins": DODECA_REPEATS * per_pass, "within_ghost": DODECA_REPEATS * per_pass,
                 "within_rows": 0} if search == "ghost" else dict.fromkeys(launches, 0))
        if launches != want:
            raise AssertionError(f"the {search} route launched {launches}, expected {want}")
        if not np.array_equal(ids, np.arange(DODECA_FRAMES)):
            raise AssertionError(f"dodecahedron stream returned frames {ids[:4]}... ({len(ids)})")
        if not (np.isfinite(rmsd).all() and (count > 0).all()):
            raise AssertionError("dodecahedron: non-finite RMSD or empty within set")
        prof_wall, prof_busy, prof_top, _ = _device_profile(
            lambda: [model(*w) for w in dev_windows[:2]])
        parity, rmsd_err = _cpu_parity(path, (rmsd, count, check), ref, pmass, pidx, box, dims,
                                       caps0, search=search)
        routes[search] = dict(
            results=(rmsd, count, check), e2e_fps=[round(p, 3) for p in passes],
            e2e_fps_best=max(passes), e2e_fps_median=float(np.median(passes)),
            windows_retried=retried, launches=launches, profiled_wall_ms=prof_wall,
            device_busy_ms=prof_busy, device_busy_share=prof_busy / prof_wall,
            top_device_ops=repr(prof_top), parity_diff=parity, rmsd_max_abs_err_vs_cpu=rmsd_err,
            no_sync_window=True, window_enqueue_ms=enqueue_ms)

    # The routes' masks, window by window: where they differ, the source's
    # float64 least distance must lie within 1e-6 relative of the cutoff.
    route_diffs, route_far = 0, 0
    for transport, boxes, invs in dev_windows:
        coords = decode_window_coords(transport)
        got = [models[k].masks(coords, boxes, invs)[0].cpu().numpy() for k in models]
        for f in np.flatnonzero((got[0] != got[1]).any(axis=1)):
            far, _ = outside_band(got[0][f], got[1][f], coords[f].cpu().numpy(), pidx,
                                  boxes[f].cpu().numpy(), CUTOFF)
            route_diffs += int((got[0][f] != got[1][f]).sum())
            route_far += int(far.size)
    # Frame 0 on a seeded sample of atoms against the float64 brute force.
    transport, boxes, invs = dev_windows[0]
    mask0 = models["ghost"].masks(decode_window_coords(transport), boxes, invs)[0][0]
    mask0 = mask0.cpu().numpy()
    with XtcHandler(path) as h:
        frame0 = h.read_frame(0).coords
    sample = np.sort(np.random.default_rng(2).choice(ATOMS, BRUTE_SAMPLE, replace=False))
    t0 = time.perf_counter()
    want, dmin = brute_within(frame0, sample, pidx, box.matrix, CUTOFF)
    t_brute = time.perf_counter() - t0
    brute_mismatch = int((mask0[sample] != want).sum())
    ghost, corr = routes["ghost"], routes["corrections"]
    phase("dodecahedron_path", atoms=ATOMS, protein=PROTEIN, d_nm=DODECA_D, dims=dims,
          frames=DODECA_FRAMES, window=DODECA_WINDOW, caps_tier0=headline.caps_for(*caps0, 0),
          **{k: v for k, v in ghost.items() if k != "results"},
          corrections={k: v for k, v in corr.items() if k != "results"},
          ghost_over_corrections_fps=ghost["e2e_fps_median"] / corr["e2e_fps_median"],
          route_mask_diffs=route_diffs, route_mask_diffs_outside_band=route_far,
          within0=int(ghost["results"][1][0]), mean_rmsd=float(np.mean(ghost["results"][0])),
          brute_sample=BRUTE_SAMPLE, brute_hits=int(want.sum()), brute_mismatch=brute_mismatch,
          brute_min_rel_gap=float(np.abs(dmin / CUTOFF - 1).min()), brute_s=round(t_brute, 3))
    bad = [k for k in routes if routes[k]["parity_diff"] or routes[k]["rmsd_max_abs_err_vs_cpu"]
           > 1e-5]
    if bad or route_far or brute_mismatch:
        raise AssertionError(f"dodecahedron parity failed: routes {bad}, "
                             f"route_mask_diffs_outside_band={route_far}, "
                             f"brute_mismatch={brute_mismatch}")
    # The compiled selection's correction route is held against this one.
    return (path, caps0, *corr["results"][1:])


# ---------------------------------------------------------------- phase 9


def _workload_window(model, window, stages):
    """One resident window through a workload's module -> (wall ms, host
    enqueue ms, device ms by stage, device operations, the three device
    operations with the most self time). The host clock runs without the
    profiler; the device times come from a later, profiled pass, in which
    every one of ``stages`` must show device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model(*window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(*window)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # A trace can lack the first device operations after the profiler
            # starts (a dozen, when other profiles ran before in the process):
            # passes that are not read go first.
            for _ in range(PROFILE_PASSES):
                model(*window)
                torch.cuda.synchronize()
        if not any(e.device_type == DeviceType.CUDA and e.name == f"stage:{stages[0]}"
                   for e in prof.events()):
            by_stage = {}  # the trace lost the passes' device ranges: profile again
            continue
        by_stage, n_ops = _stage_device_ms(prof, last_pass_from=stages[0])
        missing = [k for k in stages if by_stage.get(k, 0.0) <= 0]
        if not missing and by_stage.get("outside", 0.0) <= 0.05 * sum(by_stage.values()):
            break
    else:
        raise AssertionError(f"stages of {stages} lack device work in {PROFILE_TRIES} traces: "
                             f"{by_stage}")
    # Every pass is in the sums: divide by their count.
    top = [(k, round(ms / PROFILE_PASSES, 4)) for k, ms in _device_ops(prof)[:3]]
    return wall_ms, enqueue_ms, by_stage, n_ops, top


def _workload_vs_cpu(name, model, cpu_model, dev_window, cpu_window):
    """A window through the module on the card and on the CPU (the plain
    path): every per-frame output as :data:`WL_OUTPUTS` says, and for the
    workloads with contacts the pair lists themselves. Returns the largest
    difference of each output."""
    import torch

    from molar_tpu_torch.ops.neighbor import _cutoff2, _dense_d2
    from molar_tpu_torch.tasks.trajectory import decode_window_coords

    lists = cpu_lists = None
    if name == "contacts":
        # Its forward is the decode and ``pairs(...)[2:]``: one search a side.
        lists = model.pairs(decode_window_coords(dev_window[0]), *dev_window[1:])
        cpu_lists = cpu_model.pairs(decode_window_coords(cpu_window[0]), *cpu_window[1:])
        got, want = lists[2:], cpu_lists[2:]
    else:
        got, want = model(*dev_window), cpu_model(*cpu_window)
    worst = {}
    for (label, how), g, w in zip(WL_OUTPUTS[name], got, want):
        g = g.cpu()
        if how == "equal":
            err = int((g != w).sum())
        else:
            err = (g - w).abs()
            err = float((err / w.abs()).max() if how == "rel" else err.max())
        worst[label] = err
        if err > (0 if how == "equal" else 1e-5):
            raise AssertionError(f"{name}: {label} differs from the CPU run by {err} ({how})")
    if name in ("contacts", "fused"):
        search, cpu_search = (m if name == "contacts" else m.contacts for m in (model, cpu_model))
        coords, cpu_coords = decode_window_coords(dev_window[0]), decode_window_coords(cpu_window[0])
        pairs, _, count, _ = lists or search.pairs(coords, *dev_window[1:])
        cpu_pairs, _, cpu_count, _ = cpu_lists or cpu_search.pairs(cpu_coords, *cpu_window[1:])
        pairs = pairs.cpu()
        if not torch.equal(pairs, cpu_pairs):
            # A pair at the cutoff tie is a wrong answer, not noise: show it.
            f = int((pairs != cpu_pairs).any(dim=2).any(dim=1).nonzero()[0])
            a = {tuple(p) for p in pairs[f, :int(count[f])].tolist()}
            b = {tuple(p) for p in cpu_pairs[f, :int(cpu_count[f])].tolist()}
            i, j = sorted(a ^ b)[0]
            d2 = _dense_d2(coords[f:f + 1], search.src, search.tgt, dev_window[1][f:f + 1],
                           dev_window[2][f:f + 1], None, (True,) * 3)
            cpu_d2 = _dense_d2(cpu_coords[f:f + 1], cpu_search.src, cpu_search.tgt,
                               cpu_window[1][f:f + 1], cpu_window[2][f:f + 1], None, (True,) * 3)
            si, tj = int((cpu_search.src == i).nonzero()[0]), int((cpu_search.tgt == j).nonzero()[0])
            raise AssertionError(
                f"{name}: frame {f} of the window: pair ({i}, {j}) is in one list only: d2 on the "
                f"card {float(d2[0, si, tj])!r}, on the CPU {float(cpu_d2[0, si, tj])!r}, "
                f"cutoff^2 {_cutoff2(search.cutoff)!r}; {len(a ^ b)} pairs differ")
        worst["pair_lists_differing"] = 0
    return worst


def _compaction_ms(model, dev_window):
    """The pair-list compaction of one contacts window, alone: the port's
    prefix sum and scatter over the whole window against one
    ``torch.nonzero_static`` a frame (equal results), each as a CUDA-graph
    replay -> (prefix-sum ms, nonzero_static ms)."""
    import torch

    from molar_tpu_torch.ops.neighbor import _compact, _cutoff2, _dense_d2
    from molar_tpu_torch.tasks.trajectory import decode_window_coords

    coords = decode_window_coords(dev_window[0])
    hit = _dense_d2(coords, model.src, model.tgt, *dev_window[1:], None,
                    (True,) * 3).flatten(1) <= _cutoff2(model.cutoff)

    def per_frame():
        return torch.stack([torch.nonzero_static(h, size=model.max_pairs, fill_value=-1)[:, 0]
                            for h in hit])

    if not torch.equal(_compact(hit, model.max_pairs), per_frame()):
        raise AssertionError("the prefix-sum compaction differs from nonzero_static")
    return (_graph_ms(lambda: _compact(hit, model.max_pairs), 10), _graph_ms(per_frame, 10))


def phase_workloads(device, workdir):
    """The four selection workloads at ``benchmarks/workloads.py``'s
    defaults, then the window sweep, then the native C++ program."""
    import torch

    from molar_tpu_torch import convert
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, auto_window

    system = wl.synth_system(WL_ATOMS, WL_PROTEIN, WL_BOX)
    path = os.path.join(workdir, "workloads.xtc")
    t0 = time.perf_counter()
    wl.write_xtc(system, path, WL_FRAMES)
    t_write = time.perf_counter() - t0
    meta = path + ".meta"
    wl.write_native_meta(system, meta)

    _reset_launches()
    checks = {}
    for name in WL_STAGES:
        model, subset = convert.workload_from_numpy(name, system, device)
        cpu_model, _ = convert.workload_from_numpy(name, system, "cpu")
        window = auto_window(path, subset)
        t0 = time.perf_counter()
        host_windows = list(TrajectoryReader([path]).iter_windows(window, quantized=_wire(),
                                                                  subset=subset))
        t_decode = time.perf_counter() - t0
        wire_mb = sum(sum(a.nbytes for a in w[0]) if isinstance(w[0], tuple) else w[0].nbytes
                      for w in host_windows) / 1e6
        picks = sorted({0, len(host_windows) // 2, len(host_windows) - 1})
        dev_windows = [convert.transport_to_torch(host_windows[k], device) for k in picks]
        worst = {}
        t0 = time.perf_counter()
        for k, dev_window in zip(picks, dev_windows):
            for label, err in _workload_vs_cpu(
                    name, model, cpu_model, dev_window,
                    convert.transport_to_torch(host_windows[k], "cpu")).items():
                worst[label] = max(worst.get(label, 0), err)
        t_vs_cpu = time.perf_counter() - t0
        del host_windows
        no_sync_enqueue_ms = _no_sync_window(model, dev_windows[0])
        extra = {}
        if name == "contacts":
            extra["compact_prefix_sum_ms"], extra["compact_nonzero_static_ms"] = _compaction_ms(
                model, dev_windows[0])

        passes = []
        for _ in range(WL_REPEATS):
            frames, seconds, checks[name] = wl.run(name, system, path, window, device)
            passes.append(frames / seconds)
        if frames != WL_FRAMES or not all(np.isfinite(v) and v > 0
                                          for v in checks[name].values()):
            raise AssertionError(f"{name}: {frames} frames, check scalars {checks[name]}")
        wall_ms, enqueue_ms, by_stage, n_ops, top = _workload_window(model, dev_windows[0],
                                                                     WL_STAGES[name])
        prof_wall, prof_busy, _, _ = _device_profile(lambda: [model(*w) for w in dev_windows[:2]])
        n_win = dev_windows[0][1].shape[0]
        phase("workload", name=name, atoms=WL_ATOMS, protein=WL_PROTEIN, rows=len(subset),
              frames=frames, window=window, e2e_fps=[round(p, 3) for p in passes],
              e2e_fps_best=max(passes), e2e_fps_median=float(np.median(passes)),
              host_decode_s=t_decode, wire_mb=round(wire_mb, 3),
              window_wall_ms=wall_ms, window_host_enqueue_ms=enqueue_ms,
              window_device_ms=sum(by_stage.values()), device_ops=n_ops,
              device_ops_per_frame=n_ops / n_win,
              stage_device_ms=repr({k: round(v, 4) for k, v in by_stage.items()}),
              top_device_ops=repr(top), profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
              device_busy_share=prof_busy / prof_wall,
              checks=repr({k: round(v, 7) for k, v in checks[name].items()}),
              windows_vs_cpu=len(picks), max_diff_vs_cpu=repr(worst),
              vs_cpu_s=round(t_vs_cpu, 3), no_sync_window=True,
              no_sync_enqueue_ms=no_sync_enqueue_ms, **extra)
        del model, dev_windows
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the workloads path launched kernels {launches}")

    # The window sweep that sets auto_window's constants.
    for window in WL_SWEEP:
        fields = {}
        for name in ("ca_rmsd", "contacts"):
            fps = []
            for _ in range(WL_REPEATS):
                frames, seconds, _ = wl.run(name, system, path, window, device)
                fps.append(frames / seconds)
            fields[f"{name}_fps_best"] = max(fps)
            fields[f"{name}_fps_median"] = float(np.median(fps))
        phase("auto_window_sweep", window=window, frames=WL_FRAMES, **fields)
    torch.cuda.synchronize()

    # The native program, after every device pass.
    for name in WL_STAGES:
        native = wl.run_native(name, path, meta)
        bad = wl.native_mismatches(checks[name], native)
        phase("workload_native", name=name, native_fps=native["fps"], frames=native["frames"],
              native_checks=repr({k: native[k] for k in checks[name]}),
              checks=repr(checks[name]), rtol=wl.CHECK_RTOL, mismatches=len(bad))
        if bad or native["frames"] != WL_FRAMES:
            raise AssertionError(f"{name}: check scalars off the native program's: {bad}")
    phase("workloads_path", workloads=len(checks), frames=WL_FRAMES, write_s=round(t_write, 3),
          kernel_launches=launches, all_checks_passed=True)
    return system, path, meta

# ---------------------------------------------------------------- phase 10

# Queue depths of the window stream swept (windows decoded ahead of compute).
QUEUE_DEPTHS = (1, 2, 3, 4)


def _kabsch_iters() -> int:
    import inspect

    from molar_tpu_torch.ops.measure import kabsch

    return inspect.signature(kabsch).parameters["iters"].default


class _GraphWindow:
    """A window function replayed from a CUDA graph: full-size windows are
    copied into the captured inputs and replayed (the host enqueues a few
    copies and one launch); any other window runs eagerly."""

    def __init__(self, model, example):
        import torch

        self.model = model
        self.static = tuple(tuple(x.clone() for x in a) if isinstance(a, tuple) else a.clone()
                            for a in example)
        model(*self.static)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outs = model(*self.static)
        self.replays = 0

    @staticmethod
    def _flat(window):
        for a in window:
            yield from (a if isinstance(a, tuple) else (a,))

    def __call__(self, *window):
        mine, theirs = list(self._flat(self.static)), list(self._flat(window))
        if len(mine) != len(theirs) or any(a.shape != b.shape or a.dtype != b.dtype
                                           for a, b in zip(mine, theirs)):
            return self.model(*window)
        for a, b in zip(mine, theirs):
            a.copy_(b)
        self.graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in self.outs)


def _stream(path, window, fn, device, subset=None):
    """One pass of a window function over a file through ``WindowPipeline``
    -> (fps, the pipeline's host seconds by part, the per-window results)."""
    import torch

    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, WindowPipeline

    pipe = WindowPipeline(TrajectoryReader([path]), window, fn, device, quantized=_wire(),
                          subset=subset)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [res for _, res in pipe.run()]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    frames = sum(len(o[0]) for o in outs)
    return frames / seconds, dict(pipe.timings), outs


def _decode_s(path, window, subset, repeats=3):
    """Host seconds to read every window of a file (no device), best of
    ``repeats``."""
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in TrajectoryReader([path]).iter_windows(window, quantized=_wire(), subset=subset):
            pass
        best = min(best, time.perf_counter() - t0)
    return best


def _per_window_ms(timings):
    n = max(1, timings["windows"])
    return {k: round(v / n * 1e3, 3) for k, v in timings.items() if k != "windows"}


def phase_host_stream(device, args, headline_path, wl_system, wl_path):
    """The host side of the window stream, measured on this machine: the
    decode worker count, the wire form, the feeder's parts a window, CUDA
    graph replay of the window function, the headline's window size, and
    the headline's cell occupancies over the trajectory against its cap
    tiers, the queue depth, and how many of ``fit_rmsd``'s power iterations
    change its result. Every comparison is made inside this one process."""
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.io import xtc as io_xtc
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import estimate_caps, grid_dims_for
    from molar_tpu_torch.tasks import trajectory

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, masses = headline.make_system(ATOMS, PROTEIN, box.matrix)
    pidx = np.arange(PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(headline_path, box.inv, dims, pidx)
    ghost = convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF, headline.caps_for(*caps0, 0),
                               dims, device)
    ca_model, ca_rows = convert.workload_from_numpy("ca_rmsd", wl_system, device)
    com_model, com_rows = convert.workload_from_numpy("com_splits", wl_system, device)

    def headline_fps(window, repeats=3):
        out = None
        fps = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = headline.run(headline_path, ref, pmass, pidx, box, CUTOFF, dims, caps0, window,
                               device)
            torch.cuda.synchronize()
            fps.append(len(out[0]) / (time.perf_counter() - t0))
        return float(np.median(fps)), out

    # (a) Decode workers: the codec's threads a window, decode alone.
    cores = os.cpu_count() or 1
    shipped_workers = io_xtc.DECODE_WORKERS
    by_workers = {}
    try:
        for workers in sorted({1, 2, 4, 8, 16, cores}):
            io_xtc.DECODE_WORKERS = workers
            by_workers[workers] = (round(_decode_s(headline_path, WINDOW, None), 4),
                                   round(_decode_s(wl_path, 512, wl_system.protein), 4))
    finally:
        io_xtc.DECODE_WORKERS = shipped_workers
    phase("decode_workers", host_cpu_count=cores, shipped=shipped_workers, wire=repr(_wire()),
          headline=f"{args.frames} frames of {ATOMS} atoms, window {WINDOW}",
          subset=f"{WL_FRAMES} frames of {len(wl_system.protein)} rows, window 512",
          seconds_headline_subset_by_workers=repr(by_workers))

    # (b) The wire form: decode alone, then both streams end to end. The
    # results must not move: every form decodes to the same float32 frames.
    shipped_wire = trajectory.WIRE
    forms = ("delta", True, False)
    samples = {form: {k: [] for k in ("decode_headline_s", "decode_subset_s", "headline_fps",
                                      "com_splits_fps")} for form in forms}
    results = {}
    try:
        for _ in range(3):  # the forms in turns, so that no form owns a quiet moment
            for form in forms:
                trajectory.WIRE = form
                fps_h, results[form] = headline_fps(WINDOW, repeats=1)
                got = samples[form]
                got["headline_fps"].append(fps_h)
                got["com_splits_fps"].append(_stream(wl_path, 512, com_model, device, com_rows)[0])
                got["decode_headline_s"].append(_decode_s(headline_path, WINDOW, None, 1))
                got["decode_subset_s"].append(_decode_s(wl_path, 512, com_rows, 1))
    finally:
        trajectory.WIRE = shipped_wire
    by_wire = {form: {k: round(float(np.median(v)), 4) for k, v in got.items()}
               for form, got in samples.items()}
    results = {form: out[1:4] for form, out in results.items()}
    moved = sum(int(not np.array_equal(a, b)) for form in (True, False)
                for a, b in zip(results[form], results["delta"]))
    phase("wire_forms", shipped=repr(shipped_wire), results_moved=moved, by_form=repr(by_wire))
    if moved:
        raise AssertionError("the headline's results differ between wire forms")

    # The staging ring against ordinary memory: the host ms until a
    # non_blocking copy of one headline window's bytes returns.
    nbytes = WINDOW * ATOMS * trajectory.WIRE_BYTES[shipped_wire]
    ring = trajectory.StagingRing(1, pin=True)
    ring.begin()
    sources = {"ring": ring((nbytes,), np.uint8), "pageable": np.empty(nbytes, np.uint8)}
    start_ms = {}
    for label, a in sources.items():
        a[...] = 1
        t = torch.from_numpy(a)
        t.to(device, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            t.to(device, non_blocking=True)
        start_ms[label] = round((time.perf_counter() - t0) / 5 * 1e3, 4)
        torch.cuda.synchronize()
    pinned = torch.from_numpy(sources["ring"]).is_pinned()
    phase("staging", window_bytes=nbytes, ring_is_pinned=pinned, copy_start_ms=repr(start_ms))
    if not pinned:
        raise AssertionError("the staging ring's memory is not pinned")
    del ring, sources

    # (c) The feeder's and the consumer's parts a window, host clock.
    # (d) The same streams with the window function replayed from a CUDA
    # graph: does the decode thread get faster when the enqueueing thread
    # holds the interpreter lock for microseconds a window?
    for label, path, window, model, rows in (
            ("headline", headline_path, 16, ghost, None),
            ("headline", headline_path, WINDOW, ghost, None),
            ("ca_rmsd", wl_path, 16, ca_model, ca_rows),
            ("ca_rmsd", wl_path, 512, ca_model, ca_rows)):
        _stream(path, window, model, device, rows)
        eager = [_stream(path, window, model, device, rows) for _ in range(3)]
        fps, timings, outs = sorted(eager, key=lambda r: r[0])[1]
        phase("feeder", stream=label, window=window, wire=repr(_wire()), mode="eager",
              fps_median=fps, windows=timings["windows"],
              ms_per_window=repr(_per_window_ms(timings)))
        if window != 16:
            continue
        example = convert.transport_to_torch(next(iter(
            trajectory.TrajectoryReader([path]).iter_windows(window, quantized=_wire(),
                                                             subset=rows))), device)
        graphed = _GraphWindow(model, example)
        _stream(path, window, graphed, device, rows)
        replay = [_stream(path, window, graphed, device, rows) for _ in range(3)]
        gfps, gtimings, gouts = sorted(replay, key=lambda r: r[0])[1]
        same = all(torch.equal(a, b) for wa, wb in zip(outs, gouts) for a, b in zip(wa, wb))
        phase("feeder", stream=label, window=window, wire=repr(_wire()), mode="graph_replay",
              fps_median=gfps, windows=gtimings["windows"], replays=graphed.replays,
              ms_per_window=repr(_per_window_ms(gtimings)), results_equal_eager=same,
              decode_thread_s_eager=timings["decode"] + timings["pack"],
              decode_thread_s_graph=gtimings["decode"] + gtimings["pack"])
        if not same or not graphed.replays:
            raise AssertionError(f"{label}: the graph-replayed stream differs from the eager one")
        del graphed

    # (e) The headline's window size.
    by_window = {}
    for window in (16, 32, 64, 128):
        headline_fps(window, repeats=1)
        fps, out = headline_fps(window)
        by_window[window] = round(fps, 1)
        # The fit's products round by the batch they run in; the sets do not move.
        rmsd16, count16, check16 = results[shipped_wire]
        if (np.abs(out[1] - rmsd16).max() > 1e-5 or not np.array_equal(out[2], count16)
                or not np.array_equal(out[3], check16)):
            raise AssertionError(f"headline window {window}: results differ from window {WINDOW}")
    phase("headline_window_sweep", frames=args.frames, shipped=WINDOW,
          fps_median_by_window=repr(by_window))

    # (f) The headline's cell occupancies over the trajectory against the
    # cap tiers that frame 0 sizes.
    worst = np.zeros(3, np.int64)
    with XtcHandler(headline_path) as h:
        sampled = sorted({*range(0, h.n_frames, 8), h.n_frames - 1})
        for k in sampled:
            worst = np.maximum(worst, estimate_caps(h.read_frame(k).coords, box.inv, dims, pidx,
                                                    margin=1.0, round_to=1))
    tier0 = headline.caps_for(*caps0, 0)
    phase("headline_caps", frame0=caps0, worst_of_sampled_frames=tuple(int(v) for v in worst),
          frames_sampled=len(sampled), tier0=tier0,
          margin_needed=repr(tuple(round(float(w) / c, 3) for w, c in zip(worst, caps0))),
          tier0_holds=bool((worst <= np.array(tier0)).all()))

    # (g) The queue depth: windows decoded ahead of compute (the ring holds
    # one buffer more). The headline at its window, ca_rmsd at 512.
    shipped_depth = trajectory._QUEUE_DEPTH
    by_depth, moved = {}, 0
    want_ca = None
    try:
        for depth in QUEUE_DEPTHS:
            trajectory._QUEUE_DEPTH = depth
            fps_h, out = headline_fps(WINDOW)
            moved += sum(int(not np.array_equal(a, b))
                         for a, b in zip(out[1:4], results[shipped_wire]))
            fps_ca = []
            for _ in range(3):
                frames, seconds, chk = wl.run("ca_rmsd", wl_system, wl_path, 512, device)
                fps_ca.append(frames / seconds)
                want_ca = chk["check"] if want_ca is None else want_ca
                moved += int(chk["check"] != want_ca)
            by_depth[depth] = (round(fps_h, 1), round(float(np.median(fps_ca)), 1))
    finally:
        trajectory._QUEUE_DEPTH = shipped_depth
    phase("queue_depth", shipped=shipped_depth, ring_buffers="depth + 1", results_moved=moved,
          headline_window=WINDOW, ca_rmsd_window=512,
          fps_median_headline_ca_rmsd_by_depth=repr(by_depth))
    if moved:
        raise AssertionError("results differ between queue depths")

    # (h) fit_rmsd's power iterations.
    fit_rmsd_iterations(device, headline_path, ref, pmass, wl_system, wl_path, ca_rows)


def fit_rmsd_iterations(device, headline_path, ref, pmass, wl_system, wl_path, ca_rows):
    """After how many power iterations ``fit_rmsd``'s rotation (a function
    of the quaternion) stops changing, frame by frame, on every frame of
    the headline's file and of ca_rmsd's: bit for bit, and to within 1e-6
    of the shipped count's rotation."""
    import torch

    from molar_tpu_torch import convert
    from molar_tpu_torch.tasks import trajectory

    ca_ref = torch.as_tensor(wl_system.coords[wl_system.ca], device=device)
    ca_mass = torch.as_tensor(wl_system.masses[wl_system.ca], device=device)
    streams = {
        "headline": (headline_path, WINDOW, None, torch.as_tensor(ref, device=device),
                     torch.as_tensor(pmass, device=device), slice(0, PROTEIN)),
        "ca_rmsd": (wl_path, 512, ca_rows, ca_ref, ca_mass, slice(None)),
    }
    for label, (path, window, rows, sref, smass, cols) in streams.items():
        exact, close = [], []
        for w in trajectory.TrajectoryReader([path]).iter_windows(window, quantized=_wire(),
                                                                 subset=rows):
            coords = trajectory.decode_window_coords(convert.transport_to_torch(w, device)[0])
            e, c = _kabsch_convergence(coords[:, cols], sref, smass)
            exact.append(e)
            close.append(c)
        exact, close = (torch.cat(x).cpu().numpy() for x in (exact, close))
        shipped = _kabsch_iters()
        phase("fit_rmsd_iterations", stream=label, frames=len(exact), shipped=shipped,
              unchanged_after_max=int(exact.max()), unchanged_after_median=float(np.median(exact)),
              frames_still_changing_at_shipped=int((exact >= shipped).sum()),
              within_1e6_after_max=int(close.max()),
              within_1e6_after_median=float(np.median(close)))


def _kabsch_convergence(mobile, ref, masses):
    """For each frame, the number of power iterations after which
    ``ops.measure.kabsch``'s rotation no longer changes bit for bit, and
    after which it stays within 1e-6 of the rotation at the shipped count
    (the inputs as ``fit_rmsd`` forms them)."""
    import torch

    from molar_tpu_torch.ops.measure import center, kabsch

    c1 = mobile - center(mobile, masses)[..., None, :]
    target = ref.expand(mobile.shape)
    c2 = target - center(target, masses)[..., None, :]
    final = kabsch(c1, c2, masses)
    exact = torch.zeros(mobile.shape[0], dtype=torch.int64, device=mobile.device)
    close = torch.zeros_like(exact)
    prev = kabsch(c1, c2, masses, iters=0)
    for n in range(1, _kabsch_iters() + 1):
        rot = kabsch(c1, c2, masses, iters=n)
        exact = torch.where((rot != prev).flatten(1).any(dim=1), n, exact)
        close = torch.where((prev - final).abs().flatten(1).amax(dim=1) > 1e-6, n, close)
        prev = rot
    return exact, close


# ---------------------------------------------------------------- phase 11

# The interval and sweep arithmetic of one (atom, slice, neighbour) triple
# of ``ops/sasa_lr._exposed_arcs``, counted from its code: the neighbour's
# circle (6), the three placement tests (6), the half angle (10: products,
# quotient, clip, arccos), the two interval ends and their wrap-split into
# two slots (14), and the sweep over those two slots (12: running maximum,
# maximum, difference, clamp, sum). The sort is not counted: a bound owes
# the union, not a way to it.
SASA_FLOPS_PER_TRIPLE = 48
SASA_FRAMES = 64
SASA_REPEATS = 3
SASA_STAGES = ("sasa.decode", "sasa.lists", "sasa.arcs", "sasa.residues")
# Per-residue areas, the card against the CPU, nm^2: both are float32;
# ``atan2`` and ``acos`` differ by ulps between the two, over 4 atoms.
SASA_ATOL = 2e-5


def phase_sasa(device, workdir, system, meta):
    """The SASA workload on phase 9's system: 64 frames (the reference's
    default depth), 4,000 rows x 32 slices, lists rebuilt every frame."""
    import torch

    from molar_tpu_torch import convert
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.ops import sasa_lr
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

    path = os.path.join(workdir, "sasa.xtc")
    wl.write_xtc(system, path, SASA_FRAMES)
    model, subset = convert.workload_from_numpy("sasa", system, device)
    cpu_model, _ = convert.workload_from_numpy("sasa", system, "cpu")
    window = wl.SASA_WINDOW
    host_windows = list(TrajectoryReader([path]).iter_windows(window, quantized=_wire(),
                                                              subset=subset))
    dev_windows = [convert.transport_to_torch(w, device) for w in host_windows]

    # The whole stream at tier 0: no overflow, and the per-frame results.
    _reset_launches()
    outs = [model(*w) for w in dev_windows]
    areas = torch.cat([o[0] for o in outs])
    overflowed = int(torch.cat([o[1] for o in outs]).sum())
    if overflowed or areas.shape != (SASA_FRAMES, len(subset) // 4):
        raise AssertionError(f"sasa: {overflowed} frames overflow tier 0, areas {areas.shape}")

    # The card against the CPU on the first and the last window.
    t0 = time.perf_counter()
    worst = 0.0
    for k in (0, len(host_windows) - 1):
        want, want_ofl = cpu_model(*convert.transport_to_torch(host_windows[k], "cpu"))
        worst = max(worst, float((outs[k][0].cpu() - want).abs().max()))
        if want_ofl.any():
            raise AssertionError("sasa: the CPU run overflows tier 0")
    t_vs_cpu = time.perf_counter() - t0
    if worst > SASA_ATOL:
        raise AssertionError(f"sasa: per-residue areas differ from the CPU run by {worst} nm^2")

    # The element budget of a block: one resident window at each.
    shipped_block = sasa_lr.BLOCK_ELEMS
    by_block = {}
    try:
        for log2 in (24, 25, 26, 27, 28, 29):
            sasa_lr.BLOCK_ELEMS = 1 << log2
            torch.cuda.reset_peak_memory_stats()
            ms = _cuda_ms(lambda: model(*dev_windows[0]), 2)
            by_block[log2] = (round(ms / window, 3),
                              round(torch.cuda.max_memory_allocated() / 2**30, 2))
    finally:
        sasa_lr.BLOCK_ELEMS = shipped_block
    phase("sasa_block_sweep", shipped_log2=shipped_block.bit_length() - 1, window=window,
          ms_per_frame_and_peak_gib_by_log2_elems=repr(by_block))

    # Timed passes through the user's entry point, then the window size.
    passes, checks = [], None
    for _ in range(SASA_REPEATS):
        frames, seconds, checks = wl.run("sasa", system, path, 0, device)
        passes.append(frames / seconds)
    if frames != SASA_FRAMES or not np.isfinite(checks["check"]) or checks["check"] <= 0:
        raise AssertionError(f"sasa: {frames} frames, check {checks}")
    # One pass a size: the card bounds this stream (106-113 fps at every
    # size when swept with three passes a size).
    by_window = {}
    for w in (4, 8, 16, 32, 64):
        frames_w, seconds_w, _ = wl.run("sasa", system, path, w, device)
        by_window[w] = round(frames_w / seconds_w, 2)
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the sasa path launched kernels {launches}")

    torch.cuda.reset_peak_memory_stats()
    wall_ms, enqueue_ms, by_stage, n_ops, top = _workload_window(model, dev_windows[0],
                                                                 SASA_STAGES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prof_wall, prof_busy, _, _ = _device_profile(lambda: [model(*w) for w in dev_windows[:2]])
    # No host sync in a window: a short one, so that the graph's private
    # pool stays small.
    short = convert.transport_to_torch(next(iter(TrajectoryReader([path]).iter_windows(
        2, quantized=_wire(), subset=subset))), device)
    no_sync_enqueue_ms = _no_sync_window(model, short)
    if not torch.allclose(model(*short)[0], areas[:2], rtol=0, atol=1e-6):
        raise AssertionError("sasa: a 2-frame window differs from the stream's first frames")

    # The bound of ``sasa`` (lists in, areas out) and of the whole window
    # function (rows in, per-residue areas out) from this window's data:
    # operations a triple over the triples the lists really hold.
    coords = decode_window_coords(dev_windows[0][0])
    nbr, _ = sasa_lr.neighbor_lists_device(coords, model.radii, model.extents, model.dims,
                                           model.cell_cap, model.k_cap)
    pairs = int((nbr >= 0).sum())
    triples = pairs * model.n_slices
    sasa_ms = _cuda_ms(lambda: sasa_lr.sasa(coords, model.radii, nbr, n_slices=model.n_slices), 2)
    lists_ms = _cuda_ms(lambda: sasa_lr.neighbor_lists_device(
        coords, model.radii, model.extents, model.dims, model.cell_cap, model.k_cap), 2)
    bound = _bound(coords.numel() * 4 + model.radii.numel() * 4 + nbr.numel() * 4
                   + coords.numel() // 3 * 4, triples * SASA_FLOPS_PER_TRIPLE)
    whole = _bound(coords.numel() * 4 + model.radii.numel() * 4 + areas[:window].numel() * 4,
                   triples * SASA_FLOPS_PER_TRIPLE)
    del nbr, coords

    phase("sasa_path", atoms=WL_ATOMS, rows=len(subset), slices=model.n_slices,
          frames=SASA_FRAMES, window=window, wire=repr(_wire()), dims=model.dims,
          k0=model.k0, cell0=model.cell0, k_cap=model.k_cap, cell_cap=model.cell_cap, tier=0,
          frames_overflowed_tier0=overflowed,
          e2e_fps=[round(p, 3) for p in passes], e2e_fps_best=max(passes),
          e2e_fps_median=float(np.median(passes)), fps_by_window=repr(by_window),
          window_wall_ms=wall_ms, window_host_enqueue_ms=enqueue_ms,
          window_device_ms=sum(by_stage.values()),
          device_ms_per_frame=sum(by_stage.values()) / window,
          stage_device_ms_per_frame=repr({k: round(v / window, 4) for k, v in by_stage.items()}),
          device_ops_per_frame=n_ops / window, top_device_ops=repr(top),
          profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, peak_memory_gib=round(peak_gib, 3),
          windows_vs_cpu=2, max_abs_diff_vs_cpu=worst, atol=SASA_ATOL,
          vs_cpu_s=round(t_vs_cpu, 3), no_sync_window=True,
          no_sync_enqueue_ms=no_sync_enqueue_ms,
          neighbour_pairs_per_frame=pairs / window, triples_per_frame=triples / window,
          flops_per_triple=SASA_FLOPS_PER_TRIPLE, sasa_ms_per_frame=sasa_ms / window,
          lists_ms_per_frame=lists_ms / window,
          sasa_bound_ms_per_frame=bound["bound_ms"] / window, sasa_bound_by=bound["bound_by"],
          sasa_share_of_bound=bound["bound_ms"] / sasa_ms,
          window_fn_bound_ms_per_frame=whole["bound_ms"] / window,
          window_fn_share_of_bound=whole["bound_ms"] / sum(by_stage.values()),
          check=checks["check"], kernel_launches=launches)

    # The native program on the same file and sidecar, after every device pass.
    native = wl.run_native("sasa", path, meta)
    bad = wl.native_mismatches(checks, native)
    phase("workload_native", name="sasa", native_fps=native["fps"], frames=native["frames"],
          native_checks=repr({k: native[k] for k in checks}), checks=repr(checks),
          rtol=wl.CHECK_RTOL, mismatches=len(bad))
    if bad or native["frames"] != SASA_FRAMES:
        raise AssertionError(f"sasa: check scalar off the native program's: {bad}")


# ---------------------------------------------------------------- phase 12

# benchmarks/workloads.py's membrane rows: name -> (lipids a leaflet side,
# frames): membrane_dev 72 lipids x 64 frames, membrane_large 4,608 lipids
# (27,648 atoms) x 32 frames. 3 timed passes; the window sizes and the
# chunk budgets swept; the engine sweep's sizes (nx = ny).
MEMBRANE_SYSTEMS = {"membrane_dev": (6, 64), "membrane_large": (48, 32)}
MEMBRANE_REPEATS = 3
MEMBRANE_WINDOWS = (4, 8, 16, 32, 64)
MEMBRANE_BLOCKS = (24, 25, 26, 27, 28)
MEMBRANE_ENGINE_SIDES = (6, 12, 24, 48)
MEMBRANE_STAGES = ("membrane.unwrap_markers", "membrane.patches", "membrane.normals",
                   "membrane.smooth", "membrane.smooth.fit", "membrane.smooth.voronoi",
                   "membrane.order")
# Operations of the window function, counted from membrane/device.py's code
# (float operations and compares; gathers and the top-K selection not):
# a head pair of the patch search (difference 3, orthorhombic image 12,
# squared distance 5, cutoff 1, mask 1); a (lipid, vertex, plane) triple of
# the Voronoi vertex test (2 products, sum, difference, compare, or, all);
# a vertex (plane pair) of a lipid's cell (determinant 3, parallel test 2,
# guard 1, the two coordinates 8, its flags 4); an (on-plane vertex,
# plane) of the edge extremes (tangent 4, mask 2, min and max 2); a patch
# slot of the fit (displacement and image 15, local frame 15, design row
# and masks 11, normal equations 84) and of the normal seeding (2 passes of
# 13); and a lipid's own arithmetic (local frame and inverse ~60, Cholesky
# ~150, curvature and normal ~40, the rest ~50) plus 45 a plane (endpoints,
# lift, area).
MEMBRANE_OPS = {"pair": 23, "triple": 7, "vertex": 18, "edge": 8, "slot": 125 + 26,
                "lipid": 300, "plane": 45}


def _membrane_flat(outs):
    """A membrane window's output dict as a tuple of tensors, in key order."""
    flat = []
    for k in sorted(outs):
        if isinstance(outs[k], dict):
            flat.extend(t for sp in sorted(outs[k]) for t in outs[k][sp])
        else:
            flat.append(outs[k])
    return tuple(flat)


def _membrane_work(dev, coords):
    """This window's operations and bytes of the window function: the real
    patch counts of every lipid (min image over the head markers on the
    card, frame by frame) size its Voronoi and fit work."""
    import torch

    spec, L = dev.spec, dev.n_lipids
    heads_rows = torch.as_tensor(spec.head[0].astype(np.int64), device=coords.device)
    ext = torch.as_tensor(np.diag(dev.build_box).astype(np.float32), device=coords.device)
    c2 = float(np.float32(spec.options.cutoff**2))
    ops = 0
    for f in range(coords.shape[0]):
        h = coords[f, heads_rows]
        d = h[None, :, :] - h[:, None, :]
        d = d - ext * torch.round(d / ext)
        n = ((d * d).sum(-1) <= c2).sum(1).double() - 1
        n = n.clamp(max=dev.patch_cap)
        P = n + 4
        M = P * (P - 1) / 2
        ops += float(L * L * MEMBRANE_OPS["pair"] + (M * P).sum() * MEMBRANE_OPS["triple"]
                     + M.sum() * MEMBRANE_OPS["vertex"] + (P * (P - 1)).sum() * MEMBRANE_OPS["edge"]
                     + n.sum() * MEMBRANE_OPS["slot"] + L * MEMBRANE_OPS["lipid"]
                     + P.sum() * MEMBRANE_OPS["plane"])
    K = dev.patch_cap
    out_bytes = L * (1 + 3 * 4 + 2 * 12 + 4 + 5 * K) + 1 + sum(
        len(lids) * (tl.shape[1] - 2) * 4 for sp, lids in spec.sp_lipids.items()
        for tl, _ in spec.sp_tails[sp])
    nbytes = coords.shape[0] * (coords.shape[1] * 12 + 2 * 36 + out_bytes)
    return ops, nbytes


def _membrane_system(device, workdir, label, side, n_frames, window):
    """One membrane system through the whole check: stream passes, sweeps,
    stages, the card against the CPU, no sync, bound, native."""
    import torch

    from molar_tpu_torch import convert
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.membrane import MembraneDevice
    from molar_tpu_torch.membrane import device as mdev
    from molar_tpu_torch.membrane.device import to_numpy
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

    from torch_scenes import membrane_diffs, membrane_within_bars

    bilayer = wl.synth_bilayer(side, side)
    spec = bilayer.spec
    path = os.path.join(workdir, f"{label}.xtc")
    wl.write_membrane_xtc(bilayer, path, n_frames)
    t0 = time.perf_counter()
    dev = MembraneDevice(spec, bilayer.coords, bilayer.box, engine="device", device=device)
    t_build = time.perf_counter() - t0
    cpu = MembraneDevice(spec, bilayer.coords, bilayer.box, engine="cpu")
    if dev.patch_cap != cpu.patch_cap or dev.engine_resolved != "device":
        raise AssertionError(f"{label}: patch caps {dev.patch_cap} / {cpu.patch_cap}")

    # The timed passes through the user's entry point (engine "device").
    wl.run_membrane(dev, path, window)
    passes, checks = [], None
    for _ in range(MEMBRANE_REPEATS):
        frames, seconds, checks = wl.run_membrane(dev, path, window)
        passes.append(frames / seconds)
    if frames != n_frames:
        raise AssertionError(f"{label}: {frames} frames")

    # The window size, 3 passes each, as far as memory allows.
    by_window = {}
    for w in MEMBRANE_WINDOWS:
        if w > n_frames:
            continue
        try:
            fps = [f / s for f, s, _ in (wl.run_membrane(dev, path, w)
                                         for _ in range(MEMBRANE_REPEATS))]
            by_window[w] = (round(max(fps), 2), round(float(np.median(fps)), 2))
        except torch.cuda.OutOfMemoryError:
            by_window[w] = "out of memory"
        torch.cuda.empty_cache()
    phase("membrane_window_sweep", system=label, lipids=dev.n_lipids, frames=n_frames,
          shipped=window, fps_best_median_by_window=repr(by_window))

    host_windows = list(TrajectoryReader([path]).iter_windows(window, quantized=_wire(),
                                                              subset=spec.subset))
    dev_windows = [convert.transport_to_torch(w, device) for w in host_windows]
    outs = [to_numpy(dev.window_fn(*w)) for w in dev_windows]
    overflowed = int(sum(o["overflow"].sum() for o in outs))
    if overflowed:
        raise AssertionError(f"{label}: {overflowed} frames overflow patch_cap {dev.patch_cap}")

    # The card against the CPU on the first and the last window.
    t0 = time.perf_counter()
    worst = {}
    for k in sorted({0, len(host_windows) - 1}):
        want = to_numpy(cpu.window_fn(*convert.transport_to_torch(host_windows[k], "cpu")))
        diffs = membrane_diffs(want, outs[k], spec.sp_lipids)
        if not membrane_within_bars(diffs):
            raise AssertionError(f"{label}: window {k} on the card differs from the CPU: {diffs}")
        worst = {key: max(worst.get(key, 0), v) for key, v in diffs.items()}
    t_vs_cpu = time.perf_counter() - t0

    # The element budget of a chunk: one resident window at each.
    by_block = {}
    shipped_block = mdev.BLOCK_ELEMS
    if label == "membrane_large":
        try:
            for log2 in MEMBRANE_BLOCKS:
                mdev.BLOCK_ELEMS = 1 << log2
                torch.cuda.reset_peak_memory_stats()
                try:
                    ms = _cuda_ms(lambda: dev.window_fn(*dev_windows[0]), 2)
                    by_block[log2] = (round(ms / window, 3),
                                      round(torch.cuda.max_memory_allocated() / 2**30, 2))
                except torch.cuda.OutOfMemoryError:
                    by_block[log2] = "out of memory"
                torch.cuda.empty_cache()
        finally:
            mdev.BLOCK_ELEMS = shipped_block
        phase("membrane_block_sweep", system=label, shipped_log2=shipped_block.bit_length() - 1,
              window=window, ms_per_frame_and_peak_gib_by_log2_elems=repr(by_block))

    # One resident window by stage, the busy share, peak memory.
    torch.cuda.reset_peak_memory_stats()
    wall_ms, enqueue_ms, by_stage, n_ops, top = _workload_window(dev.window_fn, dev_windows[0],
                                                                 MEMBRANE_STAGES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prof_wall, prof_busy, _, _ = _device_profile(
        lambda: [dev.window_fn(*w) for w in dev_windows[:2]])
    no_sync_enqueue_ms = _no_sync_window(lambda *w: _membrane_flat(dev.window_fn(*w)),
                                         dev_windows[0])

    # The bound of the window function (rows in, outputs out) from this
    # window's own patch counts.
    flops, nbytes = _membrane_work(dev, decode_window_coords(dev_windows[0][0]))
    bound = _bound(nbytes, flops)
    device_ms = sum(by_stage.values())
    stage_ms = {k: round(by_stage.get(k, 0.0) / window, 4)
                for k in (*MEMBRANE_STAGES, "membrane.smooth.scatter", "membrane.curv_smooth",
                          "outside")}
    phase("membrane_path", system=label, lipids=dev.n_lipids, atoms=len(spec.subset),
          frames=n_frames, window=window, wire=repr(_wire()), patch_cap=dev.patch_cap,
          frames_overflowed=overflowed, build_s=round(t_build, 3),
          e2e_fps=[round(p, 3) for p in passes], e2e_fps_best=max(passes),
          e2e_fps_median=float(np.median(passes)),
          window_wall_ms=wall_ms, window_host_enqueue_ms=enqueue_ms, window_device_ms=device_ms,
          device_ms_per_frame=device_ms / window, stage_device_ms_per_frame=repr(stage_ms),
          device_ops_per_frame=n_ops / window, top_device_ops=repr(top),
          profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, peak_memory_gib=round(peak_gib, 3),
          windows_vs_cpu=len({0, len(host_windows) - 1}), worst_vs_cpu=repr(worst),
          vs_cpu_s=round(t_vs_cpu, 3), no_sync_window=True,
          no_sync_enqueue_ms=no_sync_enqueue_ms, scatter="gather over a reverse-slot table, "
          "no atomics (replay equal)", ops_per_frame=flops / window,
          bytes_per_frame=nbytes / window, bound_ms_per_frame=bound["bound_ms"] / window,
          bound_by=bound["bound_by"], share_of_bound=bound["bound_ms"] / device_ms,
          checks=repr(checks))

    # The native program on the same decoded frames, after every device pass.
    (decoded, _, _, _, _), = TrajectoryReader([path]).iter_windows(n_frames)
    native = wl.run_native_membrane(spec, bilayer.box, decoded, workdir)
    bad = wl.membrane_mismatches(checks, native)
    phase("membrane_native", system=label, native_fps=native["fps"], frames=native["frames"],
          native_checks=repr({k: native[k] for k in checks}), checks=repr(checks),
          tol=repr(wl.MEMBRANE_TOL), mismatches=len(bad))
    if bad or native["frames"] != n_frames:
        raise AssertionError(f"{label}: check scalars off the native program's: {bad}")


def phase_membrane_engine(device):
    """The crossover the engine's floor comes from: one window of the
    shipped size at each size, torch on the CPU (its threads printed)
    against the card, host clock around ``compute_window``."""
    import torch

    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.membrane import MembraneDevice
    from molar_tpu_torch.tasks import engine

    window = wl.MEMBRANE_WINDOW
    rows = []
    for side in MEMBRANE_ENGINE_SIDES:
        b = wl.synth_bilayer(side, side)
        frames = b.frames(window)[:, b.spec.subset]
        card = MembraneDevice(b.spec, b.coords, b.box, engine="device", device=device)
        cpu = MembraneDevice(b.spec, b.coords, b.box, engine="cpu")

        def timed(dev, n):
            sec = []
            for _ in range(n):
                t0 = time.perf_counter()
                dev.compute_window(frames)
                sec.append(time.perf_counter() - t0)
            return float(np.median(sec))

        timed(card, 1)
        card_s = timed(card, 3)
        cpu_s = timed(cpu, 1)  # (nothing to warm on the CPU: no compile, no graph)
        work = card._per_frame_flops() * window
        rows.append((work, cpu_s, card_s))
        phase("membrane_engine", lipids=card.n_lipids, window=window, work=work,
              cpu_fps=window / cpu_s, card_fps=window / card_s,
              winner="cpu" if cpu_s < card_s else "device",
              pick_engine=engine.pick_engine(card._per_frame_flops(), window),
              cpu_threads=torch.get_num_threads())
    cpu_wins = [w for w, c, g in rows if c < g]
    card_wins = [w for w, c, g in rows if c >= g]
    if not card_wins:
        raise AssertionError("the CPU beats the card at every size of the engine sweep")
    above = min(card_wins)
    below = max((w for w in cpu_wins if w < above), default=None)
    floor = above / 2 if below is None else (below * above) ** 0.5
    phase("membrane_engine_floor", shipped=engine.DEVICE_FLOPS_FLOOR, from_sweep=floor,
          cpu_wins_up_to=below, card_wins_from=above,
          shipped_agrees=all((engine.pick_engine(w / window, window) == "device") == (c >= g)
                             for w, c, g in rows))


def phase_membrane(device, workdir):
    """The membrane path on both of the reference's systems, then the
    engine sweep. No CUDA kernel of the port runs on this path."""
    from molar_tpu_torch import workloads as wl

    _reset_launches()
    for label, (side, n_frames) in MEMBRANE_SYSTEMS.items():
        _membrane_system(device, workdir, label, side, n_frames,
                         min(wl.MEMBRANE_WINDOW, n_frames))
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the membrane path launched kernels {launches}")
    phase_membrane_engine(device)


# ---------------------------------------------------------------- phase 13

# The selection path: the headline's rows labelled as a solvated protein and
# counted a frame by a WindowAnalysisTask. (a) the first hydration shell,
# (a') the headline's own search (every atom a source), (b) a slab of water,
# (c) a sphere round the box centre, (d) the CA atoms (static tier).
SEL_TEXTS = {
    "a_shell": "name OW and within 0.5 pbc of protein",
    "a_headline": "within 0.5 pbc of protein",
    "b_slab": "resname SOL and 2.0 < z < 4.0",
    "c_sphere": "within 1.0 pbc of [5.0, 5.0, 5.0]",
    "d_ca": "name CA",
}
SEL_TIERS = {"a_shell": "device", "a_headline": "device", "b_slab": "device",
             "c_sphere": "device", "d_ca": "static"}
# The host tier's cost at full width: a dynamic ``same`` over 3 frames.
SEL_HOST_TEXT = "same residue as (name OW and within 0.35 pbc of protein)"
SEL_HOST_FRAMES = 3
SEL_REPEATS = 3
# Back-to-back calls a node's host enqueue is averaged over (a few launches
# each: far from filling the launch queue).
SEL_ENQUEUE_CALLS = 5


def _selection_task():
    """A ``WindowAnalysisTask`` that counts :data:`SEL_TEXTS` a frame: per
    frame and selection the count, the uint32 checksum ``sum(idx + 1)`` and
    the overflow flag, (B, 5, 3) int64 a window. ``accumulate`` keeps each
    window's result on the card; ``post_process`` reads them all in one
    copy and refuses an overflow."""
    import torch

    from molar_tpu_torch.selection import FrameSelection
    from molar_tpu_torch.tasks.trajectory import AnalysisError, WindowAnalysisTask

    class SelectionCounts(WindowAnalysisTask):
        task_name = "selection counts"

        def build(self, system):
            n, dev = system.n_atoms, self.device
            self.system = system
            self.sels = {k: FrameSelection(text, system.topology, system.state, device=dev)
                         for k, text in SEL_TEXTS.items()}
            ids1 = torch.arange(1, n + 1, device=dev)
            static = {}
            for k, fs in self.sels.items():
                if fs.tier == "static":
                    static[k] = torch.zeros(n, dtype=torch.bool, device=dev)
                    static[k][torch.as_tensor(fs.static_idx, device=dev)] = True
            self.ids, self.pending = [], []

            def window_fn(coords, boxes, invs):
                b = coords.shape[0]
                out = []
                for k, fs in self.sels.items():
                    if k in static:
                        masks = static[k].expand(b, n)
                        ofl = torch.zeros(b, dtype=torch.bool, device=dev)
                    else:
                        masks, ofl = fs.compiled(coords, boxes, invs)
                    out.append(torch.stack([masks.sum(1), (ids1 * masks).sum(1) & 0xFFFFFFFF,
                                            ofl.long()], 1))
                return torch.stack(out, 1)

            self.window_fn = window_fn
            return window_fn

        def accumulate(self, frame_ids, results):
            self.ids.append(np.asarray(frame_ids))
            self.pending.append(results)

        def post_process(self):
            r = torch.cat(self.pending).cpu().numpy()
            if r[:, :, 2].any():
                raise AnalysisError(f"selection search overflowed at tier 0: "
                                    f"{dict(zip(SEL_TEXTS, r[:, :, 2].sum(0).tolist()))}")
            self.results = r[:, :, :2]
            self.frame_ids = np.concatenate(self.ids)

    return SelectionCounts


def _count_check(idx) -> tuple:
    idx = np.asarray(idx, np.int64)
    return len(idx), int((idx + 1).sum()) % 2**32


def phase_selection(device, args, workdir, headline_path, ghost, dodeca):
    """Phase 13: the selection language on the headline's trajectory."""
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.io.gro import write_gro
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.selection import FrameSelection, SelectionExpr
    from molar_tpu_torch.tasks.trajectory import (TrajectoryReader, auto_window,
                                                  decode_window_coords)

    from torch_scenes import dodecahedron

    top = headline.label_topology(ATOMS, PROTEIN)
    with XtcHandler(headline_path) as h:
        frame0 = h.read_frame(0)
    gro = os.path.join(workdir, "conf.gro")
    t0 = time.perf_counter()
    write_gro(gro, top, State(coords=frame0.coords, box=frame0.box))
    t_gro = time.perf_counter() - t0
    window = auto_window(headline_path)
    Task = _selection_task()

    # The path: the counts to 0, the user's entry point, 3 passes.
    _reset_launches()
    passes, stream_fps = [], []
    for _ in range(SEL_REPEATS):
        task = Task()
        t0 = time.perf_counter()
        n = task.run(["-f", gro, headline_path], device=device)
        torch.cuda.synchronize()
        passes.append(n / (time.perf_counter() - t0))
        stream_fps.append(n / task.timings["stream"])
    launches = _launches()
    tiers = {k: fs.tier for k, fs in task.sels.items()}
    ghost_nodes = sum(fs.compiled.ghost_nodes for fs in task.sels.values() if fs.compiled)
    n_windows = SEL_REPEATS * -(-args.frames // window)
    if tiers != SEL_TIERS or task.window != window:
        raise AssertionError(f"selection path: tiers {tiers}, window {task.window}")
    if (launches["cell_bins"] != ghost_nodes * n_windows
            or launches["within_ghost"] != ghost_nodes * n_windows or launches["within_rows"]):
        raise AssertionError(f"selection path: launches {launches} for {n_windows} windows of "
                             f"{ghost_nodes} within nodes: expected one cell_bins and one "
                             f"within_ghost a node a window, no within_rows")
    ids, res = task.frame_ids, task.results
    if not np.array_equal(ids, np.arange(args.frames)):
        raise AssertionError(f"selection stream returned frames {ids[:4]}... ({len(ids)})")
    keys = list(SEL_TEXTS)

    # (a') against the main path, frame by frame.
    gids, _, gcount, gcheck = ghost
    a1 = keys.index("a_headline")
    vs_main = int((res[:, a1, 0] != gcount).sum() + (res[:, a1, 1] != gcheck).sum())

    # (a)-(c) on frames 0 / mid / last against the host evaluator.
    system = task.system
    vs_host, t_host = 0, 0.0
    for f in sorted({0, args.frames // 2, args.frames - 1}):
        with XtcHandler(headline_path) as h:
            fr = h.read_frame(f)
        st = State(coords=fr.coords, box=fr.box)
        for k in ("a_shell", "b_slab", "c_sphere", "d_ca"):
            t0 = time.perf_counter()
            want = _count_check(SelectionExpr(SEL_TEXTS[k]).apply(system.topology, st))
            t_host += time.perf_counter() - t0
            vs_host += int(tuple(res[f, keys.index(k)]) != want)

    # eval_window on the first window against the task's results.
    first = next(TrajectoryReader([headline_path]).iter_windows(window))
    masks = task.sels["a_shell"].eval_window(first[0], first[1], first[2])
    a0 = keys.index("a_shell")
    vs_eval = sum(_count_check(np.flatnonzero(m)) != tuple(res[f, a0])
                  for f, m in enumerate(masks))

    # A resident window: no host sync, and the time by node.
    dev_window = convert.transport_to_torch(
        next(TrajectoryReader([headline_path]).iter_windows(window, quantized=_wire())), device)
    coords = decode_window_coords(dev_window[0])
    _, boxes, invs = dev_window
    enqueue_ms = _no_sync_window(lambda c, b, i: (task.window_fn(c, b, i),), (coords, boxes, invs))
    by_node = {}
    for k, fs in task.sels.items():
        if fs.compiled is None:
            continue
        fs.compiled(coords, boxes, invs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SEL_ENQUEUE_CALLS):
            fs.compiled(coords, boxes, invs)
        host_ms = (time.perf_counter() - t0) * 1e3 / SEL_ENQUEUE_CALLS
        torch.cuda.synchronize()
        by_node[k] = {"host_enqueue_ms": round(host_ms, 4),
                      "device_ms": round(_graph_ms(lambda: fs.compiled(coords, boxes, invs), 3),
                                         4)}
    window_device_ms = _graph_ms(lambda: task.window_fn(coords, boxes, invs), 3)
    prof_wall, prof_busy, prof_top, _ = _device_profile(
        lambda: [task.window_fn(coords, boxes, invs) for _ in range(2)])

    # The host tier at full width.
    fs_host = FrameSelection(SEL_HOST_TEXT, system.topology, system.state, device=device)
    t0 = time.perf_counter()
    host_masks = fs_host.eval_window(first[0][:SEL_HOST_FRAMES], first[1][:SEL_HOST_FRAMES],
                                     first[2][:SEL_HOST_FRAMES])
    host_fps = SEL_HOST_FRAMES / (time.perf_counter() - t0)

    # The dodecahedron's first window through (a'): the correction route.
    dpath, dcaps0, dcount, dcheck = dodeca
    dbox = PeriodicBox(dodecahedron(DODECA_D))
    with XtcHandler(dpath) as h:
        d0 = h.read_frame(0)
    cells = headline.caps_for(*dcaps0, 0)[2]
    fs_d = FrameSelection(SEL_TEXTS["a_headline"], top, State(coords=d0.coords, box=d0.box),
                          cutoff_params={"max_tgt_cells": cells}, device=device)
    if grid_dims_for(dbox, CUTOFF) != DODECA_DIMS or fs_d.compiled.ghost_nodes:
        raise AssertionError("the dodecahedron's selection did not take the correction route")
    dwin = convert.transport_to_torch(
        next(TrajectoryReader([dpath]).iter_windows(DODECA_WINDOW, quantized=_wire())), device)
    _reset_launches()
    dmasks, dofl = fs_d.compiled(decode_window_coords(dwin[0]), dwin[1], dwin[2])
    dmasks, dofl = dmasks.cpu().numpy(), dofl.cpu().numpy()
    if any(_launches().values()):
        raise AssertionError(f"the dodecahedron's selection launched kernels {_launches()}")
    vs_dodeca = sum(_count_check(np.flatnonzero(m)) != (int(dcount[f]), int(dcheck[f]))
                    for f, m in enumerate(dmasks))

    phase("selection_path", atoms=ATOMS, protein=PROTEIN, frames=len(ids), window=window,
          gro_write_s=round(t_gro, 3), tiers=tiers, within_nodes_on_ghost_route=ghost_nodes,
          e2e_fps=[round(p, 3) for p in passes], e2e_fps_best=max(passes),
          stream_fps=[round(p, 3) for p in stream_fps], stream_fps_best=max(stream_fps),
          setup_s=round(task.timings["setup"], 3), launches=launches,
          launches_per_window=launches["cell_bins"] / n_windows,
          counts_frame0={k: int(res[0, i, 0]) for i, k in enumerate(keys)},
          a_headline_frames_differing_from_main_path=vs_main,
          host_evaluator_mismatches=vs_host, host_evaluator_s=round(t_host, 3),
          eval_window_mismatches=vs_eval, no_sync_window=True, window_enqueue_ms=enqueue_ms,
          window_device_ms=window_device_ms, by_node=by_node,
          profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, top_device_ops=repr(prof_top),
          host_tier=fs_host.tier, host_tier_fps=host_fps,
          host_tier_count_frame0=int(host_masks[0].sum()),
          dodeca_window_frames=len(dmasks), dodeca_overflow=bool(dofl.any()),
          dodeca_frames_differing_from_phase8=vs_dodeca)
    if vs_main or vs_host or vs_eval or vs_dodeca or dofl.any() or fs_host.tier != "host":
        raise AssertionError(f"selection path parity failed: vs_main={vs_main} "
                             f"vs_host={vs_host} vs_eval={vs_eval} vs_dodeca={vs_dodeca} "
                             f"dodeca_overflow={bool(dofl.any())} host_tier={fs_host.tier}")
    if not (res[:, :, 0] > 0).all():
        raise AssertionError("selection path: an empty selection")
    return launches


# ---------------------------------------------------------------- phase 14

# The espaloma path: the real model (its widths are fixed by the file) on a
# seeded corpus of drug-like ligands of 20-80 atoms and on one peptide
# (tests/torch_molecules.py). The bars are tests/test_espaloma.py's.
ESP_LIGANDS = 1000
ESP_PEPTIDE_RESIDUES = 120
ESP_VS_CPU = 20
ESP_ES_TOL, ESP_Q_TOL = 1e-5, 1e-4
# Forwards of the peptide replayed from a CUDA graph for its device time.
ESP_PEPTIDE_REPLAYS = 20
# Ligands whose forwards are profiled for the device operations a molecule.
ESP_PROFILED = 100
# Peptide lengths of the crossover sweep (card forward against numpy walk),
# and the calls a point is the median of.
ESP_SWEEP_RESIDUES = (1, 2, 4, 8, 16, 32, 64, 120)
ESP_SWEEP_CALLS = 3
# The numpy walk again in a fresh process whose BLAS has one thread: the
# first ligands' walk, then the sweep's (JSON on its last line).
ESP_ONE_THREAD_LIGANDS = 200
ESP_ONE_THREAD_WALK = """
import json, statistics, sys, time
sys.path[:0] = sys.argv[1:3]
from molar_tpu_torch.ff import espaloma
from torch_molecules import ligand_corpus, peptide
feats = [espaloma.featurize(*m) for m in ligand_corpus(int(sys.argv[3]))]
t0 = time.perf_counter()
for f, a in feats:
    espaloma.run_gnn(f, a)
out = {"ligands_s": time.perf_counter() - t0, "sweep_ms": {}}
for r in json.loads(sys.argv[4]):
    f, a = espaloma.featurize(*peptide(r))
    ts = []
    for _ in range(int(sys.argv[5])):
        t0 = time.perf_counter()
        espaloma.run_gnn(f, a)
        ts.append((time.perf_counter() - t0) * 1e3)
    out["sweep_ms"][r] = statistics.median(ts)
print(json.dumps(out))
"""


def _gnn_work(graph, n: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward at ``n`` atoms, counted from the
    graph's shapes: 2mkc a product, one an element of an Add, Relu or Tanh,
    none a Gather; the bytes are the inputs, the weights and the two
    outputs, each once."""
    shapes = {k: tuple(v.shape) for k, v in graph.initializers.items()}
    shapes["features"], shapes["adjacency_mean"] = (n, 116), (n, n)
    flops = 0
    for node in graph.nodes:
        ins = [shapes[i] for i in node.inputs]
        if node.op_type == "MatMul":
            (m, k), (_, c) = ins
            out = (m, c)
            flops += 2 * m * k * c
        elif node.op_type == "Gather":
            out = ins[0][:1]
        else:
            out = tuple(np.broadcast_shapes(*ins))
            flops += int(np.prod(out))
        shapes[node.outputs[0]] = out
    weights = sum(v.nbytes for v in graph.initializers.values())
    return flops, 4 * (n * 116 + n * n + 2 * n) + weights


def _device_ops_ms(fn) -> tuple[int, float]:
    """(device operations, their summed device ms) of one ``fn()``, read
    from the second of two profiled passes: a trace can lack the first
    device operations after the profiler starts (dozens, when other
    profiles ran before in the process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("stage:read"):
                fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA and e.name == "stage:read"
               for e in prof.events()):
            by_stage, n_ops = _stage_device_ms(prof, last_pass_from="read")
            if n_ops:
                return n_ops, by_stage.get("read", 0.0)
    raise AssertionError(f"no device operation of the read pass in {PROFILE_TRIES} traces")


def phase_espaloma(device):
    """Phase 14: espaloma charges of the ligand corpus and the peptide on the
    card, held against the numpy walk and the torch-CPU forward."""
    import torch

    from molar_tpu_torch.ff import espaloma

    from torch_molecules import ligand_corpus, peptide

    os.environ["MOLAR_ESPALOMA_BACKEND"] = "torch"
    t0 = time.perf_counter()
    corpus = ligand_corpus(ESP_LIGANDS)
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    pep = peptide(ESP_PEPTIDE_RESIDUES)
    pep_feat = espaloma.featurize(*pep)
    t_pep_featurize = time.perf_counter() - t0
    sizes = np.array([len(z) for z, _, _ in corpus])
    n_charged = sum(bool(np.any(fc)) for _, fc, _ in corpus)
    gnn, cpu_gnn = espaloma.load_gnn(device), espaloma.load_gnn("cpu")
    _reset_launches()

    # The user's call, molecule by molecule, on the card.
    espaloma.espaloma_charges(*corpus[0], device=device)
    t0 = time.perf_counter()
    q_card = [espaloma.espaloma_charges(*m, device=device) for m in corpus]
    t_card = time.perf_counter() - t0
    # The same call part by part, each part over the whole corpus.
    t0 = time.perf_counter()
    feats = [espaloma.featurize(*m) for m in corpus]
    t_featurize = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_in = [(torch.from_numpy(f).to(device), torch.from_numpy(a).to(device)) for f, a in feats]
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [gnn(*x) for x in dev_in]
    torch.cuda.synchronize()
    t_forward = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [(e.cpu().numpy(), s.cpu().numpy()) for e, s in outs]
    t_d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_split = [espaloma.equilibrate(e, s) for e, s in host]
    t_equilibrate = time.perf_counter() - t0
    # The numpy walk on the host in place of the card's part: the call
    # with MOLAR_ESPALOMA_BACKEND=numpy is featurise + walk + equilibrate.
    t0 = time.perf_counter()
    walk = [espaloma.run_gnn(f, a) for f, a in feats]
    t_walk = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_numpy = [espaloma.equilibrate(e, s) for e, s in walk]
    t_numpy = t_featurize + t_walk + time.perf_counter() - t0

    err_es = max(max(float(np.abs(e - we).max()), float(np.abs(s - ws).max()))
                 for (e, s), (we, ws) in zip(host, walk))
    err_q = max(float(np.abs(q - w).max()) for q, w in zip(q_card, q_numpy))
    err_split = max(float(np.abs(q - w).max()) for q, w in zip(q_split, q_card))
    sum_q = max(abs(float(q.sum())) for q in q_card)
    err_cpu = 0.0
    for (f, a), (e, s) in list(zip(feats, host))[:ESP_VS_CPU]:
        ce, cs = cpu_gnn(torch.from_numpy(f), torch.from_numpy(a))
        err_cpu = max(err_cpu, float(np.abs(ce.numpy() - e).max()),
                      float(np.abs(cs.numpy() - s).max()))

    # Device time of the corpus's forwards (one CUDA graph of all of them),
    # and the device operations of a profiled sample.
    corpus_device_ms = _graph_ms(lambda: [gnn(*x) for x in dev_in], 1)
    n_ops, busy_ms = _device_ops_ms(lambda: [gnn(*x) for x in dev_in[:ESP_PROFILED]])
    flops = sum(_gnn_work(espaloma._graph(), int(n))[0] for n in sizes)

    # The peptide: its charges, its device time against its bound.
    pep_dev = tuple(torch.from_numpy(x).to(device) for x in pep_feat)
    pe, ps = (t.cpu().numpy() for t in gnn(*pep_dev))
    we, ws = espaloma.run_gnn(*pep_feat)
    ce, cs = (t.numpy() for t in cpu_gnn(*(torch.from_numpy(x) for x in pep_feat)))
    pq, wq = espaloma.equilibrate(pe, ps), espaloma.equilibrate(we, ws)
    t0 = time.perf_counter()
    pq_call = espaloma.espaloma_charges(*pep, device=device)
    t_pep_call = time.perf_counter() - t0
    pep_err_es = max(float(np.abs(pe - we).max()), float(np.abs(ps - ws).max()))
    pep_err_cpu = max(float(np.abs(pe - ce).max()), float(np.abs(ps - cs).max()))
    pep_err_q = max(float(np.abs(pq - wq).max()), float(np.abs(pq_call - wq).max()))
    pep_ms = _graph_ms(lambda: gnn(*pep_dev), ESP_PEPTIDE_REPLAYS)
    pep_flops, pep_bytes = _gnn_work(espaloma._graph(), len(pep[0]))
    pep_bound = _bound(pep_bytes, pep_flops)
    launches = _launches()

    # The crossover: the forward on the card (host clock, to the result on
    # the host) against the numpy walk, by peptide length.
    sweep = {}
    for r in ESP_SWEEP_RESIDUES:
        f, a = espaloma.featurize(*peptide(r))
        card_ms, walk_ms = [], []
        for _ in range(ESP_SWEEP_CALLS):
            t0 = time.perf_counter()
            espaloma.run_gnn_torch(f, a, device)
            card_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            espaloma.run_gnn(f, a)
            walk_ms.append((time.perf_counter() - t0) * 1e3)
        sweep[r] = (len(f), float(np.median(card_ms)), float(np.median(walk_ms)))
    one_thread = json.loads(subprocess.run(
        [sys.executable, "-c", ESP_ONE_THREAD_WALK, str(HERE), str(HERE / "tests"),
         str(ESP_ONE_THREAD_LIGANDS), json.dumps(ESP_SWEEP_RESIDUES), str(ESP_SWEEP_CALLS)],
        env=dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
                 MKL_NUM_THREADS="1"),
        check=True, capture_output=True, text=True, timeout=600).stdout.splitlines()[-1])
    for r, (atoms, card_ms, walk_ms) in sweep.items():
        phase("espaloma_crossover", residues=r, atoms=atoms, card_forward_ms=card_ms,
              numpy_walk_ms=walk_ms, numpy_walk_one_blas_thread_ms=one_thread["sweep_ms"][str(r)])

    n = len(corpus)
    phase("espaloma", ligands=n, atoms_min=int(sizes.min()), atoms_max=int(sizes.max()),
          atoms_mean=float(sizes.mean()), charged_ligands=n_charged,
          corpus_s=round(t_corpus, 3),
          card_molecules_per_s=n / t_card, numpy_molecules_per_s=n / t_numpy,
          split_s=repr({"featurize": round(t_featurize, 4), "h2d": round(t_h2d, 4),
                        "forward": round(t_forward, 4), "d2h": round(t_d2h, 4),
                        "equilibrate": round(t_equilibrate, 4)}),
          numpy_walk_s=round(t_walk, 4),
          numpy_walk_one_blas_thread_s_per_molecule=one_thread["ligands_s"]
          / ESP_ONE_THREAD_LIGANDS,
          card_forward_s=round(t_forward, 4),
          device_ms_per_molecule=corpus_device_ms / n,
          busy_ms_per_molecule=busy_ms / ESP_PROFILED,
          device_ops_per_molecule=n_ops / ESP_PROFILED, flops_per_molecule=flops / n,
          max_abs_err_e_s_vs_numpy=err_es, max_abs_err_q_vs_numpy=err_q,
          max_abs_err_split_vs_call=err_split, max_abs_sum_q=sum_q,
          molecules_vs_cpu=ESP_VS_CPU, max_abs_err_e_s_vs_cpu=err_cpu, kernel_launches=launches)
    phase("espaloma_peptide", residues=ESP_PEPTIDE_RESIDUES, atoms=len(pep[0]),
          bonds=len(pep[2]), featurize_s=round(t_pep_featurize, 3),
          call_s=round(t_pep_call, 4), device_ms=pep_ms,
          flops=pep_flops, bytes=pep_bytes, bound_ms=pep_bound["bound_ms"],
          bound_by=pep_bound["bound_by"],
          fp32_share=pep_flops / F32_FLOP_PER_S / (pep_ms / 1e3),
          max_abs_err_e_s_vs_numpy=pep_err_es, max_abs_err_e_s_vs_cpu=pep_err_cpu,
          max_abs_err_q_vs_numpy=pep_err_q, sum_q=float(pq.sum()))
    bad = [k for k, v, tol in (("e_s", err_es, ESP_ES_TOL), ("q", err_q, ESP_Q_TOL),
                               ("split", err_split, ESP_Q_TOL), ("sum_q", sum_q, ESP_Q_TOL),
                               ("cpu", err_cpu, ESP_ES_TOL), ("pep_e_s", pep_err_es, ESP_ES_TOL),
                               ("pep_cpu", pep_err_cpu, ESP_ES_TOL),
                               ("pep_q", pep_err_q, ESP_Q_TOL),
                               ("pep_sum_q", abs(float(pq.sum())), ESP_Q_TOL)) if not v <= tol]
    if bad or any(launches.values()) or not all(np.isfinite(q).all() for q in q_card):
        raise AssertionError(f"espaloma path failed: {bad}, launches {launches}")
    del os.environ["MOLAR_ESPALOMA_BACKEND"]
    return q_card


# ---------------------------------------------------------------- phase 15

TRJCONV_REPEATS = 3
TRJCONV_SELECT = "resname ALA"  # wl_trjconv's selection: the protein rows


def _workload_topology(system):
    """Names for ``workloads.synth_system``'s rows: the protein as ALA
    residues of N / CA / C / O (its CA atoms are rows 1, 5, ...), then SOL
    waters of OW / HW1 / HW2."""
    from molar_tpu_torch.convert import topology_from_numpy

    n, npro = system.n_atoms, len(system.protein)
    nw = n - npro
    names = [("N", "CA", "C", "O")[k % 4] for k in range(npro)] + \
        [("OW", "HW1", "HW2")[k % 3] for k in range(nw)]
    resid = np.concatenate([system.segment_ids + 1,
                            system.segment_ids[-1] + 2 + np.arange(nw) // 3])
    z = [{"N": 7, "C": 6, "O": 8, "H": 1}[s[0]] for s in names]
    return topology_from_numpy(names, ["ALA"] * npro + ["SOL"] * nw, resid, resid - 1,
                               ["A"] * n, system.masses, np.zeros(n), np.ones(n), np.zeros(n),
                               z)


def _compare_dcd(a_path: str, b_path: str) -> float:
    """Largest coordinate difference (nm) of two DCDs, frame by frame
    (``benchmarks/workloads.py``'s ``_compare_dcd``); inf when the frame or
    atom counts differ."""
    from molar_tpu_torch.io.dcd import DcdHandler

    with DcdHandler(a_path) as a, DcdHandler(b_path) as b:
        if (a.n_frames, a.n_atoms) != (b.n_frames, b.n_atoms):
            return float("inf")
        return max(float(np.abs(a.read_frame(k).coords - b.read_frame(k).coords).max())
                   for k in range(a.n_frames))


def phase_trjconv_cli(workdir, system, path, meta):
    """Phase 15: trjconv of phase 9's file against ``native_workloads
    trjconv``, then the ``molar-torch`` CLI (``info``, ``trjconv`` on a GRO)."""
    import contextlib
    import io

    import torch

    from molar_tpu_torch import build, cli
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.io.gro import write_gro
    from molar_tpu_torch.io.trjconv import trjconv

    _reset_launches()
    out = os.path.join(workdir, "trjconv.dcd")
    seconds = []
    for _ in range(TRJCONV_REPEATS):
        t0 = time.perf_counter()
        n = trjconv(path, out, system.protein)
        seconds.append(time.perf_counter() - t0)
    native_dcd = os.path.join(workdir, "native_trjconv.dcd")
    native = json.loads(subprocess.run(
        [str(build.build_native_workloads()), "trjconv", path, meta, "0", native_dcd],
        check=True, capture_output=True, text=True, timeout=600).stdout.splitlines()[-1])
    max_diff = _compare_dcd(out, native_dcd)

    gro = os.path.join(workdir, "workloads.gro")
    write_gro(gro, _workload_topology(system),
              State(coords=system.coords, box=PeriodicBox(system.box)))
    info = io.StringIO()
    with contextlib.redirect_stdout(info):
        info_rc = cli.main(["info"])
    cli_dcd = os.path.join(workdir, "cli.dcd")
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        cli_rc = cli.main(["trjconv", "-s", gro, "-f", path, "-o", cli_dcd,
                           "--select", TRJCONV_SELECT])
    t_cli = time.perf_counter() - t0
    with open(out, "rb") as a, open(cli_dcd, "rb") as b:
        cli_equal = a.read() == b.read()
    launches = _launches()
    for line in info.getvalue().splitlines():
        print(f"# info: {line}", flush=True)
    phase("trjconv", atoms=system.n_atoms, rows=len(system.protein), frames=n,
          fps=[round(n / s, 3) for s in seconds], fps_best=n / min(seconds),
          native_fps=native["fps"], native_frames=native["frames"],
          dcd_max_abs_diff_nm_vs_native=max_diff, dcd_bytes=os.path.getsize(out),
          cli_rc=cli_rc, cli_s=round(t_cli, 3), cli_said=repr(said.getvalue().strip()),
          cli_dcd_equal=cli_equal, info_rc=info_rc, kernel_launches=launches)
    if (max_diff > 1e-6 or native["frames"] != n or info_rc or cli_rc or not cli_equal
            or torch.cuda.get_device_name(0) not in info.getvalue() or any(launches.values())):
        raise AssertionError(f"trjconv path failed: max diff {max_diff} nm, native frames "
                             f"{native['frames']} vs {n}, info rc {info_rc}, cli rc {cli_rc}, "
                             f"cli bytes equal {cli_equal}, launches {launches}")


# ---------------------------------------------------------------- phase 19

# The user-API path: the README's first lines on the headline system, through
# a System on the card against a System on the CPU (device="cpu") from the
# same file. The per-call table's selection sizes (the first n atoms: n =
# 100 and 5,000 are protein rows, 100,000 every atom), SASA's sizes, the card
# calls a point (median, after one warm-up call) and the host calls (median
# of three; one call of a search at 100,000 atoms or of SASA at 1,000, ~4-10
# s each), the helix's
# length, and the bars: measures within 1e-6 relative (float64 on both
# sides), a rotation's entries within 1e-6, RMSD within 1e-5 nm, within sets
# and pair sets equal, distances within 1e-6 nm, SASA within 2e-5 nm^2 an
# atom, the volume's voxel count the host's (1e-12 relative).
USER_SIZES = (100, 5_000, 100_000)
USER_SASA_SIZES = (100, 1_000)
USER_CARD_REPEATS = 3
USER_HOST_REPEATS = 3
USER_HELIX_RESIDUES = 100
USER_MEASURE_RTOL = 1e-6
USER_ROTATION_ATOL = 1e-6
USER_RMSD_ATOL = 1e-5
USER_DIST_ATOL = 1e-6
USER_SASA_ATOL = 2e-5
USER_VOLUME_RTOL = 1e-12
USER_SASA_CAP = 256


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _columns_as_written(ext, written, back):
    """Mismatches of ``back`` (read from ``ext``) against ``written``, each
    column as the format stores it: PDB resids modulo 9,999 and
    coordinates to 3 decimals in Angstrom; GRO resids modulo 99,999, no
    chain, coordinates to 3 decimals in nm."""
    wt, bt = written.topology, back.topology
    resid_mod, coord_tol = (9999, 0.5e-4 + 1e-6) if ext == "pdb" else (99999, 0.5e-3 + 1e-6)
    bad = {
        "names": int((wt.names() != bt.names()).sum()),
        "resnames": int((wt.resnames() != bt.resnames()).sum()),
        "resid": int((wt.resid % resid_mod != bt.resid).sum()),
        "atomic_number": int((wt.atomic_number != bt.atomic_number).sum()),
        "mass": int((wt.mass != bt.mass).sum()),
        "chain": int((wt.chain != bt.chain).sum()) if ext == "pdb" else 0,
        "coords": int((np.abs(written.state.coords - back.state.coords) > coord_tol).sum()),
    }
    box_tol = 0.5e-4 if ext == "pdb" else 0.5e-4 + 1e-6
    bad["box"] = int(np.abs(written.state.box.matrix - back.state.box.matrix).max() > box_tol)
    return bad


def _launched(fn):
    """``fn()`` -> (its result, the kernel launches it made)."""
    before = _launches()
    out = fn()
    return out, {k: v - before[k] for k, v in _launches().items()}


def _median_s(fn, reps: int):
    """``fn()`` ``reps`` times -> (the last result, the median seconds)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _user_diff(kind: str, card, host) -> float:
    """The card's answer against the CPU System's, as a ratio to its bar (at
    most 1 within it; a set or pair list that differs is inf)."""
    if kind == "set":
        return 0.0 if np.array_equal(card.indices, host.indices) else float("inf")
    if kind == "pairs":  # both routes return the list sorted by (i, j)
        if not np.array_equal(card[0], host[0]):
            return float("inf")
        return float(np.abs(card[1] - host[1]).max(initial=0.0)) / USER_DIST_ATOL
    if kind == "rmsd":
        return abs(card - host) / USER_RMSD_ATOL
    if kind == "fit":
        return max(float(np.abs(card[0] - host[0]).max()) / USER_ROTATION_ATOL,
                   _rel(card[1], host[1]) / USER_MEASURE_RTOL)
    if kind == "sasa":
        return float(np.abs(card.areas() - host.areas()).max()) / USER_SASA_ATOL
    return _rel(card, host) / USER_MEASURE_RTOL


def phase_user_api(device, workdir, headline_path):
    """Phase 19: ``System`` / ``Sel`` and the structure files on the headline
    system, every computing call through a System on the card held against
    a System on the CPU from the same file -> the path's kernel launches."""
    import torch

    import molar_tpu_torch as mt
    from molar_tpu_torch import headline
    from molar_tpu_torch.io import FileHandler
    from molar_tpu_torch.tasks.trajectory import AnalysisTask

    from torch_structures import HELIX, scene_pdb

    _reset_launches()
    # IO: the headline's first two frames; the first written as PDB and GRO
    # and read back.
    with FileHandler(headline_path) as fh:
        written = mt.System(headline.label_topology(ATOMS, PROTEIN), fh.read_state())
        frame1 = fh.read_state()
    io_s, bad_columns = {}, {}
    for ext in ("pdb", "gro"):
        path = os.path.join(workdir, f"conf.{ext}")
        t0 = time.perf_counter()
        written.save(path)
        t1 = time.perf_counter()
        back = mt.System.from_file(path)
        io_s[f"{ext}_write_s"] = round(t1 - t0, 3)
        io_s[f"{ext}_read_s"] = round(time.perf_counter() - t1, 3)
        bad_columns[ext] = _columns_as_written(ext, written, back)
    pdb = os.path.join(workdir, "conf.pdb")
    card = mt.System.from_file(pdb)  # device None: the card
    host = mt.System.from_file(pdb, device="cpu")
    if card.device.type != "cuda" or host.device.type != "cpu":
        raise AssertionError(f"user API devices: card {card.device}, host {host.device}")
    card2 = mt.System(card.topology, frame1.copy())
    host2 = mt.System(host.topology, frame1.copy(), device="cpu")

    # Measures of sys("protein"), with and without PBC.
    failures = [f"{ext} columns {b}" for ext, b in bad_columns.items() if any(b.values())]
    measures = {}
    for pbc in (None, mt.PBC_FULL):
        tag = "" if pbc is None else "_pbc"
        cp, hp = card("protein"), host("protein")
        for name, call in (("com", lambda s: s.com(pbc)), ("cog", lambda s: s.cog(pbc)),
                           ("gyration", lambda s: s.gyration(pbc)),
                           ("moments", lambda s: s.inertia(pbc)[0]),
                           ("inertia_com", lambda s: s.inertia(pbc)[2]),
                           ("principal", lambda s: s.principal_transform(pbc))):
            kind = "fit" if name == "principal" else "measure"
            measures[name + tag] = _user_diff(kind, call(cp), call(hp))
    measures["min_max"] = _user_diff("measure", card("protein").min_max(),
                                     host("protein").min_max())
    axes = (card("protein").inertia()[1], host("protein").inertia()[1])
    measures["inertia_axes"] = float(np.abs(axes[0] - axes[1]).max()) / USER_ROTATION_ATOL

    # The per-call table: the card against the CPU, each answer compared.
    text = "within 0.5 pbc of protein"
    calls = {
        "com": ("measure", lambda s, s2, n: s((0, n)).com()),
        "gyration": ("measure", lambda s, s2, n: s((0, n)).gyration()),
        "fit_transform": ("fit", lambda s, s2, n: s((0, n)).fit_transform(s2((0, n)))),
        "rmsd_mw": ("rmsd", lambda s, s2, n: s((0, n)).rmsd_mw(s2((0, n)))),
        "within_of": ("set", lambda s, s2, n: s((0, n)).within_of(CUTOFF, s("protein"),
                                                                  mt.PBC_FULL)),
        "select": ("set", lambda s, s2, n: s(f"index 0:{n - 1} and {text}")),
        "distance_search": ("pairs", lambda s, s2, n: mt.distance_search(
            CUTOFF, s((0, n)), s("protein"), mt.PBC_FULL)),
        "sasa": ("sasa", lambda s, s2, n: s((0, n)).sasa()),
    }
    table, per_call_launches = {}, {}
    for name, (kind, call) in calls.items():
        for n in (USER_SASA_SIZES if name == "sasa" else USER_SIZES):
            def on(s, s2, call=call, n=n):
                return lambda: call(s, s2, n)

            _, launched = _launched(on(card, card2))  # warm-up, and the launches of one call
            got, card_s = _median_s(on(card, card2), USER_CARD_REPEATS)
            heavy = (n == ATOMS and kind in ("set", "pairs")) or (kind == "sasa" and n > 100)
            want, host_s = _median_s(on(host, host2), 1 if heavy else USER_HOST_REPEATS)
            diff = _user_diff(kind, got, want)
            table[f"{name}@{n}"] = (card_s * 1e3, host_s * 1e3)
            phase("user_api_call", call=name, atoms=n, card_ms=round(card_s * 1e3, 4),
                  cpu_ms=round(host_s * 1e3, 4), cpu_over_card=round(host_s / card_s, 3),
                  worst_over_bar=diff, launches=launched)
            if not diff <= 1.0:
                failures.append(f"{name} at {n} atoms: {diff} of its bar")
            if name in ("within_of", "select"):
                per_call_launches[f"{name}@{n}"] = launched
                if (launched["cell_bins"] < 1 or launched["within_ghost"] < 1
                        or launched["within_rows"]):
                    failures.append(f"{name} at {n} atoms launched {launched}")
            elif any(launched.values()):
                failures.append(f"{name} at {n} atoms launched {launched}")
    sasa_v = (card((0, 100)).sasa(with_volume=True), host((0, 100)).sasa(with_volume=True))
    volume_rel = _rel(sasa_v[0].total_volume(), sasa_v[1].total_volume())
    if not volume_rel <= USER_VOLUME_RTOL:
        failures.append(f"volume of 100 atoms off by {volume_rel} relative")

    # The per-frame RMSD of the protein through AnalysisTask (Sel.fit +
    # rmsd_mw a frame) on each route over conf.pdb and the headline XTC.
    class Rmsd(AnalysisTask):
        def pre_process(self):
            self.sel = self.src("protein")
            self.ref, self.rmsd = self.sel.to_system(), []

        def process_frame(self):
            self.sel.fit(self.ref("all"))
            self.rmsd.append(self.sel.rmsd_mw(self.ref("all")))

    tasks, fps = {}, {}
    for route, dev in (("card", None), ("cpu", "cpu")):
        tasks[route] = Rmsd()
        t0 = time.perf_counter()
        n = tasks[route].run(["-f", pdb, headline_path, "--log", "0"], device=dev).consumed_frames
        fps[route] = n / (time.perf_counter() - t0)
    rmsd_err = float(np.abs(np.subtract(tasks["card"].rmsd, tasks["cpu"].rmsd)).max())
    if (tasks["card"].src.device.type != "cuda" or len(tasks["card"].rmsd) != n
            or not rmsd_err <= USER_RMSD_ATOL):
        failures.append(f"AnalysisTask: card device {tasks['card'].src.device}, "
                        f"{len(tasks['card'].rmsd)} of {n} frames, rmsd err {rmsd_err}")

    # DSSP / dss of an ideal alpha-helix built by NeRF (host work).
    helix_pdb = os.path.join(workdir, "helix.pdb")
    with open(helix_pdb, "w") as fh:
        fh.write(scene_pdb(chains=(np.array([HELIX] * USER_HELIX_RESIDUES),), n_water=0,
                           n_ligand=0, box=None))
    helix = mt.System.from_file(helix_pdb)("protein")
    t0 = time.perf_counter()
    ss_gmx, ss_dss = helix.dssp("gmx"), helix.dss()
    dssp_s = time.perf_counter() - t0
    interior = "H" * (USER_HELIX_RESIDUES - 2)
    if ss_gmx[1:-1] != interior or ss_dss[1:-1] != interior:
        failures.append(f"helix dssp {ss_gmx!r} dss {ss_dss!r}")
    torch.cuda.synchronize()
    launches = _launches()
    phase("user_api", atoms=ATOMS, protein=PROTEIN, **io_s, bad_columns=bad_columns,
          measures_worst_over_bar={k: round(v, 4) for k, v in measures.items()},
          volume_rel_err=volume_rel, within_launches=per_call_launches, frames=n,
          analysis_task_fps_card=round(fps["card"], 3), analysis_task_fps_cpu=round(fps["cpu"], 3),
          rmsd_max_abs_err=rmsd_err, helix_dssp_gmx=ss_gmx, helix_dss=ss_dss,
          dssp_s=round(dssp_s, 4), launches=launches)
    failures += [f"measure {k}: {v} of its bar" for k, v in measures.items() if not v <= 1.0]
    if failures:
        raise AssertionError("user-API path: " + "; ".join(failures))
    return launches


# ---------------------------------------------------------------- phase 16

# bench.py's big point: 1,000,000 atoms at 100 atoms/nm^3 (a 21.544 nm
# cube), a 20,000-atom protein ball, the 0.5 nm cutoff and the 0.02 nm walk;
# 32 frames, the window sizes swept, 3 samples for the parity on the CPU
# (frames 0 / mid / last) and 3 runs of the native program.
MILLION_ATOMS = 1_000_000
MILLION_PROTEIN = 20_000
MILLION_BOX = 21.544
MILLION_FRAMES = 32
MILLION_WINDOWS = (1, 2, 4, 8, 16)
MILLION_NATIVE_RUNS = 3


def _ghost_kernels_at(coords, tgt, boxes, invs, dims, cap, tcap, n_atoms, label):
    """The two ghost kernels on one resident window against their plain
    twins on the same CUDA tensors (the whole search's masks, the binning
    counts against ``torch.bincount``, the stencil against its twin on the
    same records; all exact), each kernel's time (CUDA-graph replay), its
    twin's, and its bound from this window's data -> kernel records."""
    import torch

    from molar_tpu_torch.ops import neighbor_ghost as ng
    from molar_tpu_torch.ops.neighbor import _cutoff2, _search_args, within_mask_window

    frames = coords.shape[0]
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    window = (coords, None, tgt, CUTOFF, boxes, invs, dims, cap, tcap)
    masks, ofl = within_mask_window(*window)
    pmasks, pofl = within_mask_window(*window, plain=True)
    if ofl.any() or pofl.any() or not torch.equal(masks, pmasks):
        raise AssertionError(f"{label}: kernels and plain twin disagree or overflow")
    bins_args = (coords, None, tgt, boxes, invs, dims, cap, tcap)
    src_rec, tgt_rec, counts, _ = ng.cell_bins(*bins_args)
    for f in range(frames):
        sa = _search_args(coords[f], None, tgt, boxes[f], invs[f], dims)
        tflat = (sa[7] * ny + sa[8]) * nz + sa[9]
        for k, flat in enumerate((sa[3], tflat)):
            if not torch.equal(counts[f, k], torch.bincount(flat.long(), minlength=n_cells).int()):
                raise AssertionError(f"{label} frame {f}: binning counts != bincount")
    stencil_args = (src_rec, tgt_rec, counts, boxes, dims, cap, tcap, (True,) * 3,
                    _cutoff2(CUTOFF), n_atoms)
    kmask = ng.within_ghost(*stencil_args)
    err = int((kmask.int() - ng._bins_stencil(*stencil_args).int()).abs().max())
    if err or not torch.equal(kmask, masks):
        raise AssertionError(f"{label}: stencil kernel != its twin on the same records")
    runs = {k: [] for k in ("bins", "bins_plain", "stencil", "stencil_plain")}
    for order in ((False, True), (True, False)):
        for kernel in order:
            if kernel:
                runs["bins"].append(_graph_ms(lambda: ng.cell_bins(*bins_args), 10))
                runs["stencil"].append(_graph_ms(lambda: ng.within_ghost(*stencil_args), 10))
            else:
                runs["bins_plain"].append(_cuda_ms(lambda: ng._cell_bins_plain(*bins_args), 1))
                runs["stencil_plain"].append(_cuda_ms(lambda: ng._bins_stencil(*stencil_args),
                                                      1))
    ms = {k: float(np.mean(v)) for k, v in runs.items()}
    n_pts = frames * (n_atoms + tgt.numel())
    pairs, live_src, occupied = _window_work(counts, dims, cap, tcap)
    coord_bytes = coords.numel() * 4 + tgt.numel() * 8 + 2 * boxes.numel() * 4
    bins_bound = _bound(coord_bytes + n_pts * 16 + counts.numel() * 4 + frames, n_pts * 40)
    stencil_bound = _bound((live_src + occupied) * 16 + counts.numel() * 4
                           + boxes.numel() * 4 + frames * n_atoms, pairs * 9)
    return {
        "cell_bins": {"max_abs_err": 0.0, "ms": ms["bins"], "plain_ms": ms["bins_plain"],
                      **bins_bound, "frames_per_launch": frames},
        "within_ghost": {"max_abs_err": err, "ms": ms["stencil"],
                         "plain_ms": ms["stencil_plain"], **stencil_bound,
                         "frames_per_launch": frames, "candidate_pairs": pairs},
    }


def phase_million(device, args, native_exe, workdir):
    """Phase 16: ``bench.py``'s 1M-atom point through ``headline.run`` (the
    ghost route) at full width: the window sweep, the cap tiers re-measured
    on this file, parity against the CPU and the native program, the native
    program's best and median, one resident window by stage and both
    kernels on it against their twins. Returns the kernels' records and
    the path's launches at the shipped window."""
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import estimate_caps, grid_dims_for
    from molar_tpu_torch.tasks.trajectory import (TrajectoryReader, auto_window,
                                                  decode_window_coords)

    box = PeriodicBox(np.diag([MILLION_BOX] * 3))
    coords0, masses = headline.make_system(MILLION_ATOMS, MILLION_PROTEIN, box.matrix)
    pidx = np.arange(MILLION_PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    path = os.path.join(workdir, "million.xtc")
    t0 = time.perf_counter()
    headline.write_trajectory(path, coords0, box.matrix, MILLION_FRAMES)
    t_write = time.perf_counter() - t0
    del coords0
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    shipped = auto_window(path)
    tier0 = headline.caps_for(*caps0, 0)

    # The cap tiers against every frame of this file.
    worst = np.zeros(3, np.int64)
    with XtcHandler(path) as h:
        for k in range(MILLION_FRAMES):
            worst = np.maximum(worst, estimate_caps(h.read_frame(k).coords, box.inv, dims, pidx,
                                                    margin=1.0, round_to=1))

    def run(window):
        return headline.run(path, ref, pmass, pidx, box, CUTOFF, dims, caps0, window, device)

    run(shipped)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(args.repeats,
                                                              lambda: run(shipped))
    launches = _launches()
    n_windows = args.repeats * -(-MILLION_FRAMES // shipped)
    if launches["within_rows"] or min(launches["cell_bins"], launches["within_ghost"]) < n_windows:
        raise AssertionError(f"1M path: launches {launches} for {n_windows} windows")
    if not np.array_equal(ids, np.arange(MILLION_FRAMES)):
        raise AssertionError(f"1M stream returned frames {ids[:4]}... ({len(ids)})")
    if not (np.isfinite(rmsd).all() and (count > 0).all()):
        raise AssertionError("1M path: non-finite RMSD or empty within set")
    sweep, retried_by_window, decode_fps = {}, {}, {}
    for w in MILLION_WINDOWS:
        if w == shipped:
            sweep[w], retried_by_window[w] = passes, retried
        else:
            (wids, _, wcount, wcheck, wret), sweep[w] = _timed_passes(args.repeats,
                                                                      lambda: run(w))
            if not (np.array_equal(wids, ids) and np.array_equal(wcount, count)
                    and np.array_equal(wcheck, check)):
                raise AssertionError(f"1M path: window {w} gives other results")
            retried_by_window[w] = wret
        decode_fps[w] = MILLION_FRAMES / _decode_s(path, w, None, repeats=2)
    medians = {w: float(np.median(v)) for w, v in sweep.items()}

    # One resident window of the shipped size: stages, busy share, kernels.
    windows = TrajectoryReader([path]).iter_windows(shipped, quantized=_wire())
    dev_windows = [convert.transport_to_torch(w, device) for w, _ in zip(windows, range(2))]
    resident_frames = sum(w[1].shape[0] for w in dev_windows)
    del windows
    model = convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF, tier0, dims, device)
    phase_stages(model, dev_windows[0], label="stages_million")
    enqueue_ms = _no_sync_window(model, dev_windows[0])
    prof_wall, prof_busy, prof_top, _ = _device_profile(
        lambda: [model(*w) for w in dev_windows])
    transport, boxes, invs = dev_windows[0]
    records = _ghost_kernels_at(decode_window_coords(transport), model.protein_idx, boxes, invs,
                                dims, tier0[0], tier0[1], MILLION_ATOMS, "1M window")
    del dev_windows, transport
    torch.cuda.empty_cache()

    parity, rmsd_err = _cpu_parity(path, (rmsd, count, check), ref, pmass, pidx, box, dims,
                                   caps0)
    native_runs = [json.loads(subprocess.run(
        [str(native_exe), path, str(MILLION_PROTEIN), str(CUTOFF)],
        check=True, capture_output=True, text=True, timeout=900,
    ).stdout) for _ in range(MILLION_NATIVE_RUNS)]
    native_fps = [r["fps"] for r in native_runs]
    native_parity = max(abs(int(r["within0"]) - int(count[0])) for r in native_runs)
    phase("million_path", atoms=MILLION_ATOMS, protein=MILLION_PROTEIN, box_nm=MILLION_BOX,
          dims=dims, frames=MILLION_FRAMES, shipped_window=shipped, caps_frame0=caps0,
          caps_tier0=tier0, caps_worst_frame=tuple(int(v) for v in worst),
          worst_over_frame0=tuple(round(int(w) / max(1, int(c)), 3)
                                  for w, c in zip(worst, caps0)),
          tier0_holds=bool((worst <= np.asarray(tier0)).all()),
          windows_retried=repr(retried_by_window),
          fps_by_window=repr({w: [round(p, 3) for p in v] for w, v in sweep.items()}),
          fps_median_by_window=repr({w: round(v, 3) for w, v in medians.items()}),
          best_window=max(medians, key=medians.get),
          decode_only_fps_by_window=repr({w: round(v, 3) for w, v in decode_fps.items()}),
          e2e_fps_best=max(passes), e2e_fps_median=float(np.median(passes)),
          window_enqueue_ms=enqueue_ms, profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, top_device_ops=repr(prof_top),
          device_ms_per_frame=prof_busy / resident_frames,
          native_fps=native_fps, native_fps_best=max(native_fps),
          native_fps_median=float(np.median(native_fps)), within0=int(count[0]),
          native_within0=native_runs[0]["within0"], mean_rmsd=float(np.mean(rmsd)),
          rmsd_max_abs_err_vs_cpu=rmsd_err, parity_diff=parity,
          native_parity_diff=native_parity, launches=launches, write_s=round(t_write, 3),
          kernels=repr({k: {kk: (round(vv, 5) if isinstance(vv, float) else vv)
                            for kk, vv in r.items()} for k, r in records.items()}))
    if parity or native_parity or rmsd_err > 1e-5:
        raise AssertionError(f"1M parity failed: parity_diff={parity} "
                             f"native_parity_diff={native_parity} rmsd_err={rmsd_err}")
    return records, launches


# ---------------------------------------------------------------- phase 17

# A contact list above DENSE_LIMIT on phase 9's file: the 4,000 protein rows
# against the first 1,000 water oxygens (4.0 M candidates), at the workload's
# 0.4 nm; 32 frames of the stream held against the module on the CPU, and
# the triclinic dense form on the dodecahedron's file (the protein against
# the first 50 waters' atoms, 16 frames).
GRID_CONTACT_WATERS = 1000
GRID_CONTACT_CPU_FRAMES = 32
TRICLINIC_LIGAND = 50


def _op_count(fn) -> float:
    """Device operations of one ``fn()``: the kernels and copies of two
    profiled passes after a warm one, halved."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")
               for e in prof.events()) / 2


def _pair_sets(out, frames):
    """Per frame, the set of (source, target) pairs of a contact window's
    output (pairs, distances, count, overflow)."""
    pairs = out[0][:frames].cpu().numpy()
    return [set(map(tuple, p[p[:, 0] >= 0].tolist())) for p in pairs]


def phase_grid_contacts(device, wl_system, wl_path, dodeca_path):
    """Phase 17: the grid ``contact_pairs`` window above ``DENSE_LIMIT``,
    through ``workloads.Contacts``: the whole window at once against its
    frame loop (plain version) on the card, pairs equal in order; the
    first frames against the module on the CPU as sets; device and
    enqueue ms, device operations a window, no host sync, fps of the
    stream. Then the triclinic dense form, timed, against the CPU."""
    import torch

    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.convert import transport_to_torch
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import (contact_pairs_dense_window, estimate_caps,
                                              grid_dims_for)
    from molar_tpu_torch.tasks.trajectory import (TrajectoryReader, auto_window,
                                                  decode_window_coords)

    from torch_scenes import dodecahedron

    s = wl_system
    tgt_rows = s.ow[:GRID_CONTACT_WATERS]
    subset = np.concatenate([s.protein, tgt_rows])
    src = torch.arange(len(s.protein))
    tgt = torch.arange(len(s.protein), len(subset))
    box = PeriodicBox(s.box)
    dims = grid_dims_for(box, wl.CUTOFF)
    _, tcap, _ = estimate_caps(s.coords[tgt_rows], box.inv, dims, np.arange(len(tgt_rows)))
    if len(src) * len(tgt) <= wl.DENSE_LIMIT:
        raise AssertionError("the grid contact scene is not above DENSE_LIMIT")

    def module(dev):
        return wl.Contacts(src.to(dev), tgt.to(dev), dims, wl.CUTOFF, wl.MAX_PAIRS, tcap)

    model, cpu_model = module(device), module("cpu")
    if model.dense:
        raise AssertionError("Contacts took the dense form above DENSE_LIMIT")
    window = auto_window(wl_path, subset)
    host = next(TrajectoryReader([wl_path]).iter_windows(window, quantized=_wire(),
                                                          subset=subset))
    dev_window = transport_to_torch(host, device)
    coords = decode_window_coords(dev_window[0])
    boxes, invs = dev_window[1], dev_window[2]
    got = model.pairs(coords, boxes, invs)
    loop = model.pairs(coords, boxes, invs, plain=True)
    if not all(torch.equal(a, b) for a, b in zip(got, loop)):
        raise AssertionError("grid contacts: the window form != its frame loop on the card")
    if got[3].any() or not (got[2] > 0).all():
        raise AssertionError(f"grid contacts: overflow {int(got[3].sum())} or an empty frame")
    n = GRID_CONTACT_CPU_FRAMES
    cpu = cpu_model.pairs(coords[:n].cpu(), boxes[:n].cpu(), invs[:n].cpu())
    cpu_equal = _pair_sets(cpu, n) == _pair_sets(got, n)
    if not cpu_equal or not torch.equal(cpu[2], got[2][:n].cpu()):
        raise AssertionError("grid contacts: the card's pair sets != the CPU's")
    _no_sync_window(model, dev_window)
    ms = _graph_ms(lambda: model(*dev_window), 3)
    _, enqueue_ms, by_stage, ops, top = _workload_window(model, dev_window,
                                                        WL_STAGES["contacts"])
    loop_ms = _cuda_ms(lambda: model.pairs(coords, boxes, invs, plain=True), 1)
    loop_ops = _op_count(lambda: model.pairs(coords[:8], boxes[:8], invs[:8], plain=True))
    t0 = time.perf_counter()
    model.pairs(coords, boxes, invs, plain=True)
    loop_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    fps = [_stream(wl_path, window, model, device, subset)[0] for _ in range(3)]

    # The triclinic dense form on the dodecahedron's file.
    dbox = PeriodicBox(dodecahedron(DODECA_D))
    dsrc = torch.arange(PROTEIN, device=device)
    dtgt = torch.arange(PROTEIN, PROTEIN + TRICLINIC_LIGAND, device=device)
    corr = torch.as_tensor(dbox.padded_corrections(), device=device)
    dwin = transport_to_torch(next(TrajectoryReader([dodeca_path]).iter_windows(
        DODECA_WINDOW, quantized=_wire())), device)
    dcoords = decode_window_coords(dwin[0])

    def dense(c, b, i, k, a, t):
        return contact_pairs_dense_window(c, a, t, wl.CUTOFF, b, i, k, wl.MAX_PAIRS)

    dgot = dense(dcoords, dwin[1], dwin[2], corr, dsrc, dtgt)
    dcpu = dense(*(x.cpu() for x in (dcoords, dwin[1], dwin[2], corr, dsrc, dtgt)))
    dense_equal = (_pair_sets(dgot, DODECA_WINDOW) == _pair_sets(dcpu, DODECA_WINDOW)
                   and torch.equal(dgot[2].cpu(), dcpu[2]))
    if not dense_equal or dgot[3].any() or not (dgot[2] > 0).all():
        raise AssertionError("triclinic dense contacts: card != CPU, overflow or empty")
    dense_ms = _graph_ms(lambda: dense(dcoords, dwin[1], dwin[2], corr, dsrc, dtgt), 5)
    dense_ops = _op_count(lambda: dense(dcoords, dwin[1], dwin[2], corr, dsrc, dtgt))
    phase("grid_contacts", rows=len(subset), sources=len(src), targets=len(tgt),
          candidates=len(src) * len(tgt), dense_limit=wl.DENSE_LIMIT, dims=dims, cap=tcap,
          max_pairs=wl.MAX_PAIRS, window=window, mean_pairs=float(got[2].float().mean()),
          device_ms_per_window=ms, device_ms_per_frame=ms / window,
          enqueue_ms_per_window=enqueue_ms, device_ops_per_window=ops,
          stage_device_ms=repr({k: round(v, 4) for k, v in by_stage.items()}),
          top_device_ops=repr(top),
          frame_loop_ms_per_window=loop_ms, frame_loop_enqueue_ms=loop_enqueue_ms,
          frame_loop_device_ops_per_frame=loop_ops / 8, stream_fps=[round(f, 3) for f in fps],
          stream_fps_median=float(np.median(fps)), window_equals_frame_loop=True,
          cpu_frames_equal=n, no_sync_window=True)
    phase("triclinic_dense_contacts", sources=PROTEIN, targets=TRICLINIC_LIGAND,
          frames=DODECA_WINDOW, d_nm=DODECA_D, device_ms_per_window=dense_ms,
          device_ms_per_frame=dense_ms / DODECA_WINDOW, device_ops_per_window=dense_ops,
          mean_pairs=float(dgot[2].float().mean()), cpu_equal=dense_equal)


# ---------------------------------------------------------------- phase 18

MESH_RAGGED = 63


def phase_mesh(device, args, workdir, headline_path, ghost, model, window):
    """Phase 18: frames sharded over devices on the one card: the ghost
    headline window through ``MeshWindowRunner(frame_mesh())`` (one device
    here) and a two-shard runner whose shards both sit on this card, each
    equal to the unsharded window; a ragged 63-frame window; the whole
    stream through ``headline.run(mesh=)`` equal to the main path; a
    ``WindowAnalysisTask`` with ``--mesh 2`` equal to one without; the
    runner's host overhead against the unsharded window. Scaling over
    several cards is not shown on one. Returns the stream's launches."""
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.parallel import MeshWindowRunner, frame_mesh
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    one, two = MeshWindowRunner(frame_mesh()), MeshWindowRunner([device, device])
    host = [next(TrajectoryReader([headline_path]).iter_windows(w, quantized=_wire()))
            for w in (WINDOW, MESH_RAGGED)]
    worst_rmsd = 0.0
    for item in host:
        want = model(*convert.transport_to_torch(item, device))
        for runner in (one, two):
            got = runner.call(model, *item[:3])
            if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                raise AssertionError(f"mesh of {runner.n}: counts or checksums differ "
                                     f"({len(item[4])}-frame window)")
            worst_rmsd = max(worst_rmsd, float((got[0] - want[0]).abs().max()))
    if worst_rmsd > 1e-6:
        raise AssertionError(f"mesh: RMSD off by {worst_rmsd}")

    def host_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    dev_window = convert.transport_to_torch(host[0], device)
    ms = {"unsharded": host_ms(lambda: model(*dev_window)),
          "one_device": host_ms(lambda: one.call(model, *host[0][:3])),
          "two_shards": host_ms(lambda: two.call(model, *host[0][:3])),
          "unsharded_with_copy": host_ms(
              lambda: model(*convert.transport_to_torch(host[0], device)))}

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, masses = headline.make_system(ATOMS, PROTEIN, box.matrix)
    pidx = np.arange(PROTEIN)
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(headline_path, box.inv, dims, pidx)
    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(args.repeats, lambda: headline.run(
        headline_path, coords0[pidx], masses[pidx], pidx, box, CUTOFF, dims, caps0, WINDOW,
        device, mesh=two))
    launches = _launches()
    gids, grmsd, gcount, gcheck = ghost
    n_windows = args.repeats * -(-len(ids) // WINDOW)
    if not (np.array_equal(ids, gids) and np.array_equal(count, gcount)
            and np.array_equal(check, gcheck)) or float(np.abs(rmsd - grmsd).max()) > 1e-6:
        raise AssertionError("mesh stream: results differ from the main path's")
    if launches["within_rows"] or min(launches["cell_bins"],
                                      launches["within_ghost"]) < 2 * n_windows:
        raise AssertionError(f"mesh stream: launches {launches}, expected two a window each")

    Task = _selection_task()
    gro = os.path.join(workdir, "conf.gro")
    plain, sharded = Task(), Task()
    plain.run(["-f", gro, headline_path], device=device)
    t0 = time.perf_counter()
    sharded.run(["-f", gro, headline_path, "--mesh", "2"], device=device)
    t_task = time.perf_counter() - t0
    if not (np.array_equal(sharded.results, plain.results)
            and np.array_equal(sharded.frame_ids, plain.frame_ids)):
        raise AssertionError("WindowAnalysisTask --mesh 2: results differ from one device")
    phase("mesh", devices_on_this_machine=torch.cuda.device_count(),
          frame_mesh=[str(d) for d in one.devices], two_shards=[str(d) for d in two.devices],
          windows_checked=f"{WINDOW},{MESH_RAGGED}", rmsd_max_abs_diff=worst_rmsd,
          host_ms_per_window=repr({k: round(v, 3) for k, v in ms.items()}),
          overhead_two_shards=ms["two_shards"] / ms["unsharded_with_copy"],
          stream_fps=[round(p, 3) for p in passes], stream_fps_median=float(np.median(passes)),
          windows_retried=retried, launches=launches, task_mesh2_s=round(t_task, 3),
          task_frames=len(sharded.frame_ids), results_equal=True)
    return launches


# ---------------------------------------------------------------- phase 20

# The rest of the host half on the card's machine: the headline's first
# HOST_FRAMES frames as a TRR and an AMBER NetCDF through phase 13's
# selection task, ``molar-torch last`` on the TRR, phase 14's first
# HOST_LIGANDS ligands through an SDF, perception, GAFF / GAFF2 and espaloma
# on the card, a SAS mesh of HOST_MESH_ATOMS protein atoms, and phase 12's
# ``membrane_dev`` bilayer through the host ``Membrane``,
# ``MembraneDevice(membrane)`` on the card and ``molar-torch membrane``.
HOST_FRAMES = 64
HOST_LIGANDS = 200
HOST_ESP_TOL = 1e-6
HOST_MESH_ATOMS = 1000
HOST_MESH_SPACING = 0.05
# A sanity bound, not parity: a voxel mesh at 0.05 nm reads a few per cent
# low against the exact area of scattered spheres.
HOST_MESH_RTOL = 0.15
# The NetCDF stores Angstrom in f32: its coordinates come back within a
# float32 ulp of the XTC's (<= 1e-6 nm in a 10 nm box).
HOST_NC_COORD_TOL = 1e-6
HOST_MEMBRANE_SIDE, HOST_MEMBRANE_FRAMES = MEMBRANE_SYSTEMS["membrane_dev"]
# membrane_dev's options with the leaflet groups of the ``membrane``
# command; the mid marker is C1, since a structure file's reader gives an
# atom named G no mass.
HOST_MEMBRANE_TOML = """
sel = "all"
cutoff = 2.0
order_type = "scdcorr"
output_dir = "{out}"
groups = ["upper", "lower"]

[lipids.LIP]
whole = "resname LIP"
head = "name P"
mid = "name C1"
tails = ["C1-C2-C3-C4"]
"""


def _host_formats(device, workdir, headline_path):
    """The TRR and NetCDF streams against the XTC's, and ``molar-torch
    last`` -> (kernel launches on the two streams, fps by format)."""
    import contextlib
    import io

    import torch

    from molar_tpu_torch import cli, headline
    from molar_tpu_torch.io import FileHandler
    from molar_tpu_torch.io.gro import write_gro

    top = headline.label_topology(ATOMS, PROTEIN)
    gro = os.path.join(workdir, "host_conf.gro")
    paths = {"xtc": headline_path, "trr": os.path.join(workdir, "host.trr"),
             "nc": os.path.join(workdir, "host.nc")}
    write_s = {}
    with FileHandler(headline_path) as h:
        states = [h.read_state() for _ in range(HOST_FRAMES)]
    write_gro(gro, top, states[0])
    for ext in ("trr", "nc"):
        t0 = time.perf_counter()
        with FileHandler(paths[ext], "w") as w:
            for st in states:
                w.write(None, st)
        write_s[ext] = round(time.perf_counter() - t0, 3)
    Task = _selection_task()
    results, fps, launches, windows, win = {}, {}, {}, {}, {}
    total = dict.fromkeys(KERNELS, 0)
    for ext in ("xtc", "trr", "nc"):
        task = Task()
        _reset_launches()
        t0 = time.perf_counter()
        n = task.run(["-f", gro, paths[ext], "-e", str(HOST_FRAMES - 1)], device=device)
        torch.cuda.synchronize()
        fps[ext] = n / (time.perf_counter() - t0)
        launches[ext] = _launches()
        if ext != "xtc":
            for k in total:
                total[k] += launches[ext][k]
        win[ext] = task.window
        windows[ext] = -(-HOST_FRAMES // task.window)
        ghost_nodes = sum(fs.compiled.ghost_nodes for fs in task.sels.values() if fs.compiled)
        want = ghost_nodes * windows[ext]
        if (n != HOST_FRAMES or launches[ext]["cell_bins"] != want
                or launches[ext]["within_ghost"] != want or launches[ext]["within_rows"]):
            raise AssertionError(f"host half, {ext} stream: {n} frames, launches "
                                 f"{launches[ext]} for {windows[ext]} windows of {ghost_nodes} "
                                 "within nodes: expected one cell_bins and one within_ghost a "
                                 "node a window")
        if not np.array_equal(task.frame_ids, np.arange(HOST_FRAMES)):
            raise AssertionError(f"host half, {ext} stream: frames {task.frame_ids[:4]}...")
        results[ext] = task.results
    differ = {ext: int((results[ext] != results["xtc"]).any(axis=2).sum())
              for ext in ("trr", "nc")}
    with FileHandler(paths["nc"]) as hn:
        nc_coord_err = max(float(np.abs(hn.read_state().coords - st.coords).max())
                           for st in states)

    # molar-torch last on the TRR: the last frame, as the GRO writer writes it.
    out = io.StringIO()
    last, want_last = os.path.join(workdir, "host_last.gro"), os.path.join(workdir, "want.gro")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["last", "-f", gro, paths["trr"], "-o", last])
    last_s = time.perf_counter() - t0
    write_gro(want_last, top, states[-1])
    last_equal = rc == 0 and open(last, "rb").read() == open(want_last, "rb").read()
    sizes = {ext: os.path.getsize(p) for ext, p in paths.items() if ext != "xtc"}
    phase("host_formats", frames=HOST_FRAMES, atoms=ATOMS, write_s=write_s,
          file_bytes=sizes, window=win, windows=windows,
          e2e_fps={e: round(v, 3) for e, v in fps.items()},
          fps_vs_xtc={e: round(fps[e] / fps["xtc"], 3) for e in ("trr", "nc")},
          launches=launches, frames_differing_from_xtc=differ,
          nc_coord_max_abs_err_nm=nc_coord_err, last_rc=rc, last_s=round(last_s, 3), last_gro_equal=last_equal,
          last_stdout=repr(out.getvalue().strip()))
    if any(differ.values()) or not nc_coord_err <= HOST_NC_COORD_TOL or not last_equal:
        raise AssertionError(f"host formats: frames whose counts differ from the xtc's "
                             f"{differ}, nc coords {nc_coord_err}, last equal {last_equal}")
    return total, fps


def _host_ligands(device, q14):
    """Phase 14's first HOST_LIGANDS ligands through an SDF, perception,
    GAFF / GAFF2 and espaloma charges on the card from the topologies read
    back -> the largest charge difference against phase 14's."""
    import copy

    from molar_tpu_torch.core.system import System
    from molar_tpu_torch.ff import espaloma
    from molar_tpu_torch.io.sdf import SdfHandler
    from molar_tpu_torch.ops.perception import perceive

    from torch_molecules import ligand_corpus, molecule_system

    corpus = ligand_corpus(HOST_LIGANDS)
    systems = [molecule_system(*m, seed=k) for k, m in enumerate(corpus)]
    path = os.path.join(tempfile.mkdtemp(prefix="host_sdf_"), "ligands.sdf")
    s = {}
    t0 = time.perf_counter()
    with SdfHandler(path, "w") as w:
        for m in systems:
            w.write(m.topology, m.state)
    s["sdf_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = []
    with SdfHandler(path) as r:
        for _ in systems:
            back.append(System(*r.read()))
    s["sdf_read"] = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    bad_columns = 0
    for m, b in zip(systems, back):
        mt_, bt = m.topology, b.topology
        fc = np.zeros(bt.n_atoms, np.int8) if bt.formal_charge is None else bt.formal_charge
        bad_columns += int(not (np.array_equal(mt_.atomic_number, bt.atomic_number)
                                and np.array_equal(mt_.bonds, bt.bonds)
                                and np.array_equal(mt_.bond_orders, bt.bond_orders)
                                and np.array_equal(mt_.formal_charge, fc)))
    tops = [copy.deepcopy(b.topology) for b in back]
    t0 = time.perf_counter()
    rings = [perceive(t) for t in tops]
    s["perceive"] = time.perf_counter() - t0
    n_aromatic = sum(len(p.aromatic_rings()) for p in rings)
    types = {}
    for ff in ("gaff", "gaff2"):
        t0 = time.perf_counter()
        types[ff] = [b.apply_ff(ff) for b in back]
        s[ff] = time.perf_counter() - t0
    espaloma.espaloma_charges(*corpus[0], device=device)
    t0 = time.perf_counter()
    q = [espaloma.apply_charges(b, device=device) for b in back]
    s["espaloma"] = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(q, q14[:HOST_LIGANDS]))
    untyped = sum(not all(lig) for ts in types.values() for lig in ts)
    phase("host_ligands", ligands=HOST_LIGANDS, atoms=sum(b.n_atoms for b in back),
          ms_per_ligand={k: round(v * 1e3 / HOST_LIGANDS, 4) for k, v in s.items()},
          columns_differing=bad_columns, aromatic_rings=n_aromatic,
          distinct_types={ff: len({t for lig in ts for t in lig}) for ff, ts in types.items()},
          untyped_ligands=untyped,
          max_abs_err_q_vs_phase14=err, tol=HOST_ESP_TOL)
    if bad_columns or untyped or not err <= HOST_ESP_TOL or not n_aromatic:
        raise AssertionError(f"host ligands: {bad_columns} columns differ, {untyped} untyped, "
                             f"charges off phase 14's by {err}")


def _host_mesh(device, headline_path):
    """``Sel.sas_mesh`` of HOST_MESH_ATOMS protein atoms beside the exact
    area of ``ops.sasa_lr`` on the card."""
    import torch

    import molar_tpu_torch as mt
    from molar_tpu_torch import headline
    from molar_tpu_torch.io import FileHandler
    from molar_tpu_torch.ops import sasa_lr, surface

    with FileHandler(headline_path) as h:
        system = mt.System(headline.label_topology(ATOMS, PROTEIN), h.read_state())
    sel = system(f"protein and index < {HOST_MESH_ATOMS}")
    t0 = time.perf_counter()
    verts, tris = sel.sas_mesh(spacing=HOST_MESH_SPACING)
    mesh_s = time.perf_counter() - t0
    area, volume = surface.mesh_area(verts, tris), surface.mesh_volume(verts, tris)
    radii = (system.topology.vdw()[sel.indices] + np.float32(0.14)).astype(np.float32)
    nbr, overflow = sasa_lr.neighbor_lists(sel.coords, radii, cap=USER_SASA_CAP)
    args_t = [torch.from_numpy(a).to(device) for a in (sel.coords, radii, nbr)]
    sasa_lr.sasa(*args_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = float(sasa_lr.sasa(*args_t).sum())
    exact_ms = (time.perf_counter() - t0) * 1e3
    phase("host_mesh", atoms=len(sel), spacing=HOST_MESH_SPACING, vertices=len(verts),
          triangles=len(tris), mesh_s=round(mesh_s, 3), mesh_area_nm2=area,
          mesh_volume_nm3=volume, exact_area_nm2=exact, card_exact_ms=round(exact_ms, 3),
          area_ratio=area / exact, nbr_overflow=bool(overflow))
    if overflow or not abs(area / exact - 1) <= HOST_MESH_RTOL:
        raise AssertionError(f"host mesh: area {area} against exact {exact}")


def _host_membrane(device, workdir):
    """membrane_dev through the host Membrane, MembraneDevice(membrane) on
    the card and ``molar-torch membrane`` on both routes: the CLI's group
    files with ``--device cpu`` equal the host route's byte for byte; the
    card's statistics and the CLI's files on the card (its default) within
    MEMBRANE_TOL of the host's; the card CLI's ``--vmd`` drawing of the last
    frame (an untimed run) byte-equal to the host Membrane's."""
    import contextlib
    import io

    import molar_tpu_torch as mt
    from molar_tpu_torch import cli
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.membrane import Membrane, MembraneDevice, split_leaflets
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    from torch_scenes import membrane_file_diffs, membrane_group_diffs

    bilayer = wl.synth_bilayer(HOST_MEMBRANE_SIDE, HOST_MEMBRANE_SIDE)
    n = len(bilayer.coords)
    nl = n // 6
    top = topology_from_numpy(["P", "G", "C1", "C2", "C3", "C4"] * nl, ["LIP"] * n,
                              np.repeat(np.arange(1, nl + 1), 6), np.repeat(np.arange(nl), 6),
                              ["A"] * n, np.full(n, 12.0), np.zeros(n), np.ones(n), np.zeros(n),
                              np.full(n, 6))
    gro, xtc = os.path.join(workdir, "bilayer.gro"), os.path.join(workdir, "bilayer.xtc")
    mt.System(top, State(coords=bilayer.coords, box=PeriodicBox(bilayer.box))).save(gro)
    wl.write_membrane_xtc(bilayer, xtc, HOST_MEMBRANE_FRAMES)
    outs = {r: os.path.join(workdir, f"membrane_{r}") for r in ("host", "card", "cli",
                                                                 "cli_card", "cli_vmd")}
    tomls = {}
    for route, out in outs.items():
        tomls[route] = os.path.join(workdir, f"membrane_{route}.toml")
        with open(tomls[route], "w") as fh:
            fh.write(HOST_MEMBRANE_TOML.format(out=out))

    system = mt.System.from_file(gro)
    host = Membrane(system, open(tomls["host"]).read())
    split_leaflets(host)
    t0 = time.perf_counter()
    frames = 0
    for _, st in TrajectoryReader([xtc]).iter_states():
        system.set_state(st)
        host.compute()
        frames += 1
    host_fps = frames / (time.perf_counter() - t0)
    host.finalize()

    csys = mt.System.from_file(gro)
    card_memb = Membrane(csys, open(tomls["card"]).read())
    split_leaflets(card_memb)
    dev = MembraneDevice(card_memb, device=device)
    card_frames, card_s, _ = wl.run_membrane(dev, xtc)
    card_memb.finalize()

    cli_s, rcs = {}, {}
    for route, extra in (("cli", ["--device", "cpu"]), ("cli_card", [])):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rcs[route] = cli.main(["membrane", "-f", gro, xtc, "-p", tomls[route], "--log", "0",
                                   *extra])
        cli_s[route] = time.perf_counter() - t0
    names = sorted(os.listdir(outs["host"]))
    cli_equal = rcs["cli"] == 0 and names == sorted(os.listdir(outs["cli"])) and all(
        open(os.path.join(outs["host"], f), "rb").read()
        == open(os.path.join(outs["cli"], f), "rb").read() for f in names)
    cli_card = (membrane_file_diffs(outs["host"], outs["cli_card"]) if rcs["cli_card"] == 0
                else {"rc": float("inf")})
    vmd = {r: os.path.join(workdir, f"membrane_{r}.tcl") for r in ("host", "cli_vmd")}
    host.write_vmd_visualization(vmd["host"])
    with contextlib.redirect_stdout(io.StringIO()):
        rcs["cli_vmd"] = cli.main(["membrane", "-f", gro, xtc, "-p", tomls["cli_vmd"], "--log",
                                   "0", "--vmd", vmd["cli_vmd"]])
    vmd_equal = rcs["cli_vmd"] == 0 and (open(vmd["host"], "rb").read()
                                        == open(vmd["cli_vmd"], "rb").read())
    diffs = membrane_group_diffs(host.groups, card_memb.groups)
    phase("host_membrane", lipids=nl, frames=frames, host_fps=host_fps,
          card_fps=card_frames / card_s, card_vs_host=(card_frames / card_s) / host_fps,
          card_engine=dev.engine_resolved, patch_cap=dev.patch_cap,
          cli_cpu_s=round(cli_s["cli"], 3), cli_card_s=round(cli_s["cli_card"], 3),
          cli_cpu_fps=frames / cli_s["cli"], cli_card_fps=frames / cli_s["cli_card"],
          files=names, cli_cpu_files_equal_host=cli_equal, cli_card_vmd_equal_host=vmd_equal,
          cli_card_files_worst_over_tol=repr({k: round(v, 4) for k, v in cli_card.items()}),
          card_vs_host_worst_over_tol=repr({k: round(v, 4) for k, v in diffs.items()}),
          valid_host_last_frame=sum(lip.valid for lip in host.lipids))
    if (not cli_equal or not vmd_equal or card_frames != frames
            or not all(v <= 1.0 for v in diffs.values())
            or not all(v <= 1.0 for v in cli_card.values())):
        raise AssertionError(f"host membrane: cli cpu files equal {cli_equal}, card vmd equal "
                             f"{vmd_equal}, card frames {card_frames}/{frames}, card vs host "
                             f"{diffs}, cli card files {cli_card}")


def _host_solvate(device, workdir, headline_path):
    """``molar-torch solvate`` of the headline's protein (5,000 atoms, its
    10 nm box) in a 216-water box tiled over it, on the card (its default)
    and with ``--device cpu``: the same file, byte for byte; each route's
    seconds."""
    import contextlib
    import io

    import molar_tpu_torch as mt
    from molar_tpu_torch import cli, headline
    from molar_tpu_torch.io import FileHandler

    from torch_scenes import water_box

    with FileHandler(headline_path) as fh:
        full = mt.System(headline.label_topology(ATOMS, PROTEIN), fh.read_state(),
                         device="cpu")
    solute, solvent = (os.path.join(workdir, f"{name}.gro") for name in ("solute", "water"))
    full("protein").to_system().save(solute)
    water_box().save(solvent)
    secs, said, outs = {}, {}, {}
    for route, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        outs[route] = os.path.join(workdir, f"solvated_{route}.gro")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["solvate", "-f", solute, "-s", solvent, "-o", outs[route], *extra])
        secs[route] = time.perf_counter() - t0
        said[route] = out.getvalue().strip().replace(outs[route], "OUT")
        if rc:
            raise AssertionError(f"solvate on the {route} route returned {rc}: {said[route]}")
    equal = open(outs["card"], "rb").read() == open(outs["cpu"], "rb").read()
    atoms = mt.System.from_file(outs["card"]).n_atoms
    phase("host_solvate", solute_atoms=PROTEIN, solvated_atoms=atoms,
          card_s=round(secs["card"], 3), cpu_s=round(secs["cpu"], 3),
          cpu_over_card=round(secs["cpu"] / secs["card"], 3), files_equal=equal,
          said=repr(said["card"]))
    if not equal or said["card"] != said["cpu"] or atoms <= PROTEIN:
        raise AssertionError(f"solvate: files equal {equal}, said {said}")


def _examples(device, workdir):
    """The six examples of ``molar_tpu_torch/examples`` on the card, on
    ``torch_scenes.example_inputs`` -> the kernel launches they made (the
    contacts example's ghost kernels, one pair a window)."""
    import contextlib
    import importlib
    import io

    from torch_scenes import example_argv, example_inputs

    d = os.path.join(workdir, "examples")
    os.makedirs(d)
    paths = example_inputs(d)
    _reset_launches()
    outputs, secs = {}, {}
    for name, argv in example_argv(paths).items():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = importlib.import_module(f"molar_tpu_torch.examples.{name}").main(argv)
        secs[name] = round(time.perf_counter() - t0, 3)
        outputs[name] = out.getvalue()
        if rc:
            raise AssertionError(f"example {name} returned {rc}")
    launches = _launches()

    def rows(name):
        return [line.split("\t") for line in outputs[name].splitlines() if "\t" in line]

    rmsd = [float(r) for _, r in rows("rmsd_trajectory")]
    counts = [int(c) for _, c in rows("contacts")]
    checks = {
        "rmsd_frames": len(rmsd) == 6 and max(rmsd) < 0.05,
        "contact_frames": len(counts) == 6 and min(counts) > 0,
        "report": all(k in outputs["structure_report"] for k in ("SASA:", "volume:", "DSSP:")),
        "membrane": "3 frames" in outputs["membrane_curvature"],
        "tip3to4": "3 waters converted" in outputs["tip3to4_tutorial"],
        "assign_ff": "rings" in outputs["assign_ff"],
        "launches": launches["cell_bins"] == launches["within_ghost"] == 2
        and not launches["within_rows"],
    }
    phase("examples", seconds=secs, launches=launches, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"examples: {checks}; outputs {outputs}")
    return launches


def phase_host_half(device, workdir, headline_path, q14):
    """Phase 20: the rest of the host half on the card's machine, the CLI's
    ``membrane`` and ``solvate`` on both routes, and the examples. Only the
    TRR and NetCDF streams (the ghost pair, once each a within node a
    window) and the contacts example (once each a window) launch kernels ->
    their launches."""
    launches, _ = _host_formats(device, workdir, headline_path)
    _reset_launches()
    _host_ligands(device, q14)
    _host_mesh(device, headline_path)
    _host_membrane(device, workdir)
    _host_solvate(device, workdir, headline_path)
    if any(_launches().values()):
        raise AssertionError(f"host half: kernels launched off the streams: {_launches()}")
    examples = _examples(device, workdir)
    return {k: v + examples[k] for k, v in launches.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    port = import_port()
    device, name, smi = phase_device(port)
    native_exe = phase_build()
    sys.path.insert(0, str(HERE / "tests"))
    seconds = {}

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    stats = timed("kernel_vs_plain", phase_kernel_vs_plain, device)
    from molar_tpu_torch import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    headline_path = os.path.join(workdir, "traj.xtc")
    try:
        launches, model, window, ghost, native_within0 = timed(
            "main_path", phase_main_path, device, args, native_exe, workdir)
        timed("stages_ghost", phase_stages, model, window)
        million, launches_million = timed("million", phase_million, device, args, native_exe,
                                          workdir)
        stats["within_rows"] = timed("rows_vs_plain", phase_rows_vs_plain, device)
        launches["within_rows"], rows_model, rows_window = timed(
            "rows_path", phase_rows_path, device, args, headline_path, ghost, native_within0,
            model, window)
        timed("stages_rows", phase_stages, rows_model, rows_window)
        dodeca = timed("dodecahedron", phase_dodecahedron, device, workdir)
        wl_system, wl_path, wl_meta = timed("workloads", phase_workloads, device, workdir)
        timed("grid_contacts", phase_grid_contacts, device, wl_system, wl_path, dodeca[0])
        timed("host_stream", phase_host_stream, device, args, headline_path, wl_system, wl_path)
        timed("sasa", phase_sasa, device, workdir, wl_system, wl_meta)
        timed("membrane", phase_membrane, device, workdir)
        launches_selection = timed("selection", phase_selection, device, args, workdir,
                                   headline_path, ghost, dodeca)
        launches_mesh = timed("mesh", phase_mesh, device, args, workdir, headline_path, ghost,
                              model, window)
        q14 = timed("espaloma", phase_espaloma, device)
        timed("trjconv_cli", phase_trjconv_cli, workdir, wl_system, wl_path, wl_meta)
        launches_user_api = timed("user_api", phase_user_api, device, workdir, headline_path)
        launches_host_half = timed("host_half", phase_host_half, device, workdir, headline_path,
                                   q14)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase("phase_seconds", **seconds)
    # The card's name and power limit again, beside the results at the end.
    print(smi, flush=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    import torch

    frames = args.repeats * args.frames
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[k], "launches_per_frame": launches[k] / frames,
        "launches_selection_path": launches_selection[k],
        "launches_million_path": launches_million[k], "launches_mesh_path": launches_mesh[k],
        "launches_user_api_path": launches_user_api[k],
        "launches_host_half_path": launches_host_half[k],
        **stats[k], "ms_per_frame": stats[k]["ms"] / stats[k]["frames_per_launch"],
        **{f"million_{kk}": v for kk, v in million.get(k, {}).items()},
    } for k, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
