#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``molar_tpu_torch``) on one NVIDIA GPU.

Drives the trajectory headline through the port's own entry points: a
100k-atom XTC streamed in i8 delta windows, each frame fitted (mass-weighted
Kabsch RMSD of a 5k-atom "protein") and searched (0.5 nm periodic ``within``
of every atom against the protein), through each of the port's three search
routes: the hand-written ghost-slab CUDA kernels (a counting-sort binning of
the window into cells, then a 27-cell stencil, two launches a window) and
the hand-written per-pair min-image CUDA kernel over the same binning (two
launches a window too) on the headline's cubic box, and the triclinic
correction path (plain torch) on a rhombic dodecahedron of the same density.
Then the four selection workloads (CA-RMSD, per-residue COM and gyration,
protein-ligand contact lists, the three fused) stream a 50,000-atom solvated
protein over windows that carry only their selections' rows. Weights do not
exist here; the systems and their trajectories are made from seeds. Phases,
one line each on stdout (the workloads a line each):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels, the XTC codec and the native C++ reference,
   from the sources in this checkout;
3. ghost kernels vs plain: masks and overflow flags against the plain twin
   on the same CUDA tensors (exact equality) on the scenes of
   ``tests/torch_scenes.py`` (random, cutoff ties and their members, tiny
   and collapsed periodic grids, partial PBC, a crowded scene that needs
   chunked staging) and an overflow scene; then a full 16-frame headline
   window: the masks against the twin, the binning kernel's per-cell counts
   against ``torch.bincount`` and its per-cell members (positions and
   coordinates) against the plain plane build, the stencil kernel against
   its twin on the same cell records; each kernel's time, its twin's and its
   bound (bytes or operations, from this window's data);
4. main path: write the trajectory, stream it with overflow retry, count
   kernel launches, check frame 0 against the native C++ program and frames
   0 / mid / last against the plain path run on the CPU, and report fps,
   the host decode / H2D / device split and the device's busy share;
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
   records; then the 16-frame headline window the same way, with the
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
   dodecahedron at 100 atoms/nm^3, 64 frames through the sparse-target
   correction path with overflow retry: frames 0 / mid / last against the
   CPU path, frame 0 on a seeded sample of 5,000 atoms against a float64
   brute force over the lattice images, no host sync inside a window
   (``torch.cuda.set_sync_debug_mode("error")`` over a window, and the
   window captured into a CUDA graph, whose replay equals the eager run),
   fps and the device's busy share;
9. workloads path: ``benchmarks/workloads.py``'s system at its defaults
   (50,000 atoms, a 4,000-atom protein, an 8 nm box, 0.4 nm contacts) over
   1,024 frames, each workload through ``molar_tpu_torch.workloads.run``
   (``TrajectoryReader`` -> ``WindowPipeline`` with the subset -> its
   module) at the window ``auto_window`` picks: fps of 3 passes, host
   enqueue and device ms of a window by stage, device operations a frame,
   the top device operations, the device's busy share; the module on the
   CPU against the card on the first, a middle and the last window (RMSD
   within 1e-5, COM and gyration within 1e-5 relative, contact counts and
   pair lists equal); no host sync inside a window (as in 8), which is the
   test of the pair-list compaction (its time beside a ``nonzero_static``
   a frame); no pair-list overflow and some contacts; then a sweep of the
   window size on ``ca_rmsd`` and ``contacts`` (one line a size), and last
   the single-core C++ program ``benchmarks/native_workloads.cpp`` on the
   same file and sidecar, whose check scalars the card's must match within
   2e-3 relative (it runs after the device passes, never beside them).

Each path resets every kernel's launch count just before it and reads the
counts just after: the ghost path must launch only the two ghost kernels,
the rows path the binning kernel and the row kernel once a window each and
never the ghost stencil, and the dodecahedron and workloads paths none.

Any failure raises, and then the script exits non-zero without its last
line. The last line is ``{"ok": true, "device": {...}}``; the line before it
is the per-kernel JSON record (launches on the main path, time, the plain
twin's time and the bound, each per launch). The script needs a CUDA
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
# and the window its auto-sizing picks at 100k atoms.
ATOMS = 100_000
PROTEIN = 5_000
BOX = 10.0
CUTOFF = 0.5
WINDOW = 16
# The dodecahedron path: image distance d with d^3 * sqrt(2)/2 = 1000 nm^3
# (the headline's volume, so 100 atoms/nm^3; a grid of 18 x 18 x 15 cells
# from the cell heights), 64 frames, 3 timed passes.
DODECA_D = (1000.0 * np.sqrt(2.0)) ** (1 / 3)
DODECA_DIMS = (18, 18, 15)
DODECA_FRAMES = 64
DODECA_REPEATS = 3
BRUTE_SAMPLE = 5000
STAGES = ("decode", "fit_rmsd", "search", "checksum")
# The workloads path: benchmarks/workloads.py's defaults (--atoms, --protein,
# the 8 nm box), 1,024 frames, 3 timed passes a workload, and the window
# sizes of the sweep.
WL_ATOMS = 50_000
WL_PROTEIN = 4_000
WL_BOX = 8.0
WL_FRAMES = 1024
WL_REPEATS = 3
WL_SWEEP = (16, 32, 64, 128, 256, 512)
WL_STAGES = {"ca_rmsd": ("decode", "fit_rmsd"), "com_splits": ("decode", "com_gyration"),
             "contacts": ("decode", "contacts"),
             "fused": ("decode", "fit_rmsd", "com_gyration", "contacts")}
# How each per-frame output of a workload's module is held against the CPU
# run: "abs" within 1e-5, "rel" within 1e-5 relative, "equal".
WL_OUTPUTS = {"ca_rmsd": (("rmsd", "abs"),),
              "com_splits": (("com", "rel"), ("gyr", "rel")),
              "contacts": (("count", "equal"), ("overflow", "equal")),
              "fused": (("rmsd", "abs"), ("gyr", "rel"), ("count", "equal"),
                        ("overflow", "equal"))}


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
          nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda)
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
    """A full 16-frame headline window at tier-0 caps: frame 0 of the main
    path's system plus a seeded 0.02 nm random walk, as
    ``headline.write_trajectory`` makes it -> (coords (16, N, 3), protein
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
    through ``within_mask``, then a full 16-frame headline window through
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
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

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

    # Host side alone: decode every delta window.
    reader = TrajectoryReader([path])
    t0 = time.perf_counter()
    windows = list(reader.iter_windows(WINDOW, quantized="delta"))
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
    operations. A stage's device work is what runs inside its range on the
    device's timeline (one stream, so the ranges do not overlap). The
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
        name = next((n for n, lo, hi in ranges if lo <= tr.start and tr.end <= hi), "outside")
        by_stage[name] = by_stage.get(name, 0.0) + (tr.end - tr.start) / 1e3
    return by_stage, len(ops)


def phase_stages(model, window):
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
    phase("stages", route=m.search, frames=frames, wall_ms=wall,
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
    and the crowded one as windows, then the 16-frame headline window with
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
    windows = TrajectoryReader([path]).iter_windows(WINDOW, quantized="delta")
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
    """The triclinic correction path on a rhombic dodecahedron."""
    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import grid_dims_for
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

    from torch_scenes import brute_within, dodecahedron

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
    model = convert.from_numpy(ref, pmass, pidx, box.matrix, CUTOFF, headline.caps_for(*caps0, 0),
                               dims, device)
    if model.search != "corrections":
        raise AssertionError(f"the dodecahedron took route {model.search}")
    dev_windows = [convert.transport_to_torch(w, device) for w in
                   TrajectoryReader([path]).iter_windows(WINDOW, quantized="delta")]
    enqueue_ms = _no_sync_window(model, dev_windows[0])

    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(
        DODECA_REPEATS, lambda: headline.run(path, ref, pmass, pidx, box, CUTOFF, dims,
                                                  caps0, WINDOW, device))
    kernel_launches = _launches()
    if any(kernel_launches.values()):
        raise AssertionError(f"the correction path launched kernels {kernel_launches}")
    if not np.array_equal(ids, np.arange(DODECA_FRAMES)):
        raise AssertionError(f"dodecahedron stream returned frames {ids[:4]}... ({len(ids)})")
    if not (np.isfinite(rmsd).all() and (count > 0).all()):
        raise AssertionError("dodecahedron: non-finite RMSD or empty within set")
    prof_wall, prof_busy, prof_top, _ = _device_profile(
        lambda: [model(*w) for w in dev_windows[:2]])

    parity, rmsd_err = _cpu_parity(path, (rmsd, count, check), ref, pmass, pidx, box, dims,
                                   caps0)
    # Frame 0 on a seeded sample of atoms against the float64 brute force.
    transport, boxes, invs = dev_windows[0]
    masks, _ = model.masks(decode_window_coords(transport), boxes, invs)
    mask0 = masks[0].cpu().numpy()
    with XtcHandler(path) as h:
        frame0 = h.read_frame(0).coords
    sample = np.sort(np.random.default_rng(2).choice(ATOMS, BRUTE_SAMPLE, replace=False))
    t0 = time.perf_counter()
    want, dmin = brute_within(frame0, sample, pidx, box.matrix, CUTOFF)
    t_brute = time.perf_counter() - t0
    brute_mismatch = int((mask0[sample] != want).sum())
    phase("dodecahedron_path", atoms=ATOMS, protein=PROTEIN, d_nm=DODECA_D, dims=dims,
          frames=len(ids), window=WINDOW, caps_tier0=headline.caps_for(*caps0, 0),
          e2e_fps=[round(p, 3) for p in passes], e2e_fps_best=max(passes),
          e2e_fps_median=float(np.median(passes)), windows_retried=retried,
          profiled_wall_ms=prof_wall, device_busy_ms=prof_busy,
          device_busy_share=prof_busy / prof_wall, top_device_ops=repr(prof_top),
          within0=int(count[0]), mean_rmsd=float(np.mean(rmsd)), parity_diff=parity,
          rmsd_max_abs_err_vs_cpu=rmsd_err, brute_sample=BRUTE_SAMPLE,
          brute_hits=int(want.sum()), brute_mismatch=brute_mismatch,
          brute_min_rel_gap=float(np.abs(dmin / CUTOFF - 1).min()), brute_s=round(t_brute, 3),
          kernel_launches=kernel_launches, no_sync_window=True, window_enqueue_ms=enqueue_ms)
    if parity or brute_mismatch or rmsd_err > 1e-5:
        raise AssertionError(f"dodecahedron parity failed: parity_diff={parity} "
                             f"brute_mismatch={brute_mismatch} rmsd_err={rmsd_err}")


# ---------------------------------------------------------------- phase 9


def _workload_window(model, window, stages):
    """One resident window through a workload's module -> (wall ms, host
    enqueue ms, device ms by stage, device operations, the three device
    operations with the most self time). The host clock runs without the
    profiler; the device times come from a later, profiled pass, in which
    every one of ``stages`` must show device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model(*window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(*window)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # A trace can lack the first device operations after the profiler
        # starts (a dozen, when other profiles ran before in the process):
        # a pass that is not read goes first.
        model(*window)
        torch.cuda.synchronize()
        model(*window)
        torch.cuda.synchronize()
    by_stage, n_ops = _stage_device_ms(prof, last_pass_from=stages[0])
    missing = [k for k in stages if by_stage.get(k, 0.0) <= 0]
    if missing or by_stage.get("outside", 0.0) > 0.05 * sum(by_stage.values()):
        raise AssertionError(f"stages {missing} have no device work in the trace: {by_stage}")
    # Both passes are in the averages: halve them.
    top = [(k, round(ms / 2, 4)) for k, ms in _device_ops(prof)[:3]]
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
    for name in wl.WORKLOADS:
        model, subset = convert.workload_from_numpy(name, system, device)
        cpu_model, _ = convert.workload_from_numpy(name, system, "cpu")
        window = auto_window(path, subset)
        t0 = time.perf_counter()
        host_windows = list(TrajectoryReader([path]).iter_windows(window, quantized="delta",
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
    for name in wl.WORKLOADS:
        native = wl.run_native(name, path, meta)
        bad = wl.native_mismatches(checks[name], native)
        phase("workload_native", name=name, native_fps=native["fps"], frames=native["frames"],
              native_checks=repr({k: native[k] for k in checks[name]}),
              checks=repr(checks[name]), rtol=wl.CHECK_RTOL, mismatches=len(bad))
        if bad or native["frames"] != WL_FRAMES:
            raise AssertionError(f"{name}: check scalars off the native program's: {bad}")
    phase("workloads_path", workloads=len(checks), frames=WL_FRAMES, write_s=round(t_write, 3),
          kernel_launches=launches, all_checks_passed=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    port = import_port()
    device, name, _ = phase_device(port)
    native_exe = phase_build()
    sys.path.insert(0, str(HERE / "tests"))
    stats = phase_kernel_vs_plain(device)
    from molar_tpu_torch import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    try:
        launches, model, window, ghost, native_within0 = phase_main_path(
            device, args, native_exe, workdir)
        phase_stages(model, window)
        stats["within_rows"] = phase_rows_vs_plain(device)
        launches["within_rows"], rows_model, rows_window = phase_rows_path(
            device, args, os.path.join(workdir, "traj.xtc"), ghost, native_within0, model, window)
        phase_stages(rows_model, rows_window)
        phase_dodecahedron(device, workdir)
        phase_workloads(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    import torch

    frames = args.repeats * args.frames
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[k], "launches_per_frame": launches[k] / frames, **stats[k],
        "ms_per_frame": stats[k]["ms"] / stats[k]["frames_per_launch"],
    } for k, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
