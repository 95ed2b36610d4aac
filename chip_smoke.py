#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``molar_tpu_torch``) on one NVIDIA GPU.

Drives the trajectory headline through the port's own entry points: a
100k-atom XTC streamed in i8 delta windows, each frame fitted (mass-weighted
Kabsch RMSD of a 5k-atom "protein") and searched (0.5 nm periodic ``within``
of every atom against the protein), through each of the port's three search
routes: the hand-written ghost-slab CUDA kernel and the hand-written
row-tiled per-pair min-image CUDA kernel on the headline's cubic box, and
the triclinic correction path (plain torch) on a rhombic dodecahedron of
the same density. Weights do not exist here; the systems and their
trajectories are made from seeds. Phases, one line each on stdout:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernel, the XTC codec and the native C++ reference, from
   the sources in this checkout;
3. kernel vs plain: the kernel's mask against its plain PyTorch twin on the
   same CUDA tensors (exact equality), on the scenes of
   ``tests/torch_scenes.py`` (random, cutoff ties, tiny and collapsed
   periodic grids, partial PBC), an overflow scene and the headline shape,
   with both times at the headline shape;
4. main path: write the trajectory, stream it with overflow retry, count
   kernel launches, check frame 0 against the native C++ program and frames
   0 / mid / last against the plain path run on the CPU, and report fps,
   the host decode / H2D / device split and the device's busy share;
5. stages: one resident window, stage by stage, host enqueue and device
   time of each stage and the number of device operations;
6. rows kernel vs plain: the row kernel's mask and overflow flag against
   its plain twin on the same CUDA tensors (exact equality) on the
   orthorhombic full-PBC scenes (a 2-cell axis among them), an overflow
   scene and the headline shape, with both times at the headline shape;
7. rows path: the main path's trajectory through ``search="rows"``:
   every frame's count and checksum equal the ghost path's, frames 0 / mid
   / last the CPU run of the row twin, frame 0 the native C++ program, no
   host sync inside a window (as in 8); fps, the device's busy share and
   the row kernel's launches;
8. dodecahedron path: 100k atoms (a 5k-atom protein ball) in a rhombic
   dodecahedron at 100 atoms/nm^3, 64 frames through the sparse-target
   correction path with overflow retry: frames 0 / mid / last against the
   CPU path, frame 0 on a seeded sample of 5,000 atoms against a float64
   brute force over the lattice images, no host sync inside a window
   (``torch.cuda.set_sync_debug_mode("error")`` over a window, and the
   window captured into a CUDA graph, whose replay equals the eager run),
   fps and the device's busy share.

Each path resets every kernel's launch count just before it and reads the
counts just after: the ghost path must launch only the ghost kernel, the
rows path only the row kernel, and the dodecahedron path neither.

Any failure raises, and then the script exits non-zero without its last
line. The last line is ``{"ok": true, "device": {...}}``; the line before it
is the per-kernel JSON record. The script needs a CUDA device and imports no
JAX.

The system is ``bench.py``'s headline at its defaults and is not an option
here: only the headline's frame count and number of timed passes are.

Usage: python3 chip_smoke.py [--frames 256] [--repeats 5]
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
    "within_ghost": ("molar_tpu_torch/csrc/within_ghost.cu", "molar_tpu/ops/neighbor_pallas.py:200"),
    "within_rows": ("molar_tpu_torch/csrc/within_rows.cu", "molar_tpu/ops/neighbor_pallas.py:43"),
}

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
STAGES = ("decode", "fit_rmsd", "search_args", "ghost_inputs", "stencil", "unsort_mask",
          "checksum")


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
    ptxas = " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line
    )
    phase("build", kernel_s=round(t_kernel, 3),
          total_s=round(time.perf_counter() - t0, 3),
          artifacts=",".join(p.name for p in (lib, codec, native)), ptxas=repr(ptxas))
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


def _device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: (wall ms, device-busy ms as the
    union of kernel and copy intervals, top device ops by self time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    ops = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.self_device_time_total > 0 and not e.key.startswith(("void ", "(anon"))),
                 key=lambda kv: -kv[1])
    return wall * 1e3, busy / 1e3, [(k, round(v / 1e3, 3)) for k, v in ops[:4]]


def _kernel_vs_plain(device, label, scenes, search, planes, kernel, twin):
    """One kernel against its plain twin on the same CUDA tensors: exact mask
    and overflow-flag equality on ``scenes`` plus one whose caps are too
    small, the tie scenes' members, and the hit blocks at the headline shape;
    then both times there, in turns plain / kernel / kernel / plain.

    ``search(coords, src, tgt, cutoff, box, inv, dims, pbc, cap, tgt_cap,
    plain)`` runs the whole search; ``planes(coords, tgt, box, inv, dims,
    cap, tgt_cap)`` builds the headline shape's kernel inputs, which
    ``kernel`` and ``twin`` take, followed by the squared cutoff."""
    import torch

    from molar_tpu_torch import headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import _cutoff2, estimate_caps, grid_dims_for

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

    # The headline shape: frame-0 coordinates of the main path's system.
    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, _ = headline.make_system(ATOMS, PROTEIN, box.matrix)
    dims = grid_dims_for(box, CUTOFF)
    pidx = np.arange(PROTEIN)
    caps0 = estimate_caps(coords0, box.inv, dims, pidx, margin=1.0, round_to=1)
    cap, tcap, _ = headline.caps_for(*caps0, 0)
    c, tg, bm, bi = t(coords0), t(pidx), t(box.matrix), t(box.inv)
    call = (c, None, tg, CUTOFF, bm, bi, dims, (True,) * 3, cap, tcap)
    mk, ok_ = search(*call, False)
    mp, op_ = search(*call, True)
    if bool(ok_) or bool(op_) or not torch.equal(mk, mp):
        raise AssertionError(f"{label} headline shape: kernel and plain disagree or overflow")
    checked.append("headline")
    inputs = (*planes(c, tg, bm, bi, dims, cap, tcap), _cutoff2(CUTOFF))
    max_err = int((kernel(*inputs).int() - twin(*inputs).int()).abs().max())
    if max_err:
        raise AssertionError(f"{label} headline shape: stencil hit blocks differ")
    times = {"plain": [], "kernel": [], "plain_call": [], "kernel_call": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            if which == "kernel":
                times["kernel"].append(_cuda_ms(lambda: kernel(*inputs), 50))
                times["kernel_call"].append(_cuda_ms(lambda: search(*call, False), 20))
            else:
                times["plain"].append(_cuda_ms(lambda: twin(*inputs), 10))
                times["plain_call"].append(_cuda_ms(lambda: search(*call, True), 10))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    phase(label, scenes=len(checked), all_equal=True,
          headline_shape=f"n={ATOMS},tgt={PROTEIN},dims={dims},cap={cap},tgt_cap={tcap}",
          stencil_kernel_ms=ms["kernel"], stencil_plain_ms=ms["plain"],
          call_kernel_ms=ms["kernel_call"], call_plain_ms=ms["plain_call"],
          stencil_kernel_ms_runs=repr([round(v, 5) for v in times["kernel"]]),
          stencil_plain_ms_runs=repr([round(v, 4) for v in times["plain"]]),
          names=",".join(checked))
    return {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["plain"]}


def phase_kernel_vs_plain(device):
    """The ghost kernel against ``_ghost_stencil`` on every shared scene."""
    from molar_tpu_torch.ops.neighbor import _ghost_inputs, _search_args, within_mask
    from molar_tpu_torch.ops.neighbor_ghost import _ghost_stencil, within_ghost

    from torch_scenes import SCENES

    def search(c, s, tg, cut, bm, bi, dims, pbc, cap, tcap, plain):
        return within_mask(c, s, tg, cut, bm, bi, dims=dims, cap=cap, tgt_cap=tcap, pbc=pbc,
                           plain=plain)

    def planes(c, tg, bm, bi, dims, cap, tcap):
        src, ghost, *_ = _ghost_inputs(*_search_args(c, None, tg, bm, bi, dims), bm, dims, cap,
                                       tcap, (True,) * 3)
        return src, ghost, dims, cap, tcap

    return _kernel_vs_plain(device, "kernel_vs_plain", SCENES, search, planes, within_ghost,
                            _ghost_stencil)


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
    launches, rows_launches = _launches()
    if rows_launches:
        raise AssertionError("the ghost path launched the row kernel")
    if len(ids) != args.frames or not np.array_equal(ids, np.arange(args.frames)):
        raise AssertionError(f"stream returned frames {ids[:4]}... ({len(ids)})")
    if launches < args.repeats * args.frames:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{args.repeats} x {args.frames} frames")
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
    prof_wall, prof_busy, prof_top = _device_profile(
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


def phase_stages(model, window):
    """One resident window through the steps of ``FitWithinWindow.forward``,
    stage by stage: host enqueue ms of each stage (host clock, no profiler,
    no synchronize inside the pass), device ms of each stage (the kernels
    ``torch.profiler`` attributes to it, in a second pass), and the number of
    device operations in the window."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from molar_tpu_torch.ops.measure import fit_rmsd
    from molar_tpu_torch.ops.neighbor import _cutoff2, _ghost_inputs, _search_args, _unsort_mask
    from molar_tpu_torch.ops.neighbor_ghost import within_ghost
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
        ids1 = torch.arange(1, coords.shape[1] + 1, device=coords.device)
        for b in range(coords.shape[0]):
            sa = stage("search_args", _search_args, coords[b], None, m.protein_idx,
                       boxes[b], invs[b], m.dims)
            src, ghost, slot, order, _ = stage("ghost_inputs", _ghost_inputs, *sa, boxes[b],
                                               m.dims, m.cap, m.tgt_cap, (True, True, True))
            hit = stage("stencil", within_ghost, src, ghost, m.dims, m.cap, m.tgt_cap,
                        _cutoff2(m.cutoff))
            mask = stage("unsort_mask", _unsort_mask, hit, slot, order, coords.shape[1])
            stage("checksum", lambda: (mask.sum(), (ids1 * mask).sum() & 0xFFFFFFFF))

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
    # A stage's device work is what runs inside its range on the device's
    # timeline (one stream, so the ranges do not overlap). The profiler ties
    # no kernel launched through ctypes to a host-side range, so the
    # device-side ranges are the ones read.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.name[6:], e.time_range.start, e.time_range.end)
              for e in device if e.name.startswith("stage:")]
    ops = [e.time_range for e in device if not e.name.startswith("stage:")]
    device_ms = dict.fromkeys(STAGES + ("outside",), 0.0)
    for tr in ops:
        name = next((n for n, lo, hi in ranges if lo <= tr.start and tr.end <= hi), "outside")
        device_ms[name] += (tr.end - tr.start) / 1e3
    if not ops or device_ms["stencil"] <= 0:
        raise AssertionError("the profiler saw no device work in the window's stages")
    frames = window[1].shape[0]
    phase("stages", frames=frames, wall_ms=wall, host_enqueue_ms=sum(host_ms.values()),
          device_ms=sum(device_ms.values()), device_ops=len(ops),
          device_ops_per_frame=len(ops) / frames,
          host_ms=repr({k: round(v, 4) for k, v in host_ms.items()}),
          stage_device_ms=repr({k: round(v, 4) for k, v in device_ms.items()}))


# ---------------------------------------------------------------- phase 6


def phase_rows_vs_plain(device):
    """The row kernel against ``_rows_stencil`` on the orthorhombic
    full-PBC scenes (a 2-cell axis among them)."""
    from molar_tpu_torch.ops.neighbor_rows import (
        _rows_inputs, _rows_stencil, within_mask_rows, within_rows,
    )

    from torch_scenes import ROW_SCENES

    def search(c, s, tg, cut, bm, bi, dims, pbc, cap, tcap, plain):
        return within_mask_rows(c, s, tg, cut, bm, bi, dims, cap=cap, tgt_cap=tcap, plain=plain)

    def planes(c, tg, bm, bi, dims, cap, tcap):
        src, tgt, lengths, *_ = _rows_inputs(c, None, tg, bm, bi, dims, cap, tcap)
        return src, tgt, lengths, dims, cap, tcap

    return _kernel_vs_plain(device, "rows_vs_plain", ROW_SCENES, search, planes, within_rows,
                            _rows_stencil)


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


def _reset_launches():
    from molar_tpu_torch.ops import neighbor_ghost, neighbor_rows

    neighbor_ghost.within_ghost.launches = 0
    neighbor_rows.within_rows.launches = 0


def _launches():
    from molar_tpu_torch.ops import neighbor_ghost, neighbor_rows

    return neighbor_ghost.within_ghost.launches, neighbor_rows.within_rows.launches


def phase_rows_path(device, args, path, ghost, native_within0):
    """The main path's trajectory through the row kernel (``search="rows"``)."""
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

    _reset_launches()
    (ids, rmsd, count, check, retried), passes = _timed_passes(args.repeats, lambda: headline.run(
        path, ref, pmass, pidx, box, CUTOFF, dims, caps0, WINDOW, device, search="rows"))
    ghost_launches, launches = _launches()
    if ghost_launches or launches < args.repeats * args.frames:
        raise AssertionError(f"rows path: {launches} row-kernel and {ghost_launches} ghost-kernel "
                             f"launches for {args.repeats} x {args.frames} frames")
    prof_wall, prof_busy, prof_top = _device_profile(lambda: [model(*w) for w in dev_windows])
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
          rmsd_max_abs_err_vs_cpu=rmsd_err, launches=launches, ghost_launches=ghost_launches,
          no_sync_window=True, window_enqueue_ms=enqueue_ms)
    if vs_ghost or parity or native_parity or rmsd_err > 1e-5:
        raise AssertionError(f"rows path parity failed: vs_ghost={vs_ghost} parity_diff={parity} "
                             f"native_parity_diff={native_parity} rmsd_err={rmsd_err}")
    return launches


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
    if any(kernel_launches):
        raise AssertionError(f"the correction path launched kernels {kernel_launches}")
    if not np.array_equal(ids, np.arange(DODECA_FRAMES)):
        raise AssertionError(f"dodecahedron stream returned frames {ids[:4]}... ({len(ids)})")
    if not (np.isfinite(rmsd).all() and (count > 0).all()):
        raise AssertionError("dodecahedron: non-finite RMSD or empty within set")
    prof_wall, prof_busy, prof_top = _device_profile(
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    port = import_port()
    device, name, _ = phase_device(port)
    native_exe = phase_build()
    sys.path.insert(0, str(HERE / "tests"))
    stats = {"within_ghost": phase_kernel_vs_plain(device)}
    from molar_tpu_torch import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    try:
        launches, model, window, ghost, native_within0 = phase_main_path(
            device, args, native_exe, workdir)
        phase_stages(model, window)
        stats["within_rows"] = phase_rows_vs_plain(device)
        rows_launches = phase_rows_path(device, args, os.path.join(workdir, "traj.xtc"), ghost,
                                        native_within0)
        phase_dodecahedron(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    import torch

    counts = {"within_ghost": launches, "within_rows": rows_launches}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": replaces,
        "launches": counts[k], **stats[k],
    } for k, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
