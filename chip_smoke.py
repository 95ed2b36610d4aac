#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``molar_tpu_torch``) on one NVIDIA GPU.

Drives the trajectory headline through the port's own entry points: a
100k-atom XTC streamed in i8 delta windows, each frame fitted (mass-weighted
Kabsch RMSD of a 5k-atom "protein") and searched (0.5 nm periodic ``within``
of every atom against the protein) through the hand-written ghost-slab CUDA
kernel. Weights do not exist here; the system and its trajectory are made
from seeds. Phases, one line each on stdout:

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
   time of each stage and the number of device operations.

Any failure raises, and then the script exits non-zero without its last
line. The last line is ``{"ok": true, "device": {...}}``; the line before it
is the per-kernel JSON record. The script needs a CUDA device and imports no
JAX.

The system is ``bench.py``'s headline at its defaults and is not an option
here: only the frame count and the number of timed passes are.

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
KERNEL_SOURCE = "molar_tpu_torch/csrc/within_ghost.cu"
KERNEL_REPLACES = "molar_tpu/ops/neighbor_pallas.py:200"

# bench.py's headline settings: --atoms, --protein, --box (nm), --cutoff (nm),
# and the window its auto-sizing picks at 100k atoms.
ATOMS = 100_000
PROTEIN = 5_000
BOX = 10.0
CUTOFF = 0.5
WINDOW = 16
STAGES = ("decode", "fit_rmsd", "search_args", "ghost_inputs", "stencil", "unsort_mask",
          "checksum")


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"# {label}: {body}", flush=True)


def import_port():
    """The port package of THIS checkout (never an installed copy)."""
    if not (HERE / KERNEL_SOURCE).is_file():
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


def phase_kernel_vs_plain(device):
    import torch

    from molar_tpu_torch import headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import (
        _cutoff2, _ghost_inputs, _search_args, estimate_caps, grid_dims, within_mask,
    )
    from molar_tpu_torch.ops.neighbor_ghost import _ghost_stencil, within_ghost

    def t(a):
        return torch.as_tensor(a, device=device)

    sys.path.insert(0, str(HERE / "tests"))
    from torch_scenes import SCENES, TIE_MEMBERS, scene

    # Every shared scene as it is, plus one whose caps are too small.
    runs = [(name, name, {}) for name in SCENES] + [("overflow", "random19", {"cap": 2})]
    checked = []
    for label, name, over in runs:
        coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
        kw = {"cap": cap, "pbc": pbc, **over}
        box = PeriodicBox(np.diag(sides))
        dims = grid_dims(box.box_extents(), cutoff)
        args_ = (t(coords), None if src is None else t(src), t(tgt), cutoff,
                 t(box.matrix), t(box.inv))
        mk, ok_ = within_mask(*args_, dims=dims, **kw)
        mp, op_ = within_mask(*args_, dims=dims, **kw, plain=True)
        torch.cuda.synchronize()
        ofl = bool(ok_)
        if ofl != bool(op_):
            raise AssertionError(f"{label}: overflow flags differ (kernel {ofl}, plain {bool(op_)})")
        if ofl != (label == "overflow"):
            raise AssertionError(f"{label}: overflow flag is {ofl}")
        if not ofl and not torch.equal(mk, mp):
            raise AssertionError(f"{label}: kernel mask != plain mask "
                                 f"({int((mk != mp).sum())} of {mk.numel()} differ)")
        if name in TIE_MEMBERS:
            got = src[mk.cpu().numpy()].tolist()
            if got != TIE_MEMBERS[name]:
                raise AssertionError(f"{label}: members {got} != {TIE_MEMBERS[name]}")
        checked.append(label)

    # The headline shape: frame-0 coordinates of the main path's system.
    coords0, _ = headline.make_system(ATOMS, PROTEIN, BOX)
    box = PeriodicBox(np.diag([BOX] * 3))
    dims = grid_dims(box.box_extents(), CUTOFF)
    pidx = np.arange(PROTEIN)
    cap0, tcap0, _ = estimate_caps(coords0, box.inv, dims, pidx, margin=1.0, round_to=1)
    cap, tcap = headline.caps_for(cap0, tcap0, 0)
    c, tg, bm, bi = t(coords0), t(pidx), t(box.matrix), t(box.inv)
    kw = dict(dims=dims, cap=cap, tgt_cap=tcap)
    mk, ok_ = within_mask(c, None, tg, CUTOFF, bm, bi, **kw)
    mp, op_ = within_mask(c, None, tg, CUTOFF, bm, bi, **kw, plain=True)
    if bool(ok_) or bool(op_) or not torch.equal(mk, mp):
        raise AssertionError("headline shape: kernel and plain disagree or overflow")
    checked.append("headline")
    sa = _search_args(c, None, tg, bm, bi, dims)
    src_p, ghost_p, *_ = _ghost_inputs(*sa, bm, dims, cap, tcap, (True,) * 3)
    c2 = _cutoff2(CUTOFF)
    hk = within_ghost(src_p, ghost_p, dims, cap, tcap, c2)
    hp = _ghost_stencil(src_p, ghost_p, dims, cap, tcap, c2)
    max_err = int((hk.int() - hp.int()).abs().max())
    if max_err:
        raise AssertionError("headline shape: stencil hit blocks differ")
    # Alternate plain / kernel / kernel / plain inside this one call.
    times = {"plain": [], "kernel": [], "plain_call": [], "kernel_call": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            if which == "kernel":
                times["kernel"].append(_cuda_ms(lambda: within_ghost(
                    src_p, ghost_p, dims, cap, tcap, c2), 50))
                times["kernel_call"].append(_cuda_ms(lambda: within_mask(
                    c, None, tg, CUTOFF, bm, bi, **kw), 20))
            else:
                times["plain"].append(_cuda_ms(lambda: _ghost_stencil(
                    src_p, ghost_p, dims, cap, tcap, c2), 10))
                times["plain_call"].append(_cuda_ms(lambda: within_mask(
                    c, None, tg, CUTOFF, bm, bi, **kw, plain=True), 10))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    phase("kernel_vs_plain", scenes=len(checked), all_equal=True,
          headline_shape=f"n={ATOMS},tgt={PROTEIN},dims={dims},cap={cap},tgt_cap={tcap}",
          stencil_kernel_ms=ms["kernel"], stencil_plain_ms=ms["plain"],
          within_mask_kernel_ms=ms["kernel_call"], within_mask_plain_ms=ms["plain_call"],
          names=",".join(checked))
    return {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": ms["plain"]}


# ---------------------------------------------------------------- phase 4


def _cpu_reference(path, k, ref, masses, pidx, box, cutoff, dims, caps0):
    """Frame ``k`` through the plain path on the CPU (tier raised until the
    search does not overflow) -> (rmsd, count, checksum)."""
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.tasks.trajectory import _invert_boxes

    with XtcHandler(path) as h:
        fr = h.read_frame(k)
    boxes = fr.box.matrix[None]
    window = (fr.coords[None], boxes, _invert_boxes(boxes))
    for tier in range(4):
        model = convert.from_numpy(ref, masses, pidx, box.matrix, cutoff,
                                   headline.caps_for(*caps0, tier), dims, "cpu")
        rmsd, count, check, ofl = model(*convert.transport_to_torch(window, "cpu"))
        if not bool(ofl[0]):
            return float(rmsd[0]), int(count[0]), int(check[0])
    raise AssertionError(f"frame {k}: the CPU reference overflows at every tier")


def phase_main_path(device, args, native_exe, workdir):
    import torch

    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops import neighbor_ghost
    from molar_tpu_torch.ops.neighbor import grid_dims
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    box = PeriodicBox(np.diag([BOX] * 3))
    coords0, masses = headline.make_system(ATOMS, PROTEIN, BOX)
    pidx = np.arange(PROTEIN)
    ref, pmass = coords0[pidx], masses[pidx]
    path = os.path.join(workdir, "traj.xtc")
    t0 = time.perf_counter()
    headline.write_trajectory(path, coords0, box.matrix, args.frames)
    t_write = time.perf_counter() - t0
    dims = grid_dims(box.box_extents(), CUTOFF)
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
    neighbor_ghost.within_ghost.launches = 0
    passes = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        ids, rmsd, count, check, retried = headline.run(
            path, ref, pmass, pidx, box, CUTOFF, dims, caps0, WINDOW, device
        )
        torch.cuda.synchronize()
        passes.append(len(ids) / (time.perf_counter() - t0))
    launches = neighbor_ghost.within_ghost.launches
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
    parity = 0
    rmsd_err = 0.0
    for k in sorted({0, args.frames // 2, args.frames - 1}):
        r_cpu, n_cpu, chk_cpu = _cpu_reference(path, k, ref, pmass, pidx, box,
                                               CUTOFF, dims, caps0)
        parity += int(n_cpu != int(count[k])) + int(chk_cpu != int(check[k]))
        rmsd_err = max(rmsd_err, abs(r_cpu - float(rmsd[k])))
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
    return launches, model0, dev_windows[0]


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    port = import_port()
    device, name, _ = phase_device(port)
    native_exe = phase_build()
    kernel = phase_kernel_vs_plain(device)
    from molar_tpu_torch import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    try:
        launches, model, window = phase_main_path(device, args, native_exe, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_stages(model, window)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    import torch

    print(json.dumps({"kernels": [{
        "name": "within_ghost", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **kernel,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
