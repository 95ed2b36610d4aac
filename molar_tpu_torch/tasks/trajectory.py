"""Trajectory windows: streaming, on-device decode, pipeline, overflow retry.

The torch counterpart of ``molar_tpu.tasks.trajectory``'s device half:

    decode thread -> window (numpy) -> pinned host buffers
        -> non_blocking H2D on a copy stream -> CUDA event -> compute stream

``TrajectoryReader.iter_windows`` is the XTC contiguous-chunk path with the
three wire forms (plain f32, raw i16 quantized ints, i8 frame-to-frame
deltas); :func:`decode_window_coords` expands them on the device,
bit-identical to the host float decode. The tunnel-only chunked forms of
``molar_tpu`` are not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..convert import transport_to_torch
from ..io.xtc import XtcHandler

# Windows decoded ahead of compute.
_QUEUE_DEPTH = 2

#: :func:`auto_window`'s defaults: the i8-delta wire bytes one window aims
#: at, and the longest window it picks. From a sweep of the window size on
#: an NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py``, 1,024 frames of a
#: 50,000-atom system): streams of 1,000 and of 4,050 rows both ran faster
#: at every doubling from 16 to 512 frames (714 -> 4,507 and 807 -> 2,177
#: frames/s, medians of 3 passes), so the cap is the longest window
#: measured, and 6 MiB is what gives a 4,050-row stream that window while
#: a 100,000-atom stream keeps 16 frames, the size it was measured at.
AUTO_WINDOW_TARGET_BYTES = 6 << 20
AUTO_WINDOW_MAX = 512


class AnalysisError(RuntimeError):
    pass


class TrajectoryReader:
    """Concatenated multi-file frame stream with begin/end/skip on global
    frame indices (the skip phase carries across file boundaries)."""

    def __init__(
        self,
        paths: Sequence[str],
        begin: Optional[int] = None,
        end: Optional[int] = None,
        skip: int = 1,
    ):
        self.paths = [str(p) for p in paths]
        for p in self.paths:
            if not p.lower().endswith(".xtc"):
                raise NotImplementedError(f"only XTC trajectories are ported: {p}")
        self.begin = begin
        self.end = end
        self.skip = max(skip, 1)

    def iter_windows(self, window: int, quantized=False, subset=None):
        """Yield ``(coords, boxes (B,3,3), invs, times, frame_ids)``.

        ``quantized=True`` ships the raw quantized ints ``(i16 (B,N,3),
        scale)``; ``quantized="delta"`` ships ``(frame0 i16, deltas i8 (B-1,
        N,3), scale)``, falling back to the i16 pair when a delta exceeds
        int8 and to plain f32 when the window is not representable as i16.
        ``subset`` (int indices) ships only those atom rows; a subset of low
        indices decodes only the file's atom prefix.
        """
        sub = None if subset is None else np.asarray(subset, dtype=np.intp)
        fr_base = 0
        n_eligible = 0
        for path in self.paths:
            with XtcHandler(path) as h:
                n = h.n_frames
                ids = np.arange(fr_base, fr_base + n)
                keep = np.ones(n, dtype=bool)
                if self.begin is not None:
                    keep &= ids >= self.begin
                if self.end is not None:
                    keep &= ids <= self.end
                kept = np.nonzero(keep)[0]
                phase = (-n_eligible) % self.skip
                n_eligible += len(kept)
                kept = kept[phase:: self.skip]
                n_prefix = None
                if sub is not None and len(sub):
                    pmax = int(sub.max()) + 1
                    if 2 * pmax <= h.n_atoms:
                        n_prefix = pmax
                for s in range(0, len(kept), window):
                    chunk = kept[s: s + window]
                    if np.array_equal(chunk, np.arange(chunk[0], chunk[0] + len(chunk))):
                        coords, boxes, times = self._read_chunk(
                            h, int(chunk[0]), len(chunk), quantized, sub, n_prefix
                        )
                    else:
                        # Decimated: decode frame by frame (random access).
                        n_rows = h.n_atoms if sub is None else len(sub)
                        coords = np.empty((len(chunk), n_rows, 3), np.float32)
                        boxes = np.empty((len(chunk), 3, 3), np.float32)
                        times = np.empty(len(chunk), np.float32)
                        for k, fi in enumerate(chunk):
                            fr = h.read_frame(int(fi))
                            coords[k] = fr.coords if sub is None else fr.coords[sub]
                            boxes[k] = fr.box.matrix if fr.box is not None else np.eye(3)
                            times[k] = fr.time
                    yield coords, boxes, _invert_boxes(boxes), times, ids[chunk]
                fr_base += n

    @staticmethod
    def _read_chunk(h, start, count, quantized, sub, n_prefix):
        if quantized:
            try:
                ic, scale, boxes, times = h.read_frames_i16(start, count, n_prefix=n_prefix)
            except ValueError:
                pass  # not representable as i16: ship plain f32
            else:
                if sub is not None:
                    ic = np.ascontiguousarray(ic[:, sub])
                if quantized == "delta" and len(ic) > 1:
                    d = np.diff(ic.astype(np.int32), axis=0)
                    if np.abs(d).max(initial=0) <= 127:
                        return (ic[0], d.astype(np.int8), scale), boxes, times
                return (ic, scale), boxes, times
        coords, boxes, times = h.read_frames(start, count)
        if sub is not None:
            coords = np.ascontiguousarray(coords[:, sub])
        return coords, boxes, times


def _invert_boxes(boxes: np.ndarray) -> np.ndarray:
    return np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)


def decode_window_coords(coords):
    """On-device decode of a window transport -> f32 ``(B, N, 3)``.

    Plain f32 passes through; ``(i16, scale)`` is ``ints * scale``;
    ``(frame0 i16, deltas i8, scale)`` rebuilds the exact ints by an int32
    prefix sum over frames first. All three are bit-identical to the host
    float decode (every partial sum is a true quantized coordinate).
    """
    if isinstance(coords, torch.Tensor):
        return coords
    if len(coords) == 2:
        ic, scale = coords
        return ic.to(torch.float32) * scale
    f0, d8, scale = coords
    f0 = f0.to(torch.int32)[None]
    ints = torch.cat(
        [f0, f0 + torch.cumsum(d8.to(torch.int32), dim=0, dtype=torch.int32)], dim=0
    )
    return ints.to(torch.float32) * scale


def auto_window(
    path: str,
    subset=None,
    requested: int = 0,
    target_bytes: int = AUTO_WINDOW_TARGET_BYTES,
    max_window: int = AUTO_WINDOW_MAX,
) -> int:
    """Pick a window size for a delta-transport stream of the XTC ``path``.

    ``requested`` > 0 wins unchanged. Otherwise the window grows until one
    window's i8-delta wire (3 bytes x rows x frames, rows = ``len(subset)``
    or every atom) reaches ``target_bytes``: a small selection's stream
    pays a fixed host cost a window (enqueueing the window function), so
    its windows should be long. At 16 frames and above the window is
    rounded down to a multiple of 16 and clamped to ``max_window``; below
    16 (huge frames) it falls in powers of two down to 1. Never longer than
    the file. A path that is not an XTC raises, as :class:`TrajectoryReader`
    does."""
    if requested:
        return requested
    if not str(path).lower().endswith(".xtc"):
        raise NotImplementedError(f"only XTC trajectories are ported: {path}")
    with XtcHandler(str(path)) as h:
        n_frames, n_atoms = h.n_frames, h.n_atoms
    rows = n_atoms if subset is None else len(subset)
    w = target_bytes // max(1, 3 * rows)
    if w < 16:
        p2 = 1
        while p2 * 2 <= max(1, w):
            p2 *= 2
        return int(min(n_frames, p2))
    return int(min(n_frames, max_window, w // 16 * 16))


class WindowPipeline:
    """Decode thread + pinned H2D on a copy stream + compute.

    ``window_fn(transport, boxes, invs) -> per-frame results`` runs once per
    window on the compute (current) stream. On a CUDA ``device`` the decode
    thread stages each window in pinned host memory and issues the copies
    ``non_blocking`` on a side stream, recording an event that the compute
    stream waits on; decode and H2D of window k+1 overlap compute of window
    k. On a CPU ``device`` the windows are plain tensors. ``subset`` (int
    indices) ships only those atom rows, as
    :meth:`TrajectoryReader.iter_windows` reads them.
    """

    def __init__(self, reader, window: int, window_fn: Callable, device, quantized=False,
                 subset=None):
        self.reader = reader
        self.window = window
        self.window_fn = window_fn
        self.device = torch.device(device)
        self.quantized = quantized
        self.subset = subset

    def run(self):
        """Yield ``(frame_ids, results)`` per window, in stream order."""
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
        cancel = threading.Event()
        done = object()

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for item in self.reader.iter_windows(self.window, quantized=self.quantized,
                                                     subset=self.subset):
                    ready = None
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            dev = transport_to_torch(item, self.device, non_blocking=True)
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                    else:
                        dev = transport_to_torch(item, self.device)
                    if not put((dev, item[4], ready)):
                        return
            except BaseException as e:  # surfaced to the consumer
                put(e)
                return
            put(done)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                dev, ids, ready = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for x in _leaves(dev):
                        # Allocated on the copy stream, used on compute:
                        # keep the allocator from recycling it early.
                        x.record_stream(compute)
                yield ids, self.window_fn(*dev)
        finally:
            cancel.set()
            t.join()


def _leaves(dev):
    for x in dev:
        if isinstance(x, tuple):
            yield from x
        else:
            yield x


def run_with_overflow_retry(
    reader: TrajectoryReader,
    window: int,
    build_fn: Callable[[int], Callable],
    device,
    overflow_of: Callable,
    n_tiers: int = 3,
    quantized=False,
    subset=None,
):
    """Stream windows through ``build_fn(0)``; re-run overflowed windows at
    higher capacity tiers (the fixed-capacity + retry contract).

    The pass never syncs per window: overflow flags stay on the device and
    are read with one device->host copy after the pass. Only flagged
    windows are re-read (by frame range, skip phase preserved) and re-run
    at tiers 1.. until clean, with the same ``subset`` of atom rows. An XTC
    window never spans two files, so the
    by-range re-read reproduces its frames exactly (``molar_tpu``'s
    per-frame re-read fallback serves its non-XTC readers, not ported).
    Raises :class:`AnalysisError` if the last tier still overflows. Returns
    ``(results, retried_window_count)`` with ``results`` a list of
    ``(frame_ids, result)`` in stream order.
    """
    fns = {0: build_fn(0)}
    results = list(WindowPipeline(reader, window, fns[0], device, quantized=quantized,
                                  subset=subset).run())
    if not results:
        return results, 0
    flags = torch.stack([overflow_of(res).any() for _, res in results]).cpu().numpy()
    retried = 0
    for w in np.flatnonzero(flags):
        ids = results[w][0]
        retried += 1
        for tier in range(1, n_tiers):
            if tier not in fns:
                fns[tier] = build_fn(tier)
            sub = TrajectoryReader(
                reader.paths, begin=int(ids[0]), end=int(ids[-1]), skip=reader.skip
            )
            redo_in = list(sub.iter_windows(window, quantized=quantized, subset=subset))
            if len(redo_in) != 1 or not np.array_equal(redo_in[0][4], ids):
                raise AnalysisError(f"re-read of window {w} did not reproduce frames {ids}")
            res = fns[tier](*transport_to_torch(redo_in[0], device))
            if not bool(overflow_of(res).any()):
                results[w] = (ids, res)
                break
        else:
            raise AnalysisError(
                f"window {w} (frames {ids[0]}..{ids[-1]}) still overflows at "
                f"the largest capacity tier {n_tiers - 1}"
            )
    return results, retried
