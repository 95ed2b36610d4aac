"""Trajectory windows: streaming, on-device decode, pipeline, overflow retry.

The torch counterpart of ``molar_tpu.tasks.trajectory``'s device half:

    decode thread -> window (numpy views of a ring of pinned buffers)
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
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..convert import transport_to_torch
from ..io.xtc import XtcHandler

# Windows decoded ahead of compute.
_QUEUE_DEPTH = 2

#: The wire form the port's streams ship (``iter_windows``' ``quantized``):
#: "delta" (i8 frame-to-frame deltas, 3 bytes a row a frame), True (raw i16
#: ints, 6 bytes) or False (plain f32, 12 bytes).
WIRE = True
WIRE_BYTES = {"delta": 3, True: 6, False: 12}

#: :func:`auto_window`'s defaults: the wire bytes one window aims at, and
#: the longest window it picks. From sweeps of the window size on an
#: NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py``). Streams of 1,000 and
#: of 4,050 rows (1,024 frames of a 50,000-atom system) ran faster at every
#: doubling from 16 to 512 frames, so the cap is the longest window
#: measured there. The 100,000-atom headline (256 frames, i16 wire) ran at
#: 928, 1,360, 1,704 and 1,828 frames/s at windows of 16, 32, 64 and 128:
#: each window costs the consumer a fixed 14 ms of enqueue, which 16 frames
#: of decode (12 ms) do not hide. 40 MiB gives that stream 64 frames, the
#: last doubling that gained more than the passes spread, and every
#: selection stream the cap.
AUTO_WINDOW_TARGET_BYTES = 40 << 20
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
        #: Host seconds of the windows read so far: the codec's decode, and
        #: packing its output into the wire form (gather, diff, cast).
        self.timings = {"decode": 0.0, "pack": 0.0}

    def iter_windows(self, window: int, quantized=False, subset=None, alloc=None):
        """Yield ``(coords, boxes (B,3,3), invs, times, frame_ids)``.

        ``quantized=True`` ships the raw quantized ints ``(i16 (B,N,3),
        scale)``; ``quantized="delta"`` ships ``(frame0 i16, deltas i8 (B-1,
        N,3), scale)``, falling back to the i16 pair when a delta exceeds
        int8 and to plain f32 when the window is not representable as i16.
        ``subset`` (int indices) ships only those atom rows; a subset of low
        indices decodes only the file's atom prefix. ``alloc(shape, dtype)
        -> ndarray`` places the coordinate arrays of a contiguous chunk (a
        :class:`StagingRing`'s pinned memory); the codec decodes straight
        into it when the chunk needs no packing.
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
                            h, int(chunk[0]), len(chunk), quantized, sub, n_prefix, alloc
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

    def _read_chunk(self, h, start, count, quantized, sub, n_prefix, alloc):
        """One contiguous chunk in its wire form. What is shipped lies in
        ``alloc``'s memory (None: ordinary arrays): the codec's own output
        where that is the wire form, else a packed copy (the subset's
        rows, the deltas)."""
        t0 = time.perf_counter()
        try:
            if quantized:
                direct = sub is None and quantized is True
                try:
                    ic, scale, boxes, times = h.read_frames_i16(
                        start, count, n_prefix=n_prefix, alloc=alloc if direct else None)
                except ValueError:
                    pass  # not representable as i16: ship plain f32
                else:
                    t0 = self._lap("decode", t0)
                    if direct:
                        return (ic, scale), boxes, times
                    rows = ic if sub is None else np.take(ic, sub, axis=1)
                    if quantized == "delta" and len(rows) > 1:
                        d = np.diff(rows.astype(np.int32), axis=0)
                        if np.abs(d).max(initial=0) <= 127:
                            return ((_place(alloc, rows[0]), _place(alloc, d, np.int8), scale),
                                    boxes, times)
                    return (_place(alloc, rows), scale), boxes, times
            coords, boxes, times = h.read_frames(start, count,
                                                 alloc=alloc if sub is None else None)
            t0 = self._lap("decode", t0)
            if sub is not None:
                coords = _place(alloc, np.take(coords, sub, axis=1))
            return coords, boxes, times
        finally:
            self._lap("pack", t0)

    def _lap(self, part: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.timings[part] += t1 - t0
        return t1


def _place(alloc, a, dtype=None):
    """``a`` (cast to ``dtype``) as a contiguous array in ``alloc``'s memory."""
    if alloc is None:
        return np.ascontiguousarray(a, dtype)
    out = alloc(a.shape, dtype or a.dtype)
    out[...] = a
    return out


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
    """Pick a window size for a :data:`WIRE` stream of the XTC ``path``.

    ``requested`` > 0 wins unchanged. Otherwise the window grows until one
    window's wire (``WIRE_BYTES[WIRE]`` x rows x frames, rows = ``len(subset)``
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
    w = target_bytes // max(1, WIRE_BYTES[WIRE] * rows)
    if w < 16:
        p2 = 1
        while p2 * 2 <= max(1, w):
            p2 *= 2
        return int(min(n_frames, p2))
    return int(min(n_frames, max_window, w // 16 * 16))


class StagingRing:
    """A ring of host staging buffers for windows on their way to the card.

    ``depth`` byte buffers (pinned when ``pin``), used in turn: the decode
    thread calls :meth:`begin` before it reads a window, places the
    window's arrays with the ring itself (``ring(shape, dtype) -> ndarray``,
    a view of the current buffer), starts the copies, and hands
    :meth:`end` the event recorded after them. A buffer is taken again
    only after ``synchronize()`` of the event of its last use has returned,
    so no copy in flight ever reads bytes of a later window. A buffer grows
    when a window needs more room than any before it.
    """

    _ALIGN = 64

    def __init__(self, depth: int, pin: bool):
        self.depth = depth
        self.pin = pin
        self._buffers = [None] * depth
        self._events = [None] * depth
        self._outgrown = [[] for _ in range(depth)]  # kept until their copies are done
        self._chunks = []  # what the current window has been given
        self._slot = -1
        self._used = 0

    def begin(self) -> None:
        """Move on to the next buffer, once its last copies have completed."""
        self._slot = (self._slot + 1) % self.depth
        event = self._events[self._slot]
        if event is not None:
            event.synchronize()
            self._events[self._slot] = None
        self._outgrown[self._slot].clear()
        self._chunks = []
        self._used = 0

    def end(self, event) -> None:
        """``event``: recorded after the copies out of the current buffer."""
        self._events[self._slot] = event

    def __call__(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        start = -(-self._used // self._ALIGN) * self._ALIGN
        buf = self._buffers[self._slot]
        if buf is None or start + nbytes > buf.numel():
            # Too small: a larger buffer takes the slot; the old one may
            # hold earlier arrays of this window and lives as long as they.
            if buf is not None:
                self._outgrown[self._slot].append(buf)
            size = max(2 * (start + nbytes), 1 << 16)
            buf = self._buffers[self._slot] = torch.empty(size, dtype=torch.uint8,
                                                          pin_memory=self.pin)
            start = 0
        self._used = start + nbytes
        out = buf[start:start + nbytes].numpy().view(dtype).reshape(shape)
        self._chunks.append(out)
        return out

    def owns(self, a: np.ndarray) -> bool:
        """Whether ``a`` lies in an array this window was given."""
        addr = a.__array_interface__["data"][0]
        return any(c.ctypes.data <= addr < c.ctypes.data + max(c.nbytes, 1)
                   for c in self._chunks)


class WindowPipeline:
    """Decode thread + pinned H2D on a copy stream + compute.

    ``window_fn(transport, boxes, invs) -> per-frame results`` runs once per
    window on the compute (current) stream. On a CUDA ``device`` the decode
    thread reads each window into a :class:`StagingRing` of pinned buffers
    (one more than the queue holds) and starts the copies ``non_blocking``
    on a side stream, recording an event that the compute stream waits on;
    decode and H2D of window k+1 overlap compute of window k. On a CPU
    ``device`` the windows are plain tensors. ``subset`` (int indices) ships
    only those atom rows, as :meth:`TrajectoryReader.iter_windows` reads
    them. ``timings`` holds the host seconds of the last :meth:`run` by
    part: the feeder's ``decode``, ``pack`` (both the reader's),
    ``ring_wait``, ``copy_start`` and ``put_wait``, the consumer's
    ``get_wait`` and ``enqueue`` (inside ``window_fn``), and ``windows``.
    """

    def __init__(self, reader, window: int, window_fn: Callable, device, quantized=False,
                 subset=None):
        self.reader = reader
        self.window = window
        self.window_fn = window_fn
        self.device = torch.device(device)
        self.quantized = quantized
        self.subset = subset
        self.timings: dict = {}

    def run(self):
        """Yield ``(frame_ids, results)`` per window, in stream order."""
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        ring = StagingRing(_QUEUE_DEPTH + 1, pin=True) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
        cancel = threading.Event()
        done = object()
        clock = time.perf_counter
        t = self.timings = dict.fromkeys(
            ("decode", "pack", "ring_wait", "copy_start", "put_wait", "get_wait", "enqueue"), 0.0)
        t["windows"] = 0
        read0 = dict(self.reader.timings)

        def put(item) -> bool:
            t0 = clock()
            try:
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False
            finally:
                t["put_wait"] += clock() - t0

        def feeder():
            try:
                windows = self.reader.iter_windows(self.window, quantized=self.quantized,
                                                   subset=self.subset, alloc=ring)
                while True:
                    if cuda:
                        t0 = clock()
                        ring.begin()
                        t["ring_wait"] += clock() - t0
                    item = next(windows, None)
                    if item is None:
                        break
                    ready = None
                    t0 = clock()
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            dev = transport_to_torch(item, self.device, non_blocking=True,
                                                     alloc=ring)
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                        ring.end(ready)
                    else:
                        dev = transport_to_torch(item, self.device)
                    t["copy_start"] += clock() - t0
                    if not put((dev, item[4], ready)):
                        return
            except BaseException as e:  # surfaced to the consumer
                put(e)
                return
            put(done)

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        try:
            while True:
                t0 = clock()
                item = q.get()
                t["get_wait"] += clock() - t0
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                dev, ids, ready = item
                t0 = clock()
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for x in _leaves(dev):
                        # Allocated on the copy stream, used on compute:
                        # keep the allocator from recycling it early.
                        x.record_stream(compute)
                res = self.window_fn(*dev)
                t["enqueue"] += clock() - t0
                t["windows"] += 1
                yield ids, res
        finally:
            cancel.set()
            thread.join()
            for part in ("decode", "pack"):
                t[part] = self.reader.timings[part] - read0[part]


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
