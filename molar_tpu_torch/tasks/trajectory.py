"""Trajectory windows: streaming, on-device decode, pipeline, overflow retry.

The torch counterpart of ``molar_tpu.tasks.trajectory``'s device half:

    decode thread -> window (numpy views of a ring of pinned buffers)
        -> non_blocking H2D on a copy stream -> CUDA event -> compute stream

``TrajectoryReader.iter_windows`` is the XTC contiguous-chunk path with the
three wire forms (plain f32, raw i16 quantized ints, i8 frame-to-frame
deltas); :func:`decode_window_coords` expands them on the device,
bit-identical to the host float decode. Any other format the IO facade
reads (TRR, AMBER NetCDF, DCD, PDB, GRO, XYZ, ...) goes through serial state
reads in plain f32.
The tunnel-only chunked forms of ``molar_tpu`` are not ported.

:class:`WindowAnalysisTask` is the user-facing harness on top: the standard
flags (:func:`build_arg_parser`; ``-b/-e`` take :class:`FrameSpec`'s
suffixes), a structure file read into a
:class:`~molar_tpu_torch.core.system.System`, and a window function of the
task's own over device tensors, streamed through :class:`WindowPipeline`.
The pipeline, the overflow retry and the task take a ``mesh``: each window's
frames sharded over several devices by a
:class:`~molar_tpu_torch.parallel.mesh.MeshWindowRunner`.

:class:`AnalysisTask` is the reference-compatible per-frame harness
(pymolar's hooks over a ``System`` with each frame swapped in), on the host
as in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import tracing
from ..convert import transport_to_torch
from ..io import FileHandler, handler_factory
from ..io.xtc import XtcHandler
from ..parallel.mesh import as_runner, frame_mesh

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
#: The fewest frames :func:`auto_window` picks (fewer only in a shorter
#: file): the decode pool (``io.xtc.DECODE_WORKERS`` = 8 threads) decodes a
#: window one frame a worker, so a shorter window leaves workers idle. From
#: the 1,000,000-atom headline (32 frames, i16 wire, 6 MB a frame) on an
#: NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py`` phase 16), medians of 3
#: passes at windows of 1 / 2 / 4 / 8: 38.8 / 70.2 / 102.6 / 172.4 frames/s
#: in one call, 31.9 / 50.0 / 97.6 / 134.9 (and 131.8 at 16) in another;
#: the decode alone ran 44 / 71 / 112 / 226 frames/s. The 40 MiB target
#: gave that stream 4 frames.
AUTO_WINDOW_MIN = 8


log = logging.getLogger("molar_tpu_torch.analysis")


class AnalysisError(RuntimeError):
    pass


@dataclass
class FrameSpec:
    """Parsed -b/-e value: a global frame index, or a time (ps)."""

    frame: Optional[int] = None
    time: Optional[float] = None

    @staticmethod
    def parse(text: Optional[str]) -> "FrameSpec":
        """``N`` or ``Nfr``: frame N; ``Nps`` / ``Nns`` / ``Nus``: time
        (analysis_task.rs:82-110); None: no bound."""
        if text is None:
            return FrameSpec()
        s = text.strip()
        if s.endswith("fr"):
            return FrameSpec(frame=int(s[:-2]))
        for suffix, mult in (("ps", 1.0), ("ns", 1e3), ("us", 1e6)):
            if s.endswith(suffix):
                return FrameSpec(time=float(s[: -len(suffix)]) * mult)
        return FrameSpec(frame=int(s))


def _spec(bound: Union[None, int, FrameSpec]) -> FrameSpec:
    if isinstance(bound, FrameSpec):
        return bound
    return FrameSpec() if bound is None else FrameSpec(frame=int(bound))


class TrajectoryReader:
    """Concatenated multi-file frame stream with begin/end/skip. ``begin`` and
    ``end`` (inclusive) are global frame indices or :class:`FrameSpec`s (a
    frame index or a time in ps, against each frame's time); the skip phase
    carries across file boundaries. The stream ends at its first frame past
    ``end``, in frame order across the files, as ``analysis_task.rs``'s
    runner does: frames after it are never read, even where a later file's
    times restart below the end time. ``begin`` is a filter, frame by
    frame. Each path is any format :class:`~molar_tpu_torch.io.FileHandler`
    reads; an unknown extension raises :class:`~molar_tpu_torch.io.FileIoError`
    here."""

    def __init__(
        self,
        paths: Sequence[str],
        begin: Union[None, int, FrameSpec] = None,
        end: Union[None, int, FrameSpec] = None,
        skip: int = 1,
    ):
        self.paths = [str(p) for p in paths]
        for p in self.paths:
            handler_factory(p)
        self.begin = _spec(begin)
        self.end = _spec(end)
        self.skip = max(skip, 1)
        #: Host seconds of the windows read so far: the codec's decode, and
        #: packing its output into the wire form (gather, diff, cast).
        self.timings = {"decode": 0.0, "pack": 0.0}

    def _want(self, fr: int, t: float) -> bool:
        return not ((self.begin.frame is not None and fr < self.begin.frame)
                    or (self.begin.time is not None and t < self.begin.time))

    def _past_end(self, fr: int, t: float) -> bool:
        return ((self.end.frame is not None and fr > self.end.frame)
                or (self.end.time is not None and t > self.end.time))

    def iter_states(self):
        """Yield ``(global_frame_index, State)``, serially through the IO
        facade's prefetching iteration; ``skip`` decimates the frames
        inside the begin/end window with its phase carried across files
        (analysis_task.rs:205-234)."""
        fr = -1
        in_window = 0
        for path in self.paths:
            with FileHandler(path) as fh:
                for st in fh.iter_states():
                    fr += 1
                    if self._past_end(fr, st.time):
                        return
                    if not self._want(fr, st.time):
                        continue
                    if in_window % self.skip == 0:
                        yield fr, st
                    in_window += 1

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
        into it when the chunk needs no packing. A file that is not an XTC
        is read state by state (:meth:`_iter_serial`) and ships plain f32.
        """
        sub = None if subset is None else np.asarray(subset, dtype=np.intp)
        fr_base = 0
        n_eligible = 0
        for path in self.paths:
            if self.end.frame is not None and fr_base > self.end.frame:
                return
            if not path.lower().endswith(".xtc"):
                fr_base, n_eligible, ended = yield from self._iter_serial(
                    path, window, sub, fr_base, n_eligible)
                if ended:
                    return
                continue
            with XtcHandler(path) as h:
                n = h.n_frames
                ids = np.arange(fr_base, fr_base + n)
                past = np.zeros(n, dtype=bool)
                if self.end.frame is not None:
                    past |= ids > self.end.frame
                if self.end.time is not None:
                    past |= h.times > self.end.time
                n_read = int(np.argmax(past)) if past.any() else n
                keep = np.arange(n) < n_read
                if self.begin.frame is not None:
                    keep &= ids >= self.begin.frame
                if self.begin.time is not None:
                    keep &= h.times >= self.begin.time
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
            if n_read < n:
                return
            fr_base += n

    def _iter_serial(self, path, window, sub, fr, n_eligible):
        """Windows of ``path`` read state by state through the facade, its
        first frame numbered ``fr``, ``n_eligible`` frames eligible before
        it (the skip phase) -> returns ``(next frame id, n_eligible, whether
        the stream ended past the end)``."""
        buf_c, buf_b, buf_t, buf_i = [], [], [], []

        def flush():
            boxes = np.stack(buf_b)
            out = (np.stack(buf_c), boxes, _invert_boxes(boxes),
                   np.asarray(buf_t, np.float32), np.asarray(buf_i))
            for b in (buf_c, buf_b, buf_t, buf_i):
                b.clear()
            return out

        ended = False
        with FileHandler(path) as fh:
            states = fh.iter_states(prefetch=0)
            while True:
                with tracing.sink(self.timings), tracing.span("decode"):
                    st = next(states, None)
                if st is None:
                    break
                if self._past_end(fr, st.time):
                    ended = True
                    break
                if self._want(fr, st.time):
                    if n_eligible % self.skip == 0:
                        c = st.coords if sub is None else st.coords[sub]
                        buf_c.append(c.astype(np.float32))
                        buf_b.append(st.box.matrix if st.box is not None
                                     else np.eye(3, dtype=np.float32))
                        buf_t.append(st.time)
                        buf_i.append(fr)
                    n_eligible += 1
                fr += 1
                if len(buf_c) == window:
                    yield flush()
        if buf_c:
            yield flush()
        return fr, n_eligible, ended

    def _read_chunk(self, h, start, count, quantized, sub, n_prefix, alloc):
        """One contiguous chunk in its wire form. What is shipped lies in
        ``alloc``'s memory (None: ordinary arrays): the codec's own output
        where that is the wire form, else a packed copy (the subset's
        rows, the deltas)."""
        with tracing.sink(self.timings):
            if quantized:
                direct = sub is None and quantized is True
                try:
                    with tracing.span("decode"):
                        ic, scale, boxes, times = h.read_frames_i16(
                            start, count, n_prefix=n_prefix, alloc=alloc if direct else None)
                except ValueError:
                    pass  # not representable as i16: ship plain f32
                else:
                    if direct:
                        return (ic, scale), boxes, times
                    with tracing.span("pack"):
                        rows = ic if sub is None else np.take(ic, sub, axis=1)
                        if quantized == "delta" and len(rows) > 1:
                            d = np.diff(rows.astype(np.int32), axis=0)
                            if np.abs(d).max(initial=0) <= 127:
                                return ((_place(alloc, rows[0]), _place(alloc, d, np.int8),
                                         scale), boxes, times)
                        return (_place(alloc, rows), scale), boxes, times
            with tracing.span("decode"):
                coords, boxes, times = h.read_frames(start, count,
                                                     alloc=alloc if sub is None else None)
            if sub is not None:
                with tracing.span("pack"):
                    coords = _place(alloc, np.take(coords, sub, axis=1))
            return coords, boxes, times


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
    """Pick a window size for a :data:`WIRE` stream of ``path``.

    ``requested`` > 0 wins unchanged. Otherwise the window grows until one
    window's wire (``WIRE_BYTES[WIRE]`` x rows x frames, rows = ``len(subset)``
    or every atom) reaches ``target_bytes``: a small selection's stream
    pays a fixed host cost a window (enqueueing the window function), so
    its windows should be long. At 16 frames and above the window is
    rounded down to a multiple of 16 and clamped to ``max_window``; below
    16 (huge frames) it falls in powers of two, but not below
    :data:`AUTO_WINDOW_MIN` (the JAX package goes down to 1: on the H100 a
    shorter window starves the decode pool). Never longer than the file.
    Only an XTC is sized: any other format gets 16 frames without being
    opened, as in the JAX package; an extension no handler reads raises."""
    if requested:
        return requested
    if handler_factory(str(path)) is not XtcHandler:
        return 16
    with XtcHandler(str(path)) as h:
        n_frames, n_atoms = h.n_frames, h.n_atoms
    rows = n_atoms if subset is None else len(subset)
    w = target_bytes // max(1, WIRE_BYTES[WIRE] * rows)
    if w < 16:
        p2 = 1
        while p2 * 2 <= max(1, w):
            p2 *= 2
        return int(min(n_frames, max(p2, AUTO_WINDOW_MIN)))
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
    them.

    ``timings`` holds what the last :meth:`run` measured
    (:mod:`~molar_tpu_torch.tracing` spans; host seconds unless said), with
    the per-layer metric of ``portbench/`` that reads each:

    * ``decode``, ``pack``: the reader's codec decode (``decode_ms_per_frame``)
      and packing of its output into the wire form (no metric), on the
      feeder thread;
    * ``ring_wait``: the feeder waiting for a staging buffer whose last
      copies are still in flight; ``copy_start``: starting a window's copies;
      ``put_wait``: waiting for room in the queue (the consumer is behind).
      No metric reads them: an operator reads where the feeder waits;
    * ``get_wait``: the consumer waiting for the next window
      (``feed_wait_pct``); ``enqueue``: its call of ``window_fn``, the wait
      on the copies' event included (``enqueue_ms_per_frame``);
    * ``windows``: the windows run (the count ``device_allocs_per_window``
      divides by);
    * the window function's own spans, each under its module's name
      (``fit_within.search``, ``sasa.lists``, ...), and where they name a
      device (``sasa.lists`` and ``sasa.arcs``) and a profiler records,
      their ``<name>@device`` stream seconds, added by
      :func:`~molar_tpu_torch.tracing.resolve` over :attr:`events` once the
      caller has the results on the host;
    * after :func:`run_with_overflow_retry`: ``retry`` (the retry pass),
      ``retried_windows`` and, on a CUDA device, ``device_allocs`` (the
      caching allocator's ``cudaMalloc`` calls over the whole call).

    The consumer's spans of window ``k`` carry ``k`` as the argument of
    their ``stage:`` ranges. A profiler records only the thread that
    started it (the consumer's, where the caller starts one), so the
    feeder's spans are totals only.
    """

    def __init__(self, reader, window: int, window_fn: Callable, device, quantized=False,
                 subset=None, mesh=None):
        self.reader = reader
        self.window = window
        self.window_fn = window_fn
        #: The frame-sharded runner (``mesh``: a list of devices or a
        #: :class:`~molar_tpu_torch.parallel.mesh.MeshWindowRunner`), or None.
        self.runner = as_runner(mesh)
        self.device = self.runner.device if self.runner is not None else torch.device(device)
        self.quantized = quantized
        self.subset = subset
        self.timings: dict = {}
        #: CUDA event pairs of the last run's device spans, not yet resolved.
        self.events: list = []

    def run(self):
        """Yield ``(frame_ids, results)`` per window, in stream order."""
        runner = self.runner
        cuda = self.device.type == "cuda" and runner is None
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        ring = StagingRing(_QUEUE_DEPTH + 1, pin=True) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
        cancel = threading.Event()
        done = object()
        span = tracing.span
        t = self.timings = dict.fromkeys(
            ("decode", "pack", "ring_wait", "copy_start", "put_wait", "get_wait", "enqueue"), 0.0)
        t["windows"] = 0
        events = self.events = []
        read0 = dict(self.reader.timings)

        def put(item) -> bool:
            with span("put_wait"):
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

        def feed(windows) -> bool:
            """Read, copy and queue the next window -> whether to go on."""
            if cuda:
                with span("ring_wait"):
                    ring.begin()
            item = next(windows, None)
            if item is None:
                return False
            ready = None
            with span("copy_start"):
                if runner is not None:
                    # Padded, split and copied (blocking) shard by shard.
                    dev = runner.prepare(*item[:3])
                elif cuda:
                    with torch.cuda.stream(copy_stream):
                        dev = transport_to_torch(item, self.device, non_blocking=True,
                                                 alloc=ring)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    ring.end(ready)
                else:
                    dev = transport_to_torch(item, self.device)
            return put((dev, item[4], ready))

        def feeder():
            with tracing.sink(t):
                try:
                    windows = self.reader.iter_windows(self.window, quantized=self.quantized,
                                                       subset=self.subset, alloc=ring)
                    while feed(windows):
                        pass
                except BaseException as e:  # surfaced to the consumer
                    put(e)
                    return
                put(done)

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        try:
            k = 0
            while True:
                # The window's sink is installed around the consumer's own
                # work only, never across the yield.
                with tracing.sink(t, window=k, events=events):
                    with span("get_wait"):
                        item = q.get()
                    if item is done:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    dev, ids, ready = item
                    with span("enqueue"):
                        if ready is not None:
                            compute = torch.cuda.current_stream(self.device)
                            compute.wait_event(ready)
                            for x in _leaves(dev):
                                # Allocated on the copy stream, used on compute:
                                # keep the allocator from recycling it early.
                                x.record_stream(compute)
                        if runner is not None:
                            shards, b, form = dev
                            res = runner.trim(runner.wrap(self.window_fn, form)(shards), b)
                        else:
                            res = self.window_fn(*dev)
                    t["windows"] += 1
                yield ids, res
                k += 1
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
    mesh=None,
):
    """Stream windows through ``build_fn(0)``; re-run overflowed windows at
    higher capacity tiers (the fixed-capacity + retry contract).

    The pass never syncs per window: overflow flags stay on the device and
    are read with one device->host copy after the pass. Only flagged
    windows are re-read (by frame range, skip phase preserved) and re-run
    at tiers 1.. until clean, with the same ``subset`` of atom rows. A
    window never spans two files, so the by-range re-read reproduces its
    frames exactly (``molar_tpu``'s per-frame re-read fallback is not
    needed).
    Raises :class:`AnalysisError` if the last tier still overflows. Returns
    ``(results, retried_window_count)`` with ``results`` a list of
    ``(frame_ids, result)`` in stream order. ``mesh`` (a list of devices or
    a :class:`~molar_tpu_torch.parallel.mesh.MeshWindowRunner`) shards
    every window's frames over its devices, the retried ones through the
    same runner; ``device`` is then the mesh's first.

    The pass's :class:`WindowPipeline` gets three more ``timings``:
    ``retry``, the host seconds of re-reading, copying and re-running the
    flagged windows (0 when none is), as one span (the window function's
    spans inside it add to no total); ``retried_windows``; and on a CUDA
    device ``device_allocs``, the caching allocator's ``cudaMalloc`` calls
    on ``device`` over the whole call, read once at its start and once at
    its end.
    """
    runner = as_runner(mesh)
    dev = runner.device if runner is not None else torch.device(device)
    allocs0 = _device_allocs(dev)
    fns = {0: build_fn(0)}
    pipe = WindowPipeline(reader, window, fns[0], device, quantized=quantized, subset=subset,
                          mesh=runner)
    results = list(pipe.run())
    t = pipe.timings
    t["retry"], t["retried_windows"] = 0.0, 0
    flagged = []
    if results:
        flags = torch.stack([overflow_of(res).any() for _, res in results]).cpu().numpy()
        tracing.resolve(t, pipe.events)
        flagged = np.flatnonzero(flags)
    if len(flagged):
        with tracing.sink(t), tracing.span("retry"):
            tracing.count("retried_windows", len(flagged))
            with tracing.sink(None):  # the re-runs' own spans add to no total
                for w in flagged:
                    ids = results[w][0]
                    for tier in range(1, n_tiers):
                        if tier not in fns:
                            fns[tier] = build_fn(tier)
                        sub = TrajectoryReader(
                            reader.paths, begin=int(ids[0]), end=int(ids[-1]), skip=reader.skip
                        )
                        redo_in = list(sub.iter_windows(window, quantized=quantized,
                                                        subset=subset))
                        if len(redo_in) != 1 or not np.array_equal(redo_in[0][4], ids):
                            raise AnalysisError(
                                f"re-read of window {w} did not reproduce frames {ids}")
                        if runner is not None:
                            res = runner.call(fns[tier], *redo_in[0][:3])
                        else:
                            res = fns[tier](*transport_to_torch(redo_in[0], device))
                        if not bool(overflow_of(res).any()):
                            results[w] = (ids, res)
                            break
                    else:
                        raise AnalysisError(
                            f"window {w} (frames {ids[0]}..{ids[-1]}) still overflows at "
                            f"the largest capacity tier {n_tiers - 1}"
                        )
    if allocs0 is not None:
        t["device_allocs"] = _device_allocs(dev) - allocs0
    return results, t["retried_windows"]


def _device_allocs(device) -> Optional[int]:
    """The caching allocator's ``cudaMalloc`` calls on ``device`` so far, or
    None off CUDA."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return stats.get("num_device_alloc", stats.get("segment.all.allocated", 0))


def build_arg_parser(description: str = "trajectory analysis") -> argparse.ArgumentParser:
    """The reference TrajAnalysisArgs flag set (-f/-b/-e/--skip/--log),
    ``--window``, ``--mesh`` (each window's frames sharded over that many
    devices) and ``--add-time`` (read by :class:`AnalysisTask`)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--files", nargs="+", required=True,
                   help="structure file followed by trajectory file(s)")
    p.add_argument("-b", "--begin", default=None, help="first frame (N, Nfr, Nps, Nns, Nus)")
    p.add_argument("-e", "--end", default=None, help="last frame (same suffixes)")
    p.add_argument("--skip", type=int, default=1, help="take every skip-th frame")
    p.add_argument("--log", type=int, default=100, dest="log_every", help="progress period")
    p.add_argument("--window", type=int, default=0,
                   help="frames per device window (0 = auto_window from the stream's rows)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard each window's frames over this many devices (0: one device)")
    p.add_argument("--add-time", action="store_true", dest="add_time",
                   help="offset times so they keep increasing across concatenated "
                   "trajectories (pymolar AnalysisTask parity)")
    return p


class WindowAnalysisTask:
    """Batched analysis harness: one window function over device tensors a
    window of frames.

    Subclass and implement:

    * ``build(system) -> window_fn``: ``window_fn(coords (B, R, 3) f32,
      boxes (B, 3, 3), invs (B, 3, 3))`` on :attr:`device` returns the
      window's per-frame results (tensors, never read on the host inside);
      ``R`` is ``len(self.subset)`` rows, or every atom when ``subset`` is
      None. ``build`` may set ``self.subset`` (sorted atom indices) so that
      windows ship only those rows;
    * ``accumulate(frame_ids, results)``: host-side consumption of a window;
    * optional ``post_process()``.

    ``run(argv)`` parses the standard flags (:func:`build_arg_parser`),
    reads the structure file (:meth:`System.from_file
    <molar_tpu_torch.core.system.System.from_file>`) and streams the
    trajectories through :class:`WindowPipeline` in the shipped wire form,
    at ``--window`` or the window :func:`auto_window` picks for the
    stream's rows. The window function runs on ``device`` (the first CUDA
    device unless the caller passes another); the frames' times are not
    shipped. A window whose searches overflow is the window function's to
    flag and ``accumulate``'s to refuse.

    ``--mesh N`` (or ``mesh``, a list of devices or a
    :class:`~molar_tpu_torch.parallel.mesh.MeshWindowRunner`) shards each
    window's frames over N devices: the first N CUDA devices
    (:func:`~molar_tpu_torch.parallel.mesh.frame_mesh`), or N shards on
    ``device`` when the caller names one (the CPU tests; several shards of
    one card). ``build`` then runs for the mesh's first device; a window
    function that is an ``nn.Module`` is replicated to the others, any
    other callable runs as it is. Every output must be per-frame;
    ``accumulate`` sees whole, trimmed windows either way.
    """

    task_name = "window analysis"
    subset = None

    def add_args(self, parser: argparse.ArgumentParser) -> None:
        pass

    def build(self, system):
        raise NotImplementedError

    def accumulate(self, frame_ids, results) -> None:
        raise NotImplementedError

    def post_process(self) -> None:
        pass

    def run(self, argv: Optional[Sequence[str]] = None, device=None, mesh=None) -> int:
        """Parse ``argv``, build and stream -> the number of frames read."""
        timings = {}
        with tracing.sink(timings):
            with tracing.span("setup"):
                pipeline = self._build_pipeline(argv, device, mesh)
            n = 0
            with tracing.span("stream"):
                t0 = time.perf_counter()
                for ids, results in pipeline.run():
                    self.accumulate(ids, results)
                    n += len(ids)
                    if self.args.log_every and n % self.args.log_every < len(ids):
                        log.info("%d frames, %.1f frames/s", n, n / (time.perf_counter() - t0))
                self.post_process()
        tracing.resolve(pipeline.timings, pipeline.events)
        #: What the last run measured: host seconds of ``setup`` (flags,
        #: structure file, ``build``) and ``stream`` (the windows and
        #: ``post_process``), and the pipeline's (:attr:`WindowPipeline.timings`).
        self.timings = {**timings, **pipeline.timings}
        return n

    def _build_pipeline(self, argv, device, mesh) -> WindowPipeline:
        """Flags, device, structure file, ``build`` and window -> the pipeline."""
        from ..config import resolve_device
        from ..core.system import System

        parser = build_arg_parser(self.task_name)
        self.add_args(parser)
        args = parser.parse_args(argv)
        if args.mesh < 0:
            raise ValueError(f"--mesh takes a device count, got {args.mesh}")
        self.args = args
        self.device = resolve_device(device)
        if mesh is None and args.mesh:
            mesh = [self.device] * args.mesh if device is not None else frame_mesh(args.mesh)
        runner = as_runner(mesh)
        if runner is not None:
            self.device = runner.device
        structure, *trajectories = args.files
        paths = trajectories or [structure]
        system = System.from_file(structure, device=self.device)
        window_fn = self.build(system)
        reader = TrajectoryReader(paths, begin=FrameSpec.parse(args.begin),
                                  end=FrameSpec.parse(args.end), skip=args.skip)
        self.window = auto_window(paths[0], self.subset, requested=args.window)
        if not args.window:
            log.info("auto window: %d frames", self.window)
        return WindowPipeline(reader, self.window, _Decoded(window_fn), self.device,
                              quantized=WIRE, subset=self.subset, mesh=runner)


class _Decoded(torch.nn.Module):
    """A task's window function behind the wire form's decode, as a module
    (a mesh replicates it, and with it a window function that is one)."""

    def __init__(self, window_fn: Callable):
        super().__init__()
        self.window_fn = window_fn

    def forward(self, transport, boxes, invs):
        return self.window_fn(decode_window_coords(transport), boxes, invs)


@dataclass
class AnalysisContext:
    """The reference AnalysisContext {sys, consumed_frames, args}
    (analysis_task.rs:309-313)."""

    system: "object"
    consumed_frames: int
    args: argparse.Namespace


class AnalysisTask:
    """Reference-compatible per-frame analysis harness: the frames are read
    and swapped into the system on the host, and the task's ``System``
    computes on the device :meth:`run` is given (None: the card), so every
    ``Sel`` call of the hooks reaches it.

    Subclass and implement ``pre_process`` / ``process_frame`` /
    ``post_process`` (the Python-binding hook names,
    molar_python/python/pymolar/__init__.py:26-146); ``register_args`` (or
    ``add_args``) adds flags. ``run()`` parses the standard flags
    (:func:`build_arg_parser`), reads the structure file, streams the
    frames (:meth:`TrajectoryReader.iter_states`), swaps each into the
    system and calls the hooks, logging progress every ``--log`` frames.

    Hooks take either zero arguments (verbatim pymolar tasks) or an
    :class:`AnalysisContext`; the signature is inspected once a hook. As in
    pymolar, ``pre_process`` fires when the first frame arrives, with
    ``self.state`` set and ``self.src`` (the system) already holding it.
    ``--add-time`` offsets the times of a file whose clock restarts so
    they keep increasing. ``--window`` and ``--mesh`` are not read.
    """

    task_name = "analysis"

    def add_args(self, parser: argparse.ArgumentParser) -> None:
        if hasattr(self, "register_args"):
            self.register_args(parser)

    def pre_process(self, ctx: AnalysisContext) -> None:
        pass

    def process_frame(self, ctx: AnalysisContext) -> None:
        pass

    def post_process(self, ctx: AnalysisContext) -> None:
        pass

    def _call_hook(self, name: str, ctx: AnalysisContext) -> None:
        """Call hook ``name`` with ``ctx``, or with no argument when its
        signature takes none (decided once a hook name)."""
        cache = self.__dict__.setdefault("_hook_arity", {})
        fn = getattr(self, name)
        takes_ctx = cache.get(name)
        if takes_ctx is None:
            import inspect

            try:
                takes_ctx = any(
                    q.kind in (q.POSITIONAL_ONLY, q.POSITIONAL_OR_KEYWORD, q.VAR_POSITIONAL)
                    for q in inspect.signature(fn).parameters.values())
            except (TypeError, ValueError):
                takes_ctx = True
            cache[name] = takes_ctx
        if takes_ctx:
            fn(ctx)
        else:
            fn()

    def run(self, argv: Optional[Sequence[str]] = None, device=None) -> AnalysisContext:
        """Parse ``argv``, stream the frames through the hooks -> the
        context (``consumed_frames`` counts the frames processed). The
        task's system (``self.src``) computes on ``device``, resolved here
        (:func:`~molar_tpu_torch.config.resolve_device`: None is the card,
        which raises where there is none)."""
        from ..config import resolve_device
        from ..core.system import System

        self.device = resolve_device(device)
        parser = build_arg_parser(self.task_name)
        self.add_args(parser)
        args = parser.parse_args(argv)
        structure, *trajectories = args.files
        system = System.from_file(structure, device=self.device)
        self.src = system
        self.args = args
        reader = TrajectoryReader(trajectories or [structure], begin=FrameSpec.parse(args.begin),
                                  end=FrameSpec.parse(args.end), skip=args.skip)
        ctx = AnalysisContext(system=system, consumed_frames=0, args=args)
        t0 = time.perf_counter()
        time_offset = 0.0
        last_time = None
        for fr, st in reader.iter_states():
            if args.add_time:
                if last_time is not None and st.time + time_offset <= last_time:
                    time_offset = last_time  # a new file restarted its clock
                st.time += time_offset
                last_time = st.time
            if st.n_atoms != system.n_atoms:
                raise AnalysisError(f"frame has {st.n_atoms} atoms, system has {system.n_atoms}")
            system.set_state(st)
            self.state = st
            if ctx.consumed_frames == 0:
                self._call_hook("pre_process", ctx)
            self._call_hook("process_frame", ctx)
            ctx.consumed_frames += 1
            if args.log_every and ctx.consumed_frames % args.log_every == 0:
                log.info("frame %d (t=%.1f ps), %.1f frames/s", fr, st.time,
                         ctx.consumed_frames / (time.perf_counter() - t0))
        self._call_hook("post_process", ctx)
        return ctx
