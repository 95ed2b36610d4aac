"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the whole
timed window, reduced to the device's busy seconds (the union of the
intervals of every device operation, kernels and copies, as
``chip_smoke.py``'s ``_device_profile`` takes it), the device operations
with the most time, and the longest idle gaps by what the host was doing.

The benchmark marks its own spans with ``record_function("portbench:...")``
around its calls into the program; a gap is named after the host span or
operation that overlaps it most.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

WINDOW_SPAN = "portbench:window"
# Ranges that ``record_function`` also draws on the device's timeline: they
# span kernels and the gaps between them, so they are no device work.
_ANNOTATIONS = ("portbench:", "stage:")
# Gaps labelled by the host span under them, longest first.
_LABELLED_GAPS = 200


def union_seconds(intervals) -> float:
    """Length covered by ``intervals`` [(start, end), ...] (any unit)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between the merged ``busy`` intervals."""
    out, cur = [], lo
    for a, b in busy:
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def label_gaps(idle, host_events) -> list[tuple[str, float]]:
    """Seconds of the longest ``idle`` gaps (us) summed by the name of the
    host event (name, start us, end us) that overlaps each most."""
    if not idle:
        return []
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:_LABELLED_GAPS]
    names = [e[0] for e in host_events]
    starts = np.array([e[1] for e in host_events], np.float64)
    ends = np.array([e[2] for e in host_events], np.float64)
    by: dict[str, float] = {}
    for a, b in idle:
        label = "host_unmarked"
        if len(starts):
            ov = np.minimum(ends, b) - np.maximum(starts, a)
            k = int(np.argmax(ov))
            if ov[k] > 0:
                label = names[k]
        by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:10]


class Trace:
    """``with Trace(on) as tr: ...`` profiles the block when ``on``; then
    ``tr.window_s``, ``tr.busy_s``, ``tr.device_ops`` and ``tr.idle_gaps``.
    ``device_only`` records the device's activity alone (no host events, so
    no gap labels): the busy time of an untraced window, at the cost of the
    profiler's device records only."""

    def __init__(self, on: bool, device_only: bool = False):
        self.on = on
        self.device_only = device_only
        self.window_s = None
        self.busy_s = None
        self.device_ops: list = []
        self.idle_gaps: list = []
        self._prof = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            activities = [ProfilerActivity.CUDA]
            if not self.device_only:
                activities.insert(0, ProfilerActivity.CPU)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    @contextlib.contextmanager
    def window(self):
        """The timed window inside the profiled block."""
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            yield
        self.window_s = time.perf_counter() - t0

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        # The raw events: the parsed event tree of a long window of small
        # operations takes minutes to build.
        device, host, win = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            a = e.start_ns() / 1e3
            b = a + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                if not (e.is_user_annotation() or name.startswith(_ANNOTATIONS)):
                    device.append((a, b, name))
            elif name == WINDOW_SPAN:
                win = (a, b)
            else:
                host.append((name, a, b))
        if win is not None:
            device = [d for d in device if d[1] > win[0] and d[0] < win[1]]
            self.window_s = (win[1] - win[0]) / 1e6
        self.busy_s = union_seconds((a, b) for a, b, _ in device) / 1e6
        ops: dict[str, float] = {}
        for a, b, name in device:
            key = name if len(name) <= 96 else name[:93] + "..."
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        if win is not None:
            idle = gaps(merged((a, b) for a, b, _ in device), win[0], win[1])
            self.idle_gaps = label_gaps(idle, host)
        return False
