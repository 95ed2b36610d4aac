"""Spans and counters of the port: host seconds, device seconds and counts by
name, added to a plain dict (a *sink*) that the calling thread installed.

    with tracing.sink(timings, window=k):     # this thread's totals go here
        with tracing.span("sasa.lists", device=dev):
            ...
        tracing.count("retried_windows")
    tracing.resolve(timings, events)          # once the results are on the host

A span is always a total: its ``time.perf_counter`` seconds are added to the
installed sink's key ``name`` (nothing where no sink is installed). A sink
is per thread: the feeder thread of
:class:`~molar_tpu_torch.tasks.trajectory.WindowPipeline` and its consumer
each install their own.

A span is also a profiler range, ``stage:<name>``, while a
``torch.profiler`` records in the calling thread (checked once as the span
opens). The range lies on the trace's clock, nests inside the ranges open
around it, and carries the window its sink was installed with (the
consumer's window index, in the pipeline) as its argument string. torch's
profiler is per thread: it records the thread that started it, so the spans
of a thread it does not cover (the feeder's) stay totals only. With
``device`` given, while a profiler records, a span also records a pair of
CUDA events on ``device``'s current stream into the sink's ``events`` list;
:func:`resolve` adds each pair's time to the key ``<name>@device`` once the
caller has the run's results on the host, so no span adds a wait inside
the stream. Such a value is the stream time between the two events: the
stage's device time where the device runs behind the host (the launch
queue full), and only the host's enqueue of the stage where the device runs
ahead and waits for it.

No environment variable or flag turns tracing on: a recording profiler
does. Without one a span costs a sink lookup, a profiler-state check and a
``perf_counter`` pair: about a microsecond of host time.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch
from torch.profiler import record_function

_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled


class _State(threading.local):
    """The calling thread's sink, its window and its list of device events."""

    sink: Optional[dict] = None
    window = None
    events: Optional[list] = None


_state = _State()


def _new_event():
    return torch.cuda.Event(enable_timing=True)


class sink:
    """``with sink(timings, window=k, events=pending):`` installs ``timings``
    (a dict, or None for no totals) as the calling thread's sink until the
    block ends, with the window its spans belong to (kept from the sink
    around it when None) and the list that receives the device event pairs
    of its spans (None: they record none)."""

    __slots__ = ("_sink", "_window", "_events", "_saved")

    def __init__(self, timings: Optional[dict], *, window=None, events: Optional[list] = None):
        self._sink = timings
        self._window = window
        self._events = events

    def __enter__(self):
        st = _state
        self._saved = (st.sink, st.window, st.events)
        st.sink = self._sink
        st.events = self._events
        if self._window is not None:
            st.window = self._window
        return self._sink

    def __exit__(self, *exc):
        _state.sink, _state.window, _state.events = self._saved
        return False


class span:
    """``with span(name, device=None):`` adds the block's host seconds to
    the installed sink's ``name``; under a recording profiler it is also the
    range ``stage:<name>``, and with ``device`` (a CUDA device) a pair of
    CUDA events that :func:`resolve` turns into ``name@device`` (see the
    module's docstring)."""

    __slots__ = ("name", "device", "_sink", "_t0", "_range", "_start")

    def __init__(self, name: str, *, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        st = _state
        self._sink = st.sink
        self._range = None
        if _profiling():
            self._open_range(st)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self._t0
        s = self._sink
        if s is not None:
            s[self.name] = s.get(self.name, 0.0) + dt
        if self._range is not None:
            self._close_range()
        return False

    def _open_range(self, st) -> None:
        self._range = record_function(f"stage:{self.name}",
                                      args=None if st.window is None else str(st.window))
        self._range.__enter__()
        self._start = None
        dev = self.device
        if st.events is not None and getattr(dev, "type", None) == "cuda":
            self._start = (st.events, torch.cuda.current_stream(dev), _new_event())
            self._start[2].record(self._start[1])

    def _close_range(self) -> None:
        if self._start is not None:
            events, stream, start = self._start
            end = _new_event()
            end.record(stream)
            events.append((self.name, start, end))
        self._range.__exit__(None, None, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the installed sink's ``name`` (nothing without a sink)."""
    s = _state.sink
    if s is not None:
        s[name] = s.get(name, 0) + n


def resolve(timings: dict, events: list) -> None:
    """Add the stream seconds of each pair in ``events`` (recorded by spans
    with ``device``) to ``timings[name + "@device"]``, and empty the list.
    Call it once the run's results have reached the host: then every pair
    has completed and the waits here return at once."""
    for name, start, end in events:
        end.synchronize()
        key = f"{name}@device"
        timings[key] = timings.get(key, 0.0) + start.elapsed_time(end) / 1e3
    events.clear()
