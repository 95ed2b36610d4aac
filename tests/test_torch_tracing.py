"""The port's spans and counters (``molar_tpu_torch.tracing``) on the CPU:
totals by name in the sink a thread installed, profiler ranges only while a
profiler records, ranges on the trace's clock inside the pipeline's
``enqueue``, device event pairs resolved into ``<name>@device``, and the
overflow retry's own span and counters."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from molar_tpu_torch import headline, tracing
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.io.gro import write_gro
from molar_tpu_torch.tasks import trajectory as traj

N_ATOMS, N_PROTEIN, N_FRAMES, WINDOW = 600, 120, 14, 4
N_WINDOWS = -(-N_FRAMES // WINDOW)
STAGE_S = 0.02


@pytest.fixture(scope="module")
def xtc(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "traj.xtc")
    wl.write_xtc(wl.synth_system(N_ATOMS, N_PROTEIN), path, N_FRAMES)
    return path


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def _staged(transport, boxes, invs):
    """A window function of two spans of ``STAGE_S`` each."""
    with tracing.span("probe.decode"):
        coords = traj.decode_window_coords(transport)
        _busy(STAGE_S)
    with tracing.span("probe.sum"):
        _busy(STAGE_S)
        return (coords.sum(dim=(1, 2)),)


@pytest.fixture
def rf_calls(monkeypatch):
    """Every ``record_function`` a span opens, as (name, args), still opened."""
    calls = []
    real = tracing.record_function

    def spy(name, args=None):
        calls.append((name, args))
        return real(name, args=args)

    monkeypatch.setattr(tracing, "record_function", spy)
    return calls


def _ranges(prof, prefix="stage:"):
    """(name, start ns, end ns) of the trace's host ranges named ``prefix``..."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: r[1])


# ------------------------------------------------------------------- sinks


def test_spans_add_to_the_installed_sink_by_name():
    t = {}
    with tracing.sink(t):
        for _ in range(3):
            with tracing.span("a"):
                _busy(0.001)
        with tracing.span("b"):
            pass
        tracing.count("n")
        tracing.count("n", 4)
    assert set(t) == {"a", "b", "n"}
    assert t["a"] >= 0.003 and 0 <= t["b"] < t["a"]
    assert t["n"] == 5 and isinstance(t["n"], int)


def test_nested_spans_each_add_to_their_own_name():
    t = {}
    with tracing.sink(t):
        with tracing.span("outer"):
            _busy(0.002)
            with tracing.span("inner"):
                _busy(0.002)
    assert t["inner"] >= 0.002 and t["outer"] >= t["inner"] + 0.002


def test_without_a_sink_spans_and_counts_add_nothing():
    with tracing.span("a"):
        pass
    tracing.count("n")
    t = {}
    with tracing.sink(t):
        with tracing.sink(None):
            with tracing.span("a"):
                pass
            tracing.count("n")
        with tracing.span("b"):
            pass
    assert set(t) == {"b"}


def test_a_sink_restores_the_one_around_it_and_keeps_its_window():
    outer, inner = {}, {}
    with tracing.sink(outer, window=3):
        with tracing.sink(inner):
            assert tracing._state.window == 3
            with tracing.span("x"):
                pass
        assert tracing._state.sink is outer
        with tracing.sink(inner, window=4):
            assert tracing._state.window == 4
        assert tracing._state.window == 3
        with tracing.span("y"):
            pass
    assert set(outer) == {"y"} and set(inner) == {"x"}
    assert tracing._state.sink is None


def test_sinks_are_per_thread():
    """Each thread adds to the sink it installed: a stress run of more
    threads than cores, switching often, loses no span and leaks none."""
    n_threads, n_spans = 16, 400
    sinks = [{} for _ in range(n_threads)]
    go = threading.Barrier(n_threads)

    def work(k):
        go.wait()
        with tracing.sink(sinks[k]):
            for _ in range(n_spans):
                with tracing.span(f"t{k}"):
                    pass
                tracing.count("spans")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    for k, s in enumerate(sinks):
        assert set(s) == {f"t{k}", "spans"} and s["spans"] == n_spans


def test_the_feeders_and_the_consumers_sinks(xtc):
    """The feeder's spans land in the pipeline's timings from its own
    thread, the reader's in the reader's, the window function's in the
    pipeline's; the caller's sink sees only what the caller does between
    windows."""
    reader = traj.TrajectoryReader([xtc])
    pipe = traj.WindowPipeline(reader, WINDOW, _staged, "cpu", quantized=True)
    caller = {}
    with tracing.sink(caller):
        for _ in pipe.run():
            with tracing.span("caller.accumulate"):
                pass
    t = pipe.timings
    assert set(caller) == {"caller.accumulate"}
    assert {"put_wait", "copy_start", "get_wait", "enqueue", "probe.decode",
            "probe.sum"} <= set(t)
    assert t["windows"] == N_WINDOWS and t["decode"] > 0
    assert t["decode"] == reader.timings["decode"]
    assert t["probe.decode"] >= N_WINDOWS * STAGE_S and t["probe.sum"] >= N_WINDOWS * STAGE_S
    assert t["enqueue"] >= t["probe.decode"] + t["probe.sum"]
    assert not any(k.endswith("@device") for k in t)


# ---------------------------------------------------------------- profiler


def test_no_profiler_range_opens_while_no_profiler_records(xtc, rf_calls):
    t = {}
    with tracing.sink(t):
        for _ in range(10):
            with tracing.span("a", device=torch.device("cpu")):
                pass
    list(traj.WindowPipeline(traj.TrajectoryReader([xtc]), WINDOW, _staged, "cpu").run())
    assert rf_calls == [] and t["a"] >= 0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            pass
    assert rf_calls == [("stage:a", None)]


def test_a_range_carries_its_sinks_window(rf_calls):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.sink({}, window=2):
            with tracing.span("a"):
                pass
            with tracing.sink({}, window=9):
                with tracing.span("b"):
                    pass
        with tracing.span("c"):
            pass
    assert rf_calls == [("stage:a", "2"), ("stage:b", "9"), ("stage:c", None)]


def test_pipeline_spans_are_ranges_on_the_traces_clock(xtc, rf_calls):
    """Under a CPU profiler: one ``stage:<name>`` range a span and window,
    each inside the consumer's ``stage:enqueue`` of its window and opened
    with the window's index, and each name's summed range length within 5 %
    of the sink's total."""
    pipe = traj.WindowPipeline(traj.TrajectoryReader([xtc]), WINDOW, _staged, "cpu",
                               quantized=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(pipe.run())
    ranges = _ranges(prof)
    enqueue = [r for r in ranges if r[0] == "stage:enqueue"]
    assert len(enqueue) == N_WINDOWS
    for name in ("probe.decode", "probe.sum"):
        mine = [r for r in ranges if r[0] == f"stage:{name}"]
        assert len(mine) == N_WINDOWS
        for k, (_, a, b) in enumerate(mine):
            assert enqueue[k][1] <= a and b <= enqueue[k][2], (name, k)
        traced = sum(b - a for _, a, b in mine) / 1e9
        assert traced == pytest.approx(pipe.timings[name], rel=0.05)
        assert [args for n, args in rf_calls if n == f"stage:{name}"] == \
            [str(k) for k in range(N_WINDOWS)]
    assert [args for n, args in rf_calls if n == "stage:enqueue"] == \
        [str(k) for k in range(N_WINDOWS)]


class _FakeEvent:
    """A CUDA event stand-in: its time is the order it was recorded in."""

    clock = [0]

    def __init__(self):
        self.at = None
        self.waited = False

    def record(self, stream=None):
        _FakeEvent.clock[0] += 1
        self.at = _FakeEvent.clock[0]

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)  # ms: one second a tick


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(tracing, "_new_event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    return torch.device("cuda", 0)


def test_device_spans_resolve_into_at_device_keys(fake_cuda):
    t, events = {}, []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.sink(t, events=events):
            with tracing.span("stage_a", device=fake_cuda):       # ticks 1, 4
                with tracing.span("stage_b", device=fake_cuda):   # ticks 2, 3
                    pass
            with tracing.span("host_only"):
                pass
            with tracing.span("stage_a", device=fake_cuda):       # ticks 5, 6
                pass
        with tracing.sink(t):  # no event list: no events
            with tracing.span("stage_c", device=fake_cuda):
                pass
    assert [n for n, _, _ in events] == ["stage_b", "stage_a", "stage_a"]
    ends = [e for _, _, e in events]
    tracing.resolve(t, events)
    assert events == [] and all(e.waited for e in ends)
    assert t["stage_a@device"] == pytest.approx(3.0 + 1.0)
    assert t["stage_b@device"] == pytest.approx(1.0)
    assert "stage_c@device" not in t and "host_only@device" not in t
    assert t["stage_a"] > 0 and t["stage_c"] > 0


def test_device_spans_record_no_event_while_no_profiler_records(fake_cuda):
    t, events = {}, []
    with tracing.sink(t, events=events):
        with tracing.span("stage_a", device=fake_cuda):
            pass
    assert events == [] and set(t) == {"stage_a"}


# -------------------------------------------------------------- the retry


def _overflowing(flag_window):
    """A window function builder whose tier 0 flags every window for which
    ``flag_window(frames)`` holds (the retry tests' planted overflow); each
    call counts itself as ``calls``."""
    def build(tier):
        def fn(transport, boxes, invs):
            tracing.count("calls")
            with tracing.span("probe.sum"):
                _busy(STAGE_S)
                c = traj.decode_window_coords(transport)
                return c.sum(dim=(1, 2)), torch.full((c.shape[0],), tier == 0
                                                     and flag_window(c.shape[0]))
        return fn
    return build


@pytest.fixture
def made(monkeypatch):
    """Every ``WindowPipeline`` made while the test runs."""
    pipes = []
    base = traj.WindowPipeline

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pipes.append(self)

    monkeypatch.setattr(traj, "WindowPipeline", Recorded)
    return pipes


def test_the_retry_is_one_span_with_its_windows_counted(xtc, made):
    results, retried = traj.run_with_overflow_retry(
        traj.TrajectoryReader([xtc]), WINDOW, _overflowing(lambda b: b == WINDOW), "cpu",
        overflow_of=lambda r: r[1], quantized=True)
    full = N_FRAMES // WINDOW
    assert retried == full > 0
    assert not any(bool(r[1].any()) for _, r in results)
    (pipe,) = made
    t = pipe.timings
    assert t["retried_windows"] == retried and t["retry"] > 0
    # The re-runs' own spans and counts add to no total.
    assert t["calls"] == t["windows"] == N_WINDOWS
    assert "device_allocs" not in t  # a CPU stream


def test_a_clean_stream_reports_no_retry(xtc, made):
    results, retried = traj.run_with_overflow_retry(
        traj.TrajectoryReader([xtc]), WINDOW, _overflowing(lambda b: False), "cpu",
        overflow_of=lambda r: r[1], quantized="delta")
    (pipe,) = made
    assert retried == 0 and len(results) == N_WINDOWS
    assert pipe.timings["retry"] == 0.0 and pipe.timings["retried_windows"] == 0


def test_the_retry_pass_is_a_range_under_the_profiler(xtc, made, rf_calls):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traj.run_with_overflow_retry(
            traj.TrajectoryReader([xtc]), WINDOW, _overflowing(lambda b: b == WINDOW), "cpu",
            overflow_of=lambda r: r[1], quantized=True)
    ranges = _ranges(prof)
    (retry,) = [r for r in ranges if r[0] == "stage:retry"]
    inside = [r for r in ranges if r[0] == "stage:probe.sum" and retry[1] <= r[1] <= retry[2]]
    assert len(inside) == N_FRAMES // WINDOW
    assert (retry[2] - retry[1]) / 1e9 == pytest.approx(made[0].timings["retry"], rel=0.05)


def test_device_allocs_counts_the_allocators_cudamallocs(monkeypatch):
    stats = iter([{"num_device_alloc": 7}, {"num_device_alloc": 19}])
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: next(stats))
    dev = torch.device("cuda", 0)
    assert traj._device_allocs(dev) == 7 and traj._device_allocs(dev) == 19
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device=None: {"segment.all.allocated": 5})
    assert traj._device_allocs(dev) == 5
    assert traj._device_allocs(torch.device("cpu")) is None


def test_window_analysis_task_times_its_setup_and_stream(xtc, tmp_path):
    """``WindowAnalysisTask.timings``: ``setup`` and ``stream`` beside the
    pipeline's keys; the task's own spans add to the stream's sink."""
    system = wl.synth_system(N_ATOMS, N_PROTEIN)
    gro = str(tmp_path / "conf.gro")
    write_gro(gro, headline.label_topology(N_ATOMS, N_PROTEIN),
              State(coords=system.coords, box=PeriodicBox(system.box)))

    class Sums(traj.WindowAnalysisTask):
        n = 0

        def build(self, system):
            return lambda c, b, i: (c.sum(dim=(1, 2)),)

        def accumulate(self, ids, results):
            with tracing.span("task.accumulate"):
                self.n += len(ids)

    task = Sums()
    n = task.run(["-f", gro, xtc, "--window", str(WINDOW)], device="cpu")
    t = task.timings
    assert n == task.n == N_FRAMES
    assert t["setup"] > 0 and t["stream"] >= t["task.accumulate"] > 0
    assert t["windows"] == N_WINDOWS and t["stream"] >= t["enqueue"]
