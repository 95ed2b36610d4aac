"""The host side of the port's window stream, on the CPU: the staging ring
that windows are decoded into, the decode pool, and the feeder's clock.

On the card the ring's buffers are pinned and a buffer is taken again only
after the CUDA event recorded behind its copies has completed. Here the
buffers are ordinary memory and the events are stand-ins that note when
they are waited on: the rule under test is the same one. The three wire
forms must decode to the same float32 frames as before, bit for bit,
whether or not they pass through the ring.
"""

import numpy as np
import pytest
import torch

from molar_tpu_torch import convert
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.io import xtc as io_xtc
from molar_tpu_torch.tasks import trajectory as traj

N_ATOMS, N_PROTEIN, N_FRAMES = 1200, 240, 22
FORMS = [False, True, "delta"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    system = wl.synth_system(N_ATOMS, N_PROTEIN)
    xtc = str(tmp_path_factory.mktemp("feeder") / "traj.xtc")
    wl.write_xtc(system, xtc, N_FRAMES)
    (coords, *_), = traj.TrajectoryReader([xtc]).iter_windows(N_FRAMES)
    return system, xtc, coords


class FakeEvent:
    """Stands in for the CUDA event behind a window's copies."""

    def __init__(self, log, k):
        self.log, self.k = log, k

    def synchronize(self):
        self.log.append(self.k)


def _subset(system, which):
    return {"all": None, "prefix": system.protein,
            "scattered": np.array([3, 700, N_ATOMS - 1])}[which]


@pytest.mark.parametrize("which", ["all", "prefix", "scattered"])
@pytest.mark.parametrize("form", FORMS)
def test_wire_forms_decode_bit_equal_through_the_ring(case, form, which):
    system, xtc, coords = case
    subset = _subset(system, which)
    want = coords if subset is None else coords[:, subset]
    depth, log = 3, []
    ring = traj.StagingRing(depth, pin=False)
    windows = traj.TrajectoryReader([xtc]).iter_windows(5, quantized=form, subset=subset,
                                                        alloc=ring)
    in_flight = []  # (first frame, the window as "device" tensors): depth - 1 at most
    k = frame = 0
    while True:
        ring.begin()
        # Taking a buffer again waits for the copies of its last window.
        assert log == list(range(max(0, k - depth + 1)))
        item = next(windows, None)
        if item is None:
            break
        # On the CPU the "device" tensors alias the ring: use them late.
        dev = convert.transport_to_torch(item, "cpu", alloc=ring)
        ring.end(FakeEvent(log, k))
        in_flight.append((frame, dev))
        frame += len(item[4])
        k += 1
        if len(in_flight) == depth:
            f0, (transport, boxes, invs) = in_flight.pop(0)
            got = traj.decode_window_coords(transport)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want[f0:f0 + len(got)])
    assert k == 5 and frame == N_FRAMES
    for f0, (transport, _, _) in in_flight:
        got = traj.decode_window_coords(transport)
        np.testing.assert_array_equal(got.numpy(), want[f0:f0 + len(got)])


@pytest.mark.parametrize("form", FORMS)
def test_wire_forms_are_what_they_were_without_a_ring(case, form):
    system, xtc, coords = case
    got = []
    for item in traj.TrajectoryReader([xtc]).iter_windows(8, quantized=form,
                                                          subset=system.protein):
        transport = item[0]
        if form == "delta":
            assert [a.dtype for a in transport[:2]] == [np.int16, np.int8]
        elif form:
            assert transport[0].dtype == np.int16 and len(transport) == 2
        else:
            assert transport.dtype == np.float32
        for a in (transport if isinstance(transport, tuple) else (transport,)):
            assert np.ndim(a) == 0 or a.flags["C_CONTIGUOUS"]
        got.append(traj.decode_window_coords(convert.transport_to_torch(item, "cpu")[0]))
    np.testing.assert_array_equal(torch.cat(got).numpy(), coords[:, system.protein])


def test_a_delta_window_that_does_not_fit_int8_ships_int16(case, tmp_path):
    system, _, _ = case
    path = str(tmp_path / "jumpy.xtc")
    from molar_tpu_torch import headline

    headline.write_trajectory(path, system.coords, system.box, 4, sigma=0.2)
    ring = traj.StagingRing(2, pin=False)
    ring.begin()
    (item,) = traj.TrajectoryReader([path]).iter_windows(4, quantized="delta", alloc=ring)
    assert len(item[0]) == 2 and item[0][0].dtype == np.int16 and ring.owns(item[0][0])
    (plain,) = traj.TrajectoryReader([path]).iter_windows(4)
    got = traj.decode_window_coords(convert.transport_to_torch(item, "cpu", alloc=ring)[0])
    np.testing.assert_array_equal(got.numpy(), plain[0])


@pytest.mark.parametrize("form", [False, True])
def test_the_codec_decodes_straight_into_the_ring(case, form):
    # No subset and no deltas: what the codec writes is what ships.
    _, xtc, _ = case
    ring = traj.StagingRing(2, pin=False)
    ring.begin()
    item = next(traj.TrajectoryReader([xtc]).iter_windows(6, quantized=form, alloc=ring))
    coords = item[0][0] if form else item[0]
    assert ring.owns(coords) and len(ring._chunks) == 1
    # The small arrays are staged on their way to the device.
    assert not ring.owns(item[1])
    convert.transport_to_torch(item, "cpu", alloc=ring)
    assert len(ring._chunks) == (4 if form else 3)  # + scale, boxes, invs


def test_ring_arrays_are_aligned_apart_and_survive_growth():
    ring = traj.StagingRing(2, pin=False)
    ring.begin()
    a = ring((3, 5), np.int16)
    b = ring((7,), np.float32)
    a[...] = 7
    b[...] = 1.5
    assert a.ctypes.data % 64 == 0 and b.ctypes.data % 64 == 0
    assert not np.shares_memory(a, b) and ring.owns(a) and ring.owns(a[1:]) and ring.owns(b)
    assert not ring.owns(np.zeros(3))
    big = ring((1 << 18,), np.float32)  # outgrows the first buffer
    big[...] = 2.0
    assert (a == 7).all() and (b == 1.5).all() and ring.owns(big)
    first = ring._buffers[0]
    ring.end(None)
    ring.begin()  # the other slot
    c = ring((4,), np.int8)
    assert not np.shares_memory(c, big) and ring._buffers[0] is first and not ring.owns(a)
    ring.begin()  # the first slot again, its larger buffer kept
    d = ring((1 << 18,), np.float32)
    assert ring._buffers[0] is first and np.shares_memory(d, big)


def test_ring_waits_for_a_slots_event_before_reuse_and_only_then():
    log = []
    ring = traj.StagingRing(3, pin=False)
    for k in range(7):
        ring.begin()
        assert log == list(range(max(0, k - 2)))
        ring((8,), np.float32)[...] = k
        ring.end(FakeEvent(log, k))
    assert log == [0, 1, 2, 3]


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_ring_of_a_pipeline_never_reuses_a_buffer_before_its_copy(depth):
    """At every queue depth the sweep tries, the ring a pipeline builds
    (``_QUEUE_DEPTH + 1`` buffers) hands out a buffer again only after the
    event of its last copy has been waited on, and the bytes of every
    window whose copy has not been waited on are intact."""
    log, live = [], {}
    ring = traj.StagingRing(depth + 1, pin=False)
    for k in range(3 * (depth + 1)):
        ring.begin()
        assert log == list(range(max(0, k - depth)))
        for j, a in live.items():
            if j not in log:
                assert (a == j).all(), (j, k)
        live[k] = ring((16,), np.float32)
        live[k][...] = k
        ring.end(FakeEvent(log, k))


class _CountingPool(io_xtc.ThreadPoolExecutor):
    made = 0
    shut = 0

    def __init__(self, *a, **kw):
        type(self).made += 1
        super().__init__(*a, **kw)

    def shutdown(self, *a, **kw):
        type(self).shut += 1
        super().shutdown(*a, **kw)


@pytest.fixture
def counting_pool(monkeypatch):
    _CountingPool.made = _CountingPool.shut = 0
    monkeypatch.setattr(io_xtc, "ThreadPoolExecutor", _CountingPool)
    monkeypatch.setattr(io_xtc.os, "cpu_count", lambda: 4)
    return _CountingPool


def test_one_decode_pool_per_handler_closed_with_it(case, counting_pool):
    _, xtc, coords = case
    with io_xtc.XtcHandler(xtc) as h:
        assert h._pool is None
        h.read_frames(0, 1)
        assert h._pool is None  # a single frame needs none
        a, _, _ = h.read_frames(0, 6)
        pool = h._pool
        b, scale, _, _ = h.read_frames_i16(6, 6, n_prefix=N_PROTEIN)
        assert pool is not None and h._pool is pool and pool._max_workers == 4
    assert h._pool is None and (counting_pool.made, counting_pool.shut) == (1, 1)
    np.testing.assert_array_equal(a, coords[:6])
    np.testing.assert_array_equal(b * scale, coords[6:12, :N_PROTEIN])


def test_a_stream_makes_one_pool_a_file_not_one_a_window(case, counting_pool):
    _, xtc, _ = case
    n = sum(1 for _ in traj.TrajectoryReader([xtc, xtc]).iter_windows(4, quantized="delta"))
    assert n == 12 and (counting_pool.made, counting_pool.shut) == (2, 2)


def test_decode_workers_bounds_the_pool(case, counting_pool, monkeypatch):
    _, xtc, coords = case
    monkeypatch.setattr(io_xtc, "DECODE_WORKERS", 2)
    with io_xtc.XtcHandler(xtc) as h:
        h.read_frames(0, 5)
        assert h._pool._max_workers == 2
    monkeypatch.setattr(io_xtc, "DECODE_WORKERS", 1)
    with io_xtc.XtcHandler(xtc) as h:
        got, _, _ = h.read_frames(0, 5)
        assert h._pool is None
    np.testing.assert_array_equal(got, coords[:5])


def test_readers_place_their_output_where_the_caller_says(case):
    _, xtc, coords = case
    asked = []

    def alloc(shape, dtype):
        asked.append((tuple(shape), np.dtype(dtype)))
        return np.empty(shape, dtype)

    with io_xtc.XtcHandler(xtc) as h:
        a, _, _ = h.read_frames(2, 3, alloc=alloc)
        b, _, _, _ = h.read_frames_i16(2, 3, alloc=alloc)
        c, _, _, _ = h.read_frames_i16(2, 3, n_prefix=100, alloc=alloc)
    assert asked == [((3, N_ATOMS, 3), np.dtype(np.float32)), ((3, N_ATOMS, 3), np.dtype(np.int16)),
                     ((3, 100 + io_xtc.XtcHandler.PREFIX_SLACK, 3), np.dtype(np.int16))]
    np.testing.assert_array_equal(a, coords[2:5])
    assert b.shape == (3, N_ATOMS, 3) and c.shape == (3, 100, 3)


@pytest.mark.parametrize("form", FORMS)
def test_pipeline_keeps_the_feeders_and_the_consumers_clock(case, form):
    system, xtc, coords = case
    reader = traj.TrajectoryReader([xtc])
    pipe = traj.WindowPipeline(reader, 4, lambda t, b, i: (traj.decode_window_coords(t),), "cpu",
                               quantized=form, subset=system.protein)
    assert pipe.timings == {}
    got = torch.cat([res[0] for _, res in pipe.run()])
    np.testing.assert_array_equal(got.numpy(), coords[:, system.protein])
    t = pipe.timings
    assert sorted(t) == sorted(["decode", "pack", "ring_wait", "copy_start", "put_wait",
                                "get_wait", "enqueue", "windows"])
    assert t["windows"] == 6 and t["decode"] > 0 and t["enqueue"] > 0 and t["ring_wait"] == 0
    assert all(v >= 0 for v in t.values())
    assert abs(reader.timings["decode"] - t["decode"]) < 1e-12
    # A second run reports its own seconds, not the sum.
    list(pipe.run())
    assert pipe.timings["windows"] == 6
    assert reader.timings["decode"] > pipe.timings["decode"]


def test_auto_window_counts_the_bytes_of_the_shipped_wire_form(case, monkeypatch):
    _, xtc, _ = case
    assert traj.WIRE in traj.WIRE_BYTES and traj.WIRE_BYTES == {"delta": 3, True: 6, False: 12}
    rows, frames = np.arange(100), 3 * 100 * 20 * 4
    by_form = {}
    for form in ("delta", True, False):
        monkeypatch.setattr(traj, "WIRE", form)
        by_form[form] = traj.auto_window(xtc, rows, target_bytes=frames, max_window=512)
    assert by_form == {"delta": N_FRAMES, True: N_FRAMES, False: 16}
    monkeypatch.setattr(traj, "WIRE", True)
    assert traj.auto_window(xtc, rows, target_bytes=6 * 100 * 9) == 8
