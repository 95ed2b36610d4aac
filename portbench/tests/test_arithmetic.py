"""The harness's arithmetic on hand-made inputs: interval unions and idle
gaps, the readers, work counts, bounds, membership digests."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench.drivers.common import LayerRun
from portbench.frozen import bounds, systems
from portbench.harness import checks, spec, trace, work


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert trace.union_seconds(iv) == pytest.approx(5.0)
    assert trace.merged(iv) == [(0, 3), (5, 6), (8, 9)]
    assert trace.gaps(trace.merged(iv), -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    assert trace.gaps(trace.merged(iv), 1, 2) == []


def test_gap_labels_take_the_most_overlapping_host_event():
    idle = [(0, 10e6), (20e6, 21e6)]
    host = [("decode", -5e6, 8e6), ("aten::to", 7e6, 10e6), ("python", 20.5e6, 30e6)]
    assert trace.label_gaps(idle, host) == [("decode", 10.0), ("python", 1.0)]
    assert trace.label_gaps([(0, 1e6)], []) == [("host_unmarked", 1.0)]


def _run(**kw):
    base = dict(frames=100, window_s=2.0)
    base.update(kw)
    return LayerRun(**base)


@pytest.mark.parametrize("metric,run,want", [
    ("decode_ms_per_frame", dict(spans={"decode": 0.05}), 0.5),
    ("feed_wait_pct", dict(spans={"get_wait": 0.5}), 25.0),
    ("enqueue_ms_per_frame", dict(spans={"enqueue": 0.2}), 2.0),
    ("device_idle_pct", dict(busy_s=0.5, traced_s=2.0), 75.0),
    ("fit_ms_per_frame", dict(parts={"fit": lambda: (0.25, None)}), 0.25),
    ("enqueue_ms_per_frame", dict(), None),
    ("fit_ms_per_frame", dict(), None),
    ("decode_ms_per_frame", dict(), None),
    ("device_idle_pct", dict(), None),
    ("search_roofline_pct", dict(), None),
    ("stream_fps.skewed", dict(untraced={"fps": 3000.0}), 3000.0),
    ("stream_fps", dict(), None),
])
def test_readers(metric, run, want):
    got = spec.reader(metric).read(_run(**run))
    assert got == (None if want is None else pytest.approx(want))


def test_a_grouped_name_reads_its_quantity():
    """``<quantity>.<group>``: the quantity's reader, under its own name."""
    assert spec.quantity("device_idle_pct.skewed") == "device_idle_pct"
    run = _run(busy_s=0.5, traced_s=2.0)
    assert spec.reader("device_idle_pct.skewed").read(run) == pytest.approx(75.0)


def test_roofline_share_names_its_bound():
    # 67e9 FLOPs take 1 ms at the float32 peak; the call took 4 ms.
    r = _run(parts={"search": lambda: (4.0, {"flops": 67e9, "bytes": 1e6, "items": 1})},
             card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert spec.reader("search_roofline_pct").read(r) == pytest.approx(25.0)
    assert "f32_flops" in r.notes[0] and "700.00 W" in r.notes[0]
    assert bounds.least_seconds(0, 3.35e12) == (pytest.approx(1.0), "hbm_bytes")


def _brute_pairs(x, box, src, cutoff):
    dims = np.maximum(np.floor(np.diag(box) / cutoff).astype(int), 1)
    cell = np.minimum(((x / np.diag(box)) % 1.0 * dims).astype(int), dims - 1)
    n = 0
    for s in src:
        for j in range(len(x)):
            d = (cell[j] - cell[s] + 1) % dims
            n += bool(np.all(d <= 2))
    return n


def test_candidate_pairs_against_a_loop():
    rng = np.random.default_rng(3)
    box = np.diag([2.1, 1.6, 1.9]).astype(np.float32)
    x = rng.uniform(-0.5, 2.5, (300, 3))
    src = np.arange(40)
    got = work.candidate_pairs(x[None], box, src, 0.5)
    assert got == _brute_pairs(x, box, src, 0.5)
    w = work.search_work(np.stack([x, x]), box, src, 0.5)
    assert w["items"] == 2 * got and w["flops"] == 9 * 2 * got and w["bytes"] == 2 * 300 * 13


def test_overlapping_pairs_against_a_loop():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 2, (2, 150, 3))
    r = rng.uniform(0.2, 0.4, 150)
    want = sum(np.linalg.norm(f[i] - f[j]) < r[i] + r[j]
               for f in x for i, j in itertools.permutations(range(150), 2))
    got = work.overlapping_pairs(torch.as_tensor(x), torch.as_tensor(r), block=64)
    assert got == want
    w = work.sasa_work(torch.as_tensor(x), torch.as_tensor(r), 32, 10)
    assert w["flops"] == 48 * want * 32


def test_digest_and_band():
    sure = np.array([3, 5, 9, 11])
    band = np.array([9, 40])
    n, c = checks.digest(sure)
    assert (n, c) == (4, 4 + 6 + 10 + 12)
    assert checks.digest_matches(n, c, sure, band)
    assert checks.digest_matches(3, 4 + 6 + 12, sure, band)          # 9 decided out
    assert checks.digest_matches(5, c + 41, sure, band)              # 40 decided in
    assert not checks.digest_matches(4, 4 + 6 + 12 + 8, sure, band)  # 7 in place of 9
    assert not checks.digest_matches(3, 4 + 6 + 10, sure, band)      # 11 lost
    assert checks.set_mismatch([3, 5, 11, 40], sure, band) == 0
    assert checks.set_mismatch([3, 5, 40], sure, band) == 1


def test_sample_is_seeded_and_spans_the_file():
    a = checks.sample(2**31 + 5, 512, 24)
    assert len(a) == 24 and a[0] == 0 and a[-1] == 511 and len(set(a)) == 24
    assert np.array_equal(a, checks.sample(2**31 + 5, 512, 24))
    assert not np.array_equal(a, checks.sample(2**31 + 6, 512, 24))
    assert np.array_equal(checks.sample(1, 5, 24), np.arange(5))


def test_check_limits():
    assert checks.Check("x", 0, 0).ok and not checks.Check("x", 1, 0).ok
    assert not checks.Check("x", float("nan"), 1.0).ok


def test_systems_compose_and_name_elements():
    cfg = spec.config(spec.load_benchmark(), "apoa1_92k")
    lab = systems.label(cfg["composition"]["protein_atoms"], 3, ["NA", "CL"])
    assert lab["elements"][:4] == ["N", "H", "C", "H"]
    assert lab["elements"][-5:] == ["O", "H", "H", "Na", "Cl"]
    d = systems.dodecahedron(7.8679)
    assert abs(np.linalg.det(d.astype(np.float64))) == pytest.approx(34440 / 100, rel=1e-3)
