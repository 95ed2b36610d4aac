"""Port vs JAX package: XTC windows, transport forms and their decode.

The same XTC files (written by ``molar_tpu``) stream through both
``TrajectoryReader.iter_windows`` and both ``decode_window_coords``; every
window must carry the same frames, boxes and times, and decode bit-exactly
to the same coordinates in the f32, i16 and i8-delta forms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.io.xtc import XtcHandler as JaxXtc
from molar_tpu.tasks import trajectory as jtraj

from molar_tpu_torch import convert
from molar_tpu_torch.io.xtc import MalformedFileError, XtcHandler
from molar_tpu_torch.tasks import trajectory as ttraj


def _write(path, n_atoms, n_frames, seed, step_sigma=0.004, jump_at=None):
    rng = np.random.default_rng(seed)
    box = np.diag([4.0, 4.5, 5.0]).astype(np.float32)
    c = rng.uniform(0.5, 3.5, (n_atoms, 3)).astype(np.float32)
    with JaxXtc(str(path), "w") as w:
        for k in range(n_frames):
            c = c + rng.normal(0, step_sigma, c.shape).astype(np.float32)
            if jump_at is not None and k >= jump_at:
                c = c + 0.5  # 500 quantized units: beyond int8
            w.write_raw(c, box, step=k, time=float(k))
    return str(path)


@pytest.fixture(scope="module")
def trajs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_decode")
    return [_write(d / "a.xtc", 300, 11, seed=1), _write(d / "b.xtc", 300, 6, seed=2)]


def _decode_torch(coords):
    t, _, _ = convert.transport_to_torch((coords, np.eye(3), np.eye(3)), "cpu")
    return ttraj.decode_window_coords(t).numpy()


def _form(coords):
    return len(coords) if isinstance(coords, tuple) else 0


def _pair(trajs, window, quantized, subset=None, **reader_kw):
    jkw = {k: jtraj.FrameSpec(frame=v) for k, v in reader_kw.items() if k != "skip"}
    skip = reader_kw.get("skip", 1)
    j = list(jtraj.TrajectoryReader(trajs, skip=skip, **jkw).iter_windows(
        window, quantized=quantized, subset=subset))
    t = list(ttraj.TrajectoryReader(
        trajs, skip=skip, **{k: v for k, v in reader_kw.items() if k != "skip"}
    ).iter_windows(window, quantized=quantized, subset=subset))
    return j, t


@pytest.mark.parametrize("quantized", [False, True, "delta"])
@pytest.mark.parametrize("subset", [None, "scattered", "prefix"])
def test_windows_and_decode_bit_exact(trajs, quantized, subset):
    sub = {None: None, "scattered": np.array([250, 7, 3, 119, 0]),
           "prefix": np.array([33, 2, 17, 36, 0])}[subset]
    j, t = _pair(trajs, 4, quantized, sub)
    assert len(j) == len(t) > 0
    for (jc, jb, ji, jt, jids), (tc, tb, ti, tt, tids) in zip(j, t):
        assert _form(jc) == _form(tc)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)
        want = np.asarray(jtraj.decode_window_coords(
            jc if not isinstance(jc, tuple) else tuple(jnp.asarray(a) for a in jc)))
        got = _decode_torch(tc)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if quantized == "delta":
        assert any(_form(c) == 3 for c, *_ in t)


@pytest.mark.parametrize("reader_kw", [
    dict(skip=3), dict(begin=2, end=13), dict(begin=5, skip=2), dict(end=3),
])
def test_begin_end_skip_across_files(trajs, reader_kw):
    j, t = _pair(trajs, 4, "delta", **reader_kw)
    assert [w[4].tolist() for w in t] == [w[4].tolist() for w in j]
    for jw, tw in zip(j, t):
        np.testing.assert_array_equal(_decode_torch(tw[0]), np.asarray(
            jtraj.decode_window_coords(jw[0] if not isinstance(jw[0], tuple)
                                       else tuple(jnp.asarray(a) for a in jw[0]))))


def test_delta_falls_back_to_i16_pair(tmp_path):
    p = _write(tmp_path / "jump.xtc", 50, 8, seed=9, step_sigma=0.003, jump_at=4)
    j, t = _pair([p], 4, "delta")
    assert [_form(w[0]) for w in t] == [_form(w[0]) for w in j] == [3, 2]
    for jw, tw in zip(j, t):
        np.testing.assert_array_equal(
            _decode_torch(tw[0]),
            np.asarray(jtraj.decode_window_coords(tuple(jnp.asarray(a) for a in jw[0]))))


def test_handler_reads_match(trajs):
    jh, th = JaxXtc(trajs[0]), XtcHandler(trajs[0])
    try:
        assert th.n_frames == jh.n_frames and th.n_atoms == jh.n_atoms
        np.testing.assert_array_equal(th.times, jh.times)
        fr, jfr = th.read_frame(5), jh.read_frame(5)
        np.testing.assert_array_equal(fr.coords, jfr.coords)
        np.testing.assert_array_equal(fr.box.matrix, jfr.box.matrix)
        assert (fr.time, fr.step) == (jfr.time, jfr.step)
        for got, want in zip(th.read_frames(2, 5), jh.read_frames(2, 5)):
            np.testing.assert_array_equal(got, want)
        for n_prefix in (None, 37):
            got = th.read_frames_i16(1, 6, n_prefix=n_prefix)
            want = jh.read_frames_i16(1, 6, n_prefix=n_prefix)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    finally:
        jh.close()
        th.close()


def test_writer_matches_reference_bytes(tmp_path):
    rng = np.random.default_rng(4)
    box = np.diag([3.0, 3.0, 3.0]).astype(np.float32)
    frames = rng.uniform(0, 3, (3, 120, 3)).astype(np.float32)
    with XtcHandler(str(tmp_path / "t.xtc"), "w") as w:
        for k, c in enumerate(frames):
            w.write_raw(c, box, step=k, time=0.5 * k)
    with JaxXtc(str(tmp_path / "j.xtc"), "w") as w:
        for k, c in enumerate(frames):
            w.write_raw(c, box, step=k, time=0.5 * k)
    assert (tmp_path / "t.xtc").read_bytes() == (tmp_path / "j.xtc").read_bytes()


def test_window_pipeline_on_cpu_matches_reader(trajs):
    reader = ttraj.TrajectoryReader(trajs)
    got = list(ttraj.WindowPipeline(
        reader, 5, lambda c, b, i: ttraj.decode_window_coords(c), "cpu", quantized="delta"
    ).run())
    want = [(w[4], _decode_torch(w[0])) for w in reader.iter_windows(5, quantized="delta")]
    assert len(got) == len(want)
    for (gids, gc), (wids, wc) in zip(got, want):
        np.testing.assert_array_equal(gids, wids)
        np.testing.assert_array_equal(gc.numpy(), wc)


def test_pipeline_surfaces_decode_errors(tmp_path):
    bad = tmp_path / "bad.xtc"
    bad.write_bytes(b"\0" * 200)
    with pytest.raises(MalformedFileError):
        list(ttraj.WindowPipeline(
            ttraj.TrajectoryReader([str(bad)]), 4, lambda *a: a, "cpu").run())


def test_invert_boxes_matches_reference():
    rng = np.random.default_rng(0)
    boxes = (np.eye(3) * 4 + rng.uniform(0, 0.5, (5, 3, 3))).astype(np.float32)
    np.testing.assert_array_equal(ttraj._invert_boxes(boxes), jtraj._invert_boxes(boxes))


def test_non_xtc_trajectory_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        ttraj.TrajectoryReader([str(tmp_path / "x.trr")])


def test_decode_forms_exact_int_math():
    rng = np.random.default_rng(5)
    ints = rng.integers(-20000, 20000, (1, 64, 3)).astype(np.int16)
    steps = rng.integers(-127, 128, (6, 64, 3)).astype(np.int8)
    scale = np.float32(1.0) / np.float32(1000.0)
    full = np.concatenate([ints, ints + np.cumsum(steps.astype(np.int32), 0)]).astype(np.int16)
    want = np.asarray(jtraj.decode_window_coords(
        (jnp.asarray(full[0]), jnp.asarray(steps), jnp.asarray(scale))))
    np.testing.assert_array_equal(_decode_torch((full[0], steps, scale)), want)
    np.testing.assert_array_equal(_decode_torch((full, scale)), want)
    assert torch.equal(ttraj.decode_window_coords(torch.ones(2, 3, 3)), torch.ones(2, 3, 3))


@pytest.mark.parametrize("skip", [1, 3])
def test_overflow_retry_rereads_flagged_windows_across_files(trajs, skip):
    # Tier 0 flags every full window; tier 1 is clean. The by-range re-read
    # must reproduce each flagged window's frames (skip phase included).
    def build(tier):
        def fn(transport, boxes, invs):
            c = ttraj.decode_window_coords(transport)
            return c.sum(dim=(1, 2)), torch.full((c.shape[0],), tier == 0 and c.shape[0] == 4)
        return fn

    reader = ttraj.TrajectoryReader(trajs, skip=skip)
    results, retried = ttraj.run_with_overflow_retry(
        reader, 4, build, "cpu", overflow_of=lambda r: r[1], quantized="delta")
    direct = list(reader.iter_windows(4, quantized="delta"))
    assert retried == sum(len(w[4]) == 4 for w in direct) > 0
    assert [ids.tolist() for ids, _ in results] == [w[4].tolist() for w in direct]
    for (_, (sums, ofl)), w in zip(results, direct):
        assert not ofl.any()
        want = torch.from_numpy(_decode_torch(w[0])).sum(dim=(1, 2))
        np.testing.assert_array_equal(sums.numpy(), want.numpy())


def test_overflow_retry_raises_when_the_last_tier_overflows(trajs):
    def build(tier):
        return lambda transport, boxes, invs: torch.ones(1, dtype=torch.bool)

    with pytest.raises(ttraj.AnalysisError, match="still overflows"):
        ttraj.run_with_overflow_retry(ttraj.TrajectoryReader(trajs), 4, build, "cpu",
                                      overflow_of=lambda r: r, n_tiers=2)
