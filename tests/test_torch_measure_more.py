"""Port vs JAX package: the measures beyond the headline's fit.

``inv3x3``, ``min_image`` (every ``pbc`` case, with and without correction
candidates), ``center_pbc``, ``gyration``, ``inertia_tensor``, ``inertia``,
``rmsd`` and the dense segment layout with its sums. The same numpy inputs
go through ``molar_tpu_torch.ops.measure`` on CPU tensors (float32, TF32
pinned off) and ``molar_tpu.ops.measure`` on JAX-CPU, and where the JAX
package's own tests use one, the float64 numpy ground truth. Tolerance:
1e-5 absolute (float32 sums over ~100 atoms round near 1e-6) unless a test
says otherwise, as ``tests/test_measure_device.py`` has it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.core.pbc import PBC_FULL, PeriodicBox
from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import measure_host

from molar_tpu_torch.ops import measure

from test_torch_measure import _rigid_frames, _t

ATOL = 1e-5

BOXES = {
    "triclinic": lambda: PeriodicBox.from_vectors_angles(6.0, 7.0, 8.0, 80.0, 85.0, 75.0),
    "orthorhombic": lambda: PeriodicBox(np.diag([6.0, 7.0, 8.0]).astype(np.float32)),
}


@pytest.fixture(scope="module", params=sorted(BOXES))
def data(request):
    ref, masses, frames = _rigid_frames(7)
    return ref, masses, frames, BOXES[request.param]()


def _per_frame(box, b):
    return (np.repeat(box.matrix[None], b, axis=0), np.repeat(box.inv[None], b, axis=0),
            np.repeat(box.padded_corrections()[None], b, axis=0))


def test_exports_cover_the_reference():
    assert set(jmeasure.__all__) | {"inv3x3"} <= set(measure.__all__)
    assert all(callable(getattr(measure, name)) for name in measure.__all__)


def test_inv3x3_matches_jax_and_numpy():
    rng = np.random.default_rng(2)
    m = (rng.normal(size=(6, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    got = measure.inv3x3(_t(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmeasure.inv3x3(jnp.asarray(m))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.linalg.inv(m.astype(np.float64)), atol=ATOL, rtol=0)
    one = measure.inv3x3(_t(m[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("corrections", [True, False])
@pytest.mark.parametrize("pbc", [(True, True, True), (True, False, True), (False, False, True),
                                 (False, False, False)])
def test_min_image_matches_jax(data, pbc, corrections):
    # 1e-5 on the vectors themselves: the two packages round the same
    # float32 steps, and the candidate choice (first shortest, strictly
    # shorter than the start) must agree for the vectors to agree.
    _, _, frames, box = data
    vecs = (3.0 * (frames[0] - frames[1])).astype(np.float32)
    corr = box.padded_corrections() if corrections else None
    got = measure.min_image(_t(vecs), _t(box.matrix), _t(box.inv),
                            None if corr is None else _t(corr), pbc).numpy()
    want = np.asarray(jmeasure.min_image(jnp.asarray(vecs), jnp.asarray(box.matrix),
                                         jnp.asarray(box.inv),
                                         None if corr is None else jnp.asarray(corr), pbc))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if all(pbc) and corrections:
        host = box.shortest_vector(vecs)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.linalg.norm(host, axis=1),
                                   atol=ATOL, rtol=0)
    if not any(pbc):
        np.testing.assert_allclose(got, vecs, atol=ATOL, rtol=0)


def test_min_image_batched_boxes_match_jax(data):
    # (B, n, 3) vectors against one box a frame, candidates a frame.
    _, _, frames, box = data
    b = frames.shape[0]
    scale = np.linspace(0.9, 1.1, b).astype(np.float32)[:, None, None]
    boxes = box.matrix[None] * scale
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    corr = box.padded_corrections()[None] * scale
    vecs = (2.0 * (frames - frames[::-1])).astype(np.float32)
    got = measure.min_image(_t(vecs), _t(boxes)[:, None], _t(invs)[:, None],
                            _t(corr)[:, None]).numpy()
    want = np.asarray(jmeasure.min_image(
        jnp.asarray(vecs), jnp.asarray(boxes)[:, None], jnp.asarray(invs)[:, None],
        jnp.asarray(corr)[:, None]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_min_image_tie_keeps_the_start():
    # A displacement of exactly half a box vector of a skewed box, where a
    # candidate is as long as the start: only a strictly shorter candidate
    # replaces it, in both packages.
    box = PeriodicBox(np.array([[4, 2, 0], [0, 4, 0], [0, 0, 4]], np.float32))
    vecs = np.array([[2.0, 0, 0], [-2.0, 0, 0], [1.0, 2.0, 0], [0.5, 0.25, 2.0]], np.float32)
    corr = box.padded_corrections()
    got = measure.min_image(_t(vecs), _t(box.matrix), _t(box.inv), _t(corr)).numpy()
    want = np.asarray(jmeasure.min_image(jnp.asarray(vecs), jnp.asarray(box.matrix),
                                         jnp.asarray(box.inv), jnp.asarray(corr)))
    np.testing.assert_array_equal(got, want)


def test_center_pbc_matches_jax_and_host(data):
    _, masses, frames, box = data
    b = frames.shape[0]
    boxes, invs, corr = _per_frame(box, b)
    got = measure.center_pbc(_t(frames), _t(masses), _t(boxes), _t(invs), _t(corr)).numpy()
    want = np.asarray(jmeasure.center_pbc(jnp.asarray(frames), jnp.asarray(masses),
                                          jnp.asarray(boxes), jnp.asarray(invs),
                                          jnp.asarray(corr)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for i in range(b):  # the JAX package's own bar against the float64 host
        np.testing.assert_allclose(got[i], measure_host.center_pbc(frames[i], masses, box,
                                                                   PBC_FULL), atol=2e-5)
    plain = measure.center_pbc(_t(frames), _t(masses), _t(boxes), _t(invs)).numpy()
    jplain = np.asarray(jmeasure.center_pbc(jnp.asarray(frames), jnp.asarray(masses),
                                            jnp.asarray(boxes), jnp.asarray(invs)))
    np.testing.assert_allclose(plain, jplain, atol=ATOL, rtol=0)


@pytest.mark.parametrize("periodic", [False, True])
def test_gyration_matches_jax_and_host(data, periodic):
    _, masses, frames, box = data
    kw, jkw = {}, {}
    if periodic:
        boxes, invs, corr = _per_frame(box, frames.shape[0])
        kw = dict(boxes=_t(boxes), invs=_t(invs), corrections=_t(corr))
        jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    got = measure.gyration(_t(frames), _t(masses), **kw).numpy()
    want = np.asarray(jmeasure.gyration(jnp.asarray(frames), jnp.asarray(masses), **jkw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if not periodic:
        for i in range(frames.shape[0]):
            assert abs(got[i] - measure_host.gyration(frames[i], masses)) < ATOL


@pytest.mark.parametrize("periodic", [False, True])
def test_inertia_tensor_matches_jax(data, periodic):
    # Entries are sums of ~120 terms of size m r^2 ~ 100: 1e-5 relative to
    # the largest entry.
    _, masses, frames, box = data
    kw, jkw = {}, {}
    if periodic:
        boxes, invs, corr = _per_frame(box, frames.shape[0])
        kw = dict(boxes=_t(boxes), invs=_t(invs), corrections=_t(corr))
        jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    t, c = (x.numpy() for x in measure.inertia_tensor(_t(frames), _t(masses), **kw))
    jt, jc = (np.asarray(x) for x in jmeasure.inertia_tensor(jnp.asarray(frames),
                                                             jnp.asarray(masses), **jkw))
    np.testing.assert_allclose(t, jt, atol=1e-5 * np.abs(jt).max(), rtol=0)
    np.testing.assert_allclose(c, jc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t, np.swapaxes(t, -1, -2), atol=1e-5 * np.abs(jt).max(), rtol=0)


def test_inertia_matches_jax_and_host(data):
    # The reference's bars: moments 2e-4 relative, axes equal up to the
    # sign of a column (|dot| > 0.999).
    _, masses, frames, _ = data
    vals, axes, com = (x.numpy() for x in measure.inertia(_t(frames), _t(masses)))
    jvals, jaxes, jcom = (np.asarray(x) for x in jmeasure.inertia(jnp.asarray(frames),
                                                                  jnp.asarray(masses)))
    np.testing.assert_allclose(vals, jvals, rtol=2e-4)
    np.testing.assert_allclose(com, jcom, atol=ATOL, rtol=0)
    for i in range(frames.shape[0]):
        wvals, waxes, wcom = measure_host.inertia(frames[i], masses)
        np.testing.assert_allclose(vals[i], wvals, rtol=2e-4)
        np.testing.assert_allclose(com[i], wcom, atol=ATOL)
        for col in range(3):
            assert abs(axes[i][:, col] @ waxes[:, col]) > 0.999
            assert abs(axes[i][:, col] @ jaxes[i][:, col]) > 0.999
        assert np.linalg.det(axes[i]) > 0.999  # right-handed
    assert np.all(np.diff(vals, axis=-1) >= 0)


def test_rmsd_matches_jax(data):
    ref, _, frames, _ = data
    got = measure.rmsd(_t(frames), _t(ref)).numpy()
    want = np.asarray(jmeasure.rmsd(jnp.asarray(frames), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    d = frames.astype(np.float64) - ref
    np.testing.assert_allclose(got, np.sqrt((d * d).sum(-1).mean(-1)), atol=ATOL, rtol=0)


def _ragged(seed, lo, hi, nseg):
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi, size=nseg)
    seg = np.repeat(np.arange(nseg), counts).astype(np.int32)
    return rng, counts, seg, rng.uniform(1, 16, seg.shape[0]).astype(np.float32)


@pytest.mark.parametrize("weighted", [True, False])
def test_contiguous_segments_dense_equals_the_reference(weighted):
    _, counts, seg, weights = _ragged(11, 1, 8, 37)
    w_in = weights if weighted else None
    for got, want in zip(measure.contiguous_segments_dense(seg + 5, w_in),
                         jmeasure.contiguous_segments_dense(seg + 5, w_in)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    idx, w, got_counts = measure.contiguous_segments_dense(seg, w_in)
    np.testing.assert_array_equal(got_counts, counts)
    assert w.shape == (int(counts.max()), len(counts)) and idx.shape == (w.size,)


def test_dense_segment_sum_nonuniform_layout():
    # Ragged runs of 1..7: padded to the longest with zero weight, the sums
    # are numpy's exact per-segment sums (the reference test's bar).
    rng, counts, seg, weights = _ragged(11, 1, 8, 37)
    idx, w, _ = measure.contiguous_segments_dense(seg, weights)
    vals = rng.normal(size=(4, seg.shape[0])).astype(np.float32)
    got = measure.dense_segment_sum(_t(vals), _t(idx), _t(w)).numpy()
    want = np.stack([np.add.reduceat(vals[b] * weights, np.r_[0, np.cumsum(counts)[:-1]])
                     for b in range(4)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jgot = np.asarray(jmeasure.dense_segment_sum(jnp.asarray(vals), jnp.asarray(idx),
                                                 jnp.asarray(w)))
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)  # an ulp of a sum of 7
    one = measure.dense_segment_sum(_t(vals[0]), _t(idx).long(), _t(w)).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("lead", [(3,), (), (2, 2)])
def test_dense_segment_com_gyration_matches_jax_and_numpy(lead):
    rng, counts, seg, masses = _ragged(12, 2, 9, 25)
    coords = rng.uniform(0, 5, lead + (seg.shape[0], 3)).astype(np.float32)
    idx, w, _ = measure.contiguous_segments_dense(seg, masses)
    com, gyr = (x.numpy() for x in measure.dense_segment_com_gyration(_t(coords), _t(idx), _t(w)))
    assert com.shape == lead + (len(counts), 3) and gyr.shape == lead + (len(counts),)
    jcom, jgyr = (np.asarray(x) for x in jmeasure.dense_segment_com_gyration(
        jnp.asarray(coords), jnp.asarray(idx), jnp.asarray(w)))
    np.testing.assert_allclose(com, jcom, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gyr, jgyr, atol=1e-6, rtol=1e-6)
    flat, fcom, fgyr = (a.reshape((-1,) + a.shape[len(lead):]) for a in (coords, com, gyr))
    for b in range(flat.shape[0]):
        for s in range(len(counts)):
            rows, m = flat[b][seg == s].astype(np.float64), masses[seg == s].astype(np.float64)
            want_com = (rows * m[:, None]).sum(0) / m.sum()
            d = rows - want_com
            np.testing.assert_allclose(fcom[b, s], want_com, atol=ATOL)
            np.testing.assert_allclose(fgyr[b, s], np.sqrt((m * (d * d).sum(1)).sum() / m.sum()),
                                       atol=ATOL)
