"""Port vs JAX package: the headline's measures (fit, Kabsch, RMSD, centre).

The same numpy inputs go through ``molar_tpu_torch.ops.measure`` (float32,
TF32 pinned off), ``molar_tpu.ops.measure`` on JAX-CPU and the float64 numpy
ground truth ``measure_host``. The contract is the JAX package's: 1e-5
absolute on RMSD and centres (float32 sums over ~100 atoms round near 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import measure_host

from molar_tpu_torch.ops import measure

ATOL = 1e-5


def _rigid_frames(seed, n=120, b=5, noise=0.01):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    masses = rng.uniform(1, 16, n).astype(np.float32)
    frames = np.empty((b, n, 3), np.float32)
    for i in range(b):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0, 2 * np.pi)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        r = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)
        frames[i] = (ref @ r.T + rng.uniform(-3, 3, 3) + rng.normal(0, noise, (n, 3)))
    return ref, masses, frames


@pytest.fixture(scope="module", params=[7, 23])
def data(request):
    return _rigid_frames(request.param)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_fp32_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("weighted", [True, False])
def test_center_matches_jax_and_host(data, weighted):
    _, masses, frames = data
    w = masses if weighted else None
    got = measure.center(_t(frames), None if w is None else _t(w)).numpy()
    want = np.asarray(jmeasure.center(jnp.asarray(frames), None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for i in range(frames.shape[0]):
        np.testing.assert_allclose(got[i], measure_host.center(frames[i], w), atol=ATOL, rtol=0)


def test_rmsd_mw_matches_jax_and_host(data):
    ref, masses, frames = data
    got = measure.rmsd_mw(_t(frames), _t(ref), _t(masses)).numpy()
    want = np.asarray(jmeasure.rmsd_mw(jnp.asarray(frames), jnp.asarray(ref), jnp.asarray(masses)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for i in range(frames.shape[0]):
        assert abs(got[i] - measure_host.rmsd_mw(frames[i], ref, masses)) < ATOL


def test_fit_rmsd_matches_jax_and_host(data):
    ref, masses, frames = data
    rmsd, r, t = (x.numpy() for x in measure.fit_rmsd(_t(frames), _t(ref), _t(masses)))
    jrmsd, jr, jt = (np.asarray(x) for x in jmeasure.fit_rmsd(
        jnp.asarray(frames), jnp.asarray(ref), jnp.asarray(masses)))
    np.testing.assert_allclose(rmsd, jrmsd, atol=ATOL, rtol=0)
    np.testing.assert_allclose(r, jr, atol=1e-4, rtol=0)
    for i in range(frames.shape[0]):
        hr, ht = measure_host.fit_transform(frames[i], ref, masses)
        fitted = measure_host.apply_transform(frames[i], hr, ht)
        assert abs(rmsd[i] - measure_host.rmsd_mw(fitted, ref, masses)) < ATOL
        np.testing.assert_allclose(r[i], hr, atol=1e-4)
        np.testing.assert_allclose(t[i], ht, atol=1e-4)
    assert np.all(rmsd > 1e-4) and np.all(rmsd < 0.05)


def test_kabsch_and_transforms_match_jax(data):
    ref, masses, frames = data
    c1 = frames - frames.mean(axis=1, keepdims=True)
    c2 = np.broadcast_to(ref - ref.mean(axis=0), frames.shape).astype(np.float32)
    got = measure.kabsch(_t(c1), _t(c2), _t(masses)).numpy()
    want = np.asarray(jmeasure.kabsch(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(masses)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    r, t = measure.fit_transform(_t(frames), _t(np.broadcast_to(ref, frames.shape)), _t(masses))
    jr, jt = jmeasure.fit_transform(jnp.asarray(frames), jnp.asarray(np.broadcast_to(
        ref, frames.shape)), jnp.asarray(masses))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    moved = measure.apply_transform(_t(frames), r, t).numpy()
    jmoved = np.asarray(jmeasure.apply_transform(jnp.asarray(frames), jr, jt))
    np.testing.assert_allclose(moved, jmoved, atol=1e-4, rtol=0)


def test_reflection_gives_proper_rotation():
    # A mirrored structure must not be matched by an improper rotation.
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    m = np.ones(50, np.float32)
    mirrored = a * np.array([-1, 1, 1], np.float32)
    r = measure.kabsch(_t(a), _t(mirrored), _t(m)).numpy()
    assert np.linalg.det(r) > 0.99
    jr = np.asarray(jmeasure.kabsch(jnp.asarray(a), jnp.asarray(mirrored), jnp.asarray(m)))
    np.testing.assert_allclose(r, jr, atol=1e-5)


def test_fit_rmsd_headline_shape_small():
    # The headline's call: (B, n, 3) frames against one (n, 3) reference.
    ref, masses, frames = _rigid_frames(5, n=500, b=8, noise=0.02)
    got = measure.fit_rmsd(_t(frames), _t(ref), _t(masses))[0].numpy()
    want = np.asarray(jmeasure.fit_rmsd(
        jnp.asarray(frames), jnp.asarray(ref), jnp.asarray(masses))[0])
    assert got.shape == (8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
