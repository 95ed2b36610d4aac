"""The grid contact list over a window, above the dense limit.

``workloads.Contacts`` takes the cell grid (``contact_pairs_window``)
whenever ``n_src * n_tgt > DENSE_LIMIT``. The window form takes every frame
of a run at once; the frame loop over ``contact_pairs`` stays as its plain
version. On an orthorhombic and a triclinic scene of 2,100 sources and
1,000 targets (2.1 M candidates, above ``DENSE_LIMIT``), each frame in its
own box, the window form equals the frame loop exactly (pairs in the same
order, distances, counts and overflow flags; also with the window cut into
runs of frames, and with a capacity that overflows), and each frame's pair
set and count equal the JAX package's ``contact_pairs`` on JAX-CPU
(distances within 1e-6 nm).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.ops import neighbor as jnb

from molar_tpu_torch import workloads as wl
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops import neighbor

N_SRC, N_TGT, N_FRAMES, CUTOFF, MAX_PAIRS = 2100, 1000, 3, 0.4, 1 << 14
DIST_ATOL = 1e-6
BOXES = {
    "orthorhombic": np.diag([4.4, 4.0, 4.8]).astype(np.float32),
    "triclinic": np.array([[4.4, 0.0, 2.2], [0.0, 4.4, 2.2], [0.0, 0.0, 3.111]], np.float32),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops; one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(kind, seed=0):
    """A window of N_FRAMES frames, each in its own (slightly scaled) box
    -> (coords, src, tgt, boxes, invs, corrections or None, dims)."""
    m = BOXES[kind]
    rng = np.random.default_rng(seed)
    n = N_SRC + N_TGT + 200
    frac = rng.uniform(-0.2, 1.2, (N_FRAMES, n, 3))
    scale = (1.0 + 0.01 * np.arange(N_FRAMES, dtype=np.float32))[:, None, None]
    boxes = (m[None] * scale).astype(np.float32)
    coords = np.einsum("fij,fnj->fni", boxes.astype(np.float64), frac).astype(np.float32)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    box = PeriodicBox(m)
    corr = None
    if box.is_triclinic:
        corr = np.stack([PeriodicBox(b).padded_corrections() for b in boxes])
    src = np.arange(N_SRC)
    tgt = np.arange(N_SRC + 100, N_SRC + 100 + N_TGT)
    return coords, src, tgt, boxes, invs, corr, neighbor.grid_dims_for(box, CUTOFF)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _listed(pairs, dist):
    pairs, dist = np.asarray(pairs), np.asarray(dist)
    n = int((pairs[:, 0] >= 0).sum())
    order = np.lexsort((pairs[:n, 1], pairs[:n, 0]))
    return pairs[:n][order], dist[:n][order]


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_window_equals_the_frame_loop_and_jax(kind, monkeypatch):
    coords, src, tgt, boxes, invs, corr, dims = _scene(kind)
    assert len(src) * len(tgt) > wl.DENSE_LIMIT
    args = (_t(coords), _t(src), _t(tgt), CUTOFF, _t(boxes), _t(invs), _t(corr), dims, 16,
            MAX_PAIRS)
    got = neighbor.contact_pairs_window(*args)
    want = neighbor.contact_pairs_window(*args, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not got[3].any() and (got[2] > 1000).all()
    # cut into runs of one and of two frames
    for frames in (1, 2):
        monkeypatch.setattr(neighbor, "_BLOCK_ELEMS", frames * N_SRC * 27 * 16 * (
            1 if corr is None else corr.shape[1]))
        assert all(torch.equal(a, b) for a, b in zip(neighbor.contact_pairs_window(*args), want))
    monkeypatch.undo()
    for f in range(N_FRAMES):
        jp, jd, jc, jo = jnb.contact_pairs(
            jnp.asarray(coords[f]), jnp.asarray(src), jnp.asarray(tgt), CUTOFF,
            jnp.asarray(boxes[f]), jnp.asarray(invs[f]),
            None if corr is None else jnp.asarray(corr[f]), dims=dims, cap=16,
            max_pairs=MAX_PAIRS)
        gp, gd = _listed(got[0][f].numpy(), got[1][f].numpy())
        wp, wd = _listed(np.asarray(jp), np.asarray(jd))
        assert not bool(jo) and int(jc) == int(got[2][f]) == len(gp)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gd, wd, atol=DIST_ATOL, rtol=0)


@pytest.mark.parametrize("cap,max_pairs", [(2, MAX_PAIRS), (16, 512)])
def test_overflow_flags_equal_the_frame_loop(cap, max_pairs):
    coords, src, tgt, boxes, invs, corr, dims = _scene("orthorhombic", seed=1)
    args = (_t(coords), _t(src), _t(tgt), CUTOFF, _t(boxes), _t(invs), None, dims, cap,
            max_pairs)
    got = neighbor.contact_pairs_window(*args)
    want = neighbor.contact_pairs_window(*args, plain=True)
    assert got[3].all() and torch.equal(got[3], want[3])
    if cap == 16:  # the table holds: only the list is clipped, the counts are whole
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (got[2] > max_pairs).all()


def test_contacts_module_takes_the_grid_above_the_dense_limit():
    coords, src, tgt, boxes, invs, _, dims = _scene("orthorhombic", seed=2)
    model = wl.Contacts(_t(src), _t(tgt), dims, CUTOFF, MAX_PAIRS, 16)
    assert not model.dense
    count, overflow = model(_t(coords), _t(boxes), _t(invs))
    want = neighbor.contact_pairs_window(_t(coords), _t(src), _t(tgt), CUTOFF, _t(boxes),
                                         _t(invs), dims=dims, cap=16, max_pairs=MAX_PAIRS,
                                         plain=True)
    assert torch.equal(count, want[2]) and torch.equal(overflow, want[3])
