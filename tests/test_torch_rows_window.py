"""Port vs JAX package: the per-pair min-image search over a window of
frames, and the plain twin of its stencil kernel over cell records.

``within_mask_rows_window`` on CPU tensors runs the plane twin frame by frame.
On a 4-frame window, each frame in its own box and one frame overflowing its
cells, its masks and overflow flags must equal, frame by frame, those of
``within_mask_pallas`` in interpret mode (the TPU kernel the route replaces)
and the numpy host search; on a window of every row scene they must equal
the ghost route's. The record twin (``_rows_bins_stencil``, what the kernel
wrapper runs on CPU tensors) must give the plane twin's masks on every row
scene's window, for a source subset and for a prefix of the sources too, and
a frame's mask must follow that frame's own box. The kernel resolves a pair's
image without a division; ``_image_abs`` emulates its rule, which must give
the plain form's value at and around every point where ``round(d / L)``
changes. The ``cuda``-marked tests of ``test_torch_kernels.py`` hold the
kernel against these twins on a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from molar_tpu.core.pbc import PBC_FULL, PeriodicBox
from molar_tpu.ops import neighbor_host
from molar_tpu.ops.neighbor_pallas import within_mask_pallas

from molar_tpu_torch.ops import neighbor
from molar_tpu_torch.ops import neighbor_ghost as ng
from molar_tpu_torch.ops import neighbor_rows as nr

from torch_scenes import ROW_SCENES, scene, window

N_FRAMES = 4


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def overflow_window():
    """random19's 4-frame window at cap = tgt_cap = 32, with frame 2's
    first 40 atoms packed into one cell (that frame overflows)."""
    coords, src, tgt, cutoff, boxes, invs, _, _, dims = window("random19", N_FRAMES)
    coords = coords.copy()
    rng = np.random.default_rng(5)
    coords[2, :40] = coords[2, 0] + rng.uniform(0, 0.05, (40, 3)).astype(np.float32)
    masks, ofl = nr.within_mask_rows_window(_t(coords), _t(src), _t(tgt), cutoff, _t(boxes),
                                            _t(invs), dims, 32, 32)
    return dict(coords=coords, tgt=tgt, cutoff=cutoff, boxes=boxes, invs=invs, dims=dims,
                masks=masks.numpy(), ofl=ofl.numpy())


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_window_matches_pallas_interpret_and_host_per_frame(overflow_window, f):
    w = overflow_window
    assert w["ofl"].tolist() == [False, False, True, False]
    n = w["coords"].shape[1]
    want, wofl = within_mask_pallas(
        jnp.asarray(w["coords"][f]), jnp.arange(n), jnp.asarray(w["tgt"]), w["cutoff"],
        jnp.asarray(w["boxes"][f]), jnp.asarray(w["invs"][f]), w["dims"], cap=32, tgt_cap=32,
        interpret=True)
    assert bool(wofl) == w["ofl"][f]
    if not w["ofl"][f]:
        np.testing.assert_array_equal(w["masks"][f], np.asarray(want))
        host = neighbor_host.search_within(w["cutoff"], w["coords"][f], np.arange(n), w["tgt"],
                                           PeriodicBox(w["boxes"][f]), PBC_FULL)
        np.testing.assert_array_equal(np.flatnonzero(w["masks"][f]), host)
        assert len(host)


def test_window_flags_equal_the_binning_twins(overflow_window):
    """The flags the kernels' route returns (the counting sort's) are the
    plane twin's."""
    w = overflow_window
    *_, ofl = ng.cell_bins(_t(w["coords"]), None, _t(w["tgt"]), _t(w["boxes"]), _t(w["invs"]),
                           w["dims"], 32, 32)
    np.testing.assert_array_equal(ofl.numpy(), w["ofl"])


def _scene_window(name):
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name, N_FRAMES)
    assert pbc == (True, True, True)
    return tuple(map(_t, (coords, src, tgt, boxes, invs))), cutoff, cap, dims


def _record_twin(c, s, tg, b, i, cutoff, cap, dims, n_src):
    src_rec, tgt_rec, counts, ofl = ng.cell_bins(c, s, tg, b, i, dims, cap, cap)
    assert not ofl.any()
    return nr.within_rows(src_rec, tgt_rec, counts, b, dims, cap, cap, neighbor._cutoff2(cutoff),
                          n_src)


@pytest.mark.parametrize("name", ROW_SCENES)
def test_window_matches_ghost_route(name):
    (c, s, tg, b, i), cutoff, cap, dims = _scene_window(name)
    got, ofl = nr.within_mask_rows_window(c, s, tg, cutoff, b, i, dims, cap, cap)
    want, wofl = neighbor.within_mask_window(c, s, tg, cutoff, b, i, dims, cap, cap)
    assert not ofl.any() and not wofl.any()
    assert got.shape == want.shape and want.any() and torch.equal(got, want)
    one, _ = nr.within_mask_rows(c[1], s, tg, cutoff, b[1], i[1], dims, cap, cap)
    assert torch.equal(one, got[1])


@pytest.mark.parametrize("name", ROW_SCENES)
def test_record_twin_matches_plane_twin(name):
    """The stencil over cell records (all 27 offsets, aliased ones too,
    slots bounded by counts) against the x-minor plane stencil (rolls,
    validity and penalty planes) and its unsort."""
    (c, s, tg, b, i), cutoff, cap, dims = _scene_window(name)
    want, _ = nr.within_mask_rows_window(c, s, tg, cutoff, b, i, dims, cap, cap)
    got = _record_twin(c, s, tg, b, i, cutoff, cap, dims, want.shape[1])
    assert got.dtype == torch.bool and want.any() and torch.equal(got, want)


def test_record_twin_src_subset_and_prefix():
    (c, _, tg, b, i), cutoff, cap, dims = _scene_window("small_grid_2x4x4")
    sub = torch.tensor([199, 3, 50, 7, 120, 64, 0])
    full, _ = nr.within_mask_rows_window(c, None, tg, cutoff, b, i, dims, cap, cap)
    want, _ = nr.within_mask_rows_window(c, sub, tg, cutoff, b, i, dims, cap, cap)
    got = _record_twin(c, sub, tg, b, i, cutoff, cap, dims, len(sub))
    assert want.any() and torch.equal(got, want) and torch.equal(got, full[:, sub])
    # Records of every atom, a mask of the first half: later positions write nothing.
    n = c.shape[1]
    part = _record_twin(c, None, tg, b, i, cutoff, cap, dims, n // 2)
    assert part.shape == (N_FRAMES, n // 2) and torch.equal(part, full[:, : n // 2])


def test_each_frame_is_searched_in_its_own_box():
    """One set of coordinates in three boxes of one window: every frame's
    mask is the host search's in that frame's box, and the boxes matter."""
    coords, _, tgt, cutoff, sides, _, cap = scene("pallas3_0.8")
    sides = np.asarray(sides, np.float32) * np.array([[1.0], [1.25], [0.9]], np.float32)
    boxes = np.stack([np.diag(s) for s in sides]).astype(np.float32)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    dims = neighbor.grid_dims(sides.min(axis=0), cutoff)
    c = _t(np.broadcast_to(coords, (3, *coords.shape)))
    got, ofl = nr.within_mask_rows_window(c, None, _t(tgt), cutoff, _t(boxes), _t(invs), dims,
                                          2 * cap, 2 * cap)
    rec = _record_twin(c, None, _t(tgt), _t(boxes), _t(invs), cutoff, 2 * cap, dims,
                       coords.shape[0])
    assert not ofl.any() and torch.equal(rec, got)
    for f in range(3):
        host = neighbor_host.search_within(cutoff, coords, np.arange(len(coords)), tgt,
                                           PeriodicBox(boxes[f]), PBC_FULL)
        np.testing.assert_array_equal(np.flatnonzero(got[f].numpy()), host)
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[0], got[2])


# ---------------------------------------------------------------- the image rule


def _probe(length: np.float32):
    """d at 0, +-L/2 and +-L and 1-4 ulps to either side of each."""
    length = np.float32(length)
    out = []
    for centre in (np.float32(0), length / np.float32(2), -length / np.float32(2), length,
                   -length):
        for towards in (np.float32(np.inf), np.float32(-np.inf)):
            d = centre
            out.append(d)
            for _ in range(4):
                d = np.nextafter(d, towards, dtype=np.float32)
                out.append(d)
    return torch.from_numpy(np.array(out, np.float32))


def _assert_image_rule(length):
    d, lt = _probe(length), torch.tensor(np.float32(length))
    n = torch.round(d / lt)
    plain = d - lt * n
    got = nr._image_abs(d, lt)
    # The kernel uses the square only.
    assert torch.equal((got * got).view(torch.int32), (plain * plain).view(torch.int32))
    inside = d.abs() <= lt
    assert torch.equal(got[inside].view(torch.int32), plain[inside].abs().view(torch.int32))
    # The integer the rule stands for: which of |d| and L - |d| is the smaller.
    implied = torch.sign(d) * (lt - d.abs() < d.abs())
    assert torch.equal(implied, n)
    assert set(n.tolist()) == {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("name", ROW_SCENES)
def test_image_rule_at_the_scene_box_lengths(name):
    *_, boxes, _, _, _, _ = window(name, N_FRAMES)
    for length in np.unique(np.diagonal(boxes, axis1=1, axis2=2)):
        _assert_image_rule(length)


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=2.0**-10, max_value=2.0**14, width=32))
def test_image_rule_for_any_box_length(length):
    _assert_image_rule(length)
