"""Port vs JAX package: the target cell table and the contact lists.

``cell_table``, ``contact_pairs_dense`` (the direct distance matrix),
``contact_pairs`` (the cell grid, in its lattice-shift form and its
min-image form) and their window forms, on CPU tensors, against
``molar_tpu.ops.neighbor`` on JAX-CPU and the numpy host search
``neighbor_host.search_pairs``. The contract: sorted pair sets equal, counts
equal (and not clipped to the capacity), distances within 1e-5 of the
host's, the overflow flag raised in the same cases; an inclusive cutoff, so
the tie scenes keep their members. Scenes: the JAX package's own
(``tests/test_neighbor_device.py``) and those of ``tests/torch_scenes.py``
(cutoff ties, periodic grids of 1 and 2 cells an axis, partial PBC).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.core.pbc import PbcDims, PeriodicBox
from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import neighbor_host

from molar_tpu_torch.core.pbc import PeriodicBox as PortBox
from molar_tpu_torch.ops import neighbor

from torch_scenes import SCENES, TIE_MEMBERS, scene, window

FULL = (True, True, True)
DIST_ATOL = 1e-5
TRICLINIC = dict(vectors=(4.0, 5.0, 6.0), angles=(80.0, 85.0, 75.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain twins run many small torch ops; on a pool of threads they
    crawl when the test workers share the cores. One thread for this
    module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _device_scene():
    """The scene of ``tests/test_neighbor_device.py``."""
    rng = np.random.default_rng(17)
    box = PeriodicBox(np.diag([4.0, 5.0, 6.0]).astype(np.float32))
    coords = rng.uniform(-2, 8, (600, 3)).astype(np.float32)
    tgt = np.sort(rng.choice(600, 60, replace=False))
    return box, coords, np.arange(600), tgt


def _triclinic_scene(seed, n, every):
    box = PeriodicBox.from_vectors_angles(*TRICLINIC["vectors"], *TRICLINIC["angles"])
    coords = np.random.default_rng(seed).uniform(-2, 8, (n, 3)).astype(np.float32)
    return box, coords, np.arange(n), np.arange(0, n, every)


def _listed(pairs, dist):
    """A padded pair list as numpy -> (pairs sorted by (source, target),
    their distances); asserts the padding is -1 / 0 and follows the pairs."""
    pairs, dist = np.asarray(pairs), np.asarray(dist)
    live = pairs[:, 0] >= 0
    n = int(live.sum())
    assert live[:n].all() and (pairs[n:] == -1).all() and (dist[n:] == 0).all()
    order = np.lexsort((pairs[:n, 1], pairs[:n, 0]))
    return pairs[:n][order], dist[:n][order]


def _port(form, coords, src, tgt, cutoff, box, pbc=FULL, corrections=None, cap=64,
          max_pairs=1 << 14, dims=None):
    kw = dict(corrections=_t(corrections), max_pairs=max_pairs, pbc=pbc)
    if form == "grid":
        kw.update(dims=dims or neighbor.grid_dims(box.box_extents(), cutoff), cap=cap)
    fn = neighbor.contact_pairs if form == "grid" else neighbor.contact_pairs_dense
    pairs, dist, count, ofl = fn(_t(coords), _t(src), _t(tgt), cutoff, _t(box.matrix),
                                 _t(box.inv), **kw)
    assert pairs.dtype == torch.int32 and pairs.shape == (max_pairs, 2)
    assert dist.dtype == torch.float32 and dist.shape == (max_pairs,)
    return pairs.numpy(), dist.numpy(), int(count), bool(ofl)


def _jax(form, coords, src, tgt, cutoff, box, pbc=FULL, corrections=None, cap=64,
         max_pairs=1 << 14, dims=None):
    kw = dict(cutoff=cutoff, box=jnp.asarray(box.matrix), inv=jnp.asarray(box.inv),
              corrections=None if corrections is None else jnp.asarray(corrections),
              max_pairs=max_pairs, pbc=pbc)
    if form == "grid":
        kw.update(dims=dims or jnb.grid_dims(box.box_extents(), cutoff), cap=cap)
    fn = jnb.contact_pairs if form == "grid" else jnb.contact_pairs_dense
    pairs, dist, count, ofl = fn(jnp.asarray(coords), jnp.asarray(src), jnp.asarray(tgt), **kw)
    return np.asarray(pairs), np.asarray(dist), int(count), bool(ofl)


def _assert_matches(form, coords, src, tgt, cutoff, box, pbc=FULL, corrections=None, cap=64,
                    dims=None, jax=True, max_pairs=1 << 14):
    """The port's list against the host search (sets, count, distances) and
    the JAX function's (sets, count, distances to an ulp)."""
    args = (form, coords, src, tgt, cutoff, box, pbc, corrections, cap, max_pairs, dims)
    pairs, dist, count, ofl = _port(*args)
    assert not ofl
    got, gdist = _listed(pairs, dist)
    hpairs, hdist = neighbor_host.search_pairs(cutoff, coords, src, tgt, box, PbcDims(*pbc))
    order = np.lexsort((hpairs[:, 1], hpairs[:, 0]))
    np.testing.assert_array_equal(got, hpairs[order])
    assert count == len(hpairs) == len(got)
    np.testing.assert_allclose(gdist, hdist[order], atol=DIST_ATOL, rtol=0)
    if jax:
        jpairs, jdist, jcount, jofl = _jax(*args)
        want, wdist = _listed(jpairs, jdist)
        assert not jofl and jcount == count
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(gdist, wdist, atol=1e-6, rtol=0)
    return got


# ------------------------------------------------------------- cell_table


def test_tf32_is_off_in_these_comparisons():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("dims,cap", [((8, 10, 12), 8), ((3, 3, 3), 64), ((1, 2, 5), 600),
                                      ((8, 10, 12), 1)])
def test_cell_table_members_equal_as_sets(dims, cap):
    box, coords, _, _ = _device_scene()
    frac = jnb._wrap_frac(jnp.asarray(coords), jnp.asarray(box.inv))
    want, wofl = jnb.cell_table(*frac, dims, cap)
    got, gofl = neighbor.cell_table(*(_t(np.array(f)) for f in frac), dims, cap)
    assert got.dtype == torch.int32 and got.shape == (dims[0] * dims[1] * dims[2], cap)
    assert bool(gofl) == bool(wofl) == (cap == 1)
    if cap == 1:
        return  # the table is undefined under overflow
    got, want = np.sort(got.numpy(), axis=1), np.sort(np.asarray(want), axis=1)
    np.testing.assert_array_equal(got, want)
    members = got[got >= 0]
    np.testing.assert_array_equal(np.sort(members), np.arange(len(coords)))


def test_cell_table_fills_slots_in_index_order():
    box, coords, _, _ = _device_scene()
    frac = neighbor._wrap_frac(_t(coords), _t(box.inv))
    table = neighbor.cell_table(*frac, (4, 5, 6), 32)[0].numpy()
    live = table >= 0
    assert (live[:, :-1] >= live[:, 1:]).all()  # members first, then padding
    assert (np.diff(np.where(live, table, 10**6), axis=1) > 0)[live[:, 1:]].all()


# ------------------------------------------------- the reference's scenes


@pytest.mark.parametrize("cutoff", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("form", ["dense", "grid"])
def test_contact_pairs_match_host_and_jax(form, cutoff):
    box, coords, src, tgt = _device_scene()
    _assert_matches(form, coords, src, tgt, cutoff, box)


@pytest.mark.parametrize("form", ["dense", "grid"])
def test_contact_pairs_triclinic(form):
    box, coords, src, tgt = _triclinic_scene(5, 300, 5)
    dims = neighbor.grid_dims_for(PortBox(box.matrix), 0.6) if form == "grid" else None
    got = _assert_matches(form, coords, src, tgt, 0.6, box, corrections=box.padded_corrections(),
                          dims=dims, jax=form == "dense")
    assert len(got) > 50
    if form == "grid":
        # The JAX function on the same height-sized grid (its own length
        # rule is the one that misses pairs in skewed boxes).
        jpairs, jdist, jcount, _ = _jax(form, coords, src, tgt, 0.6, box, FULL,
                                        box.padded_corrections(), 64, 1 << 14, dims)
        np.testing.assert_array_equal(got, _listed(jpairs, jdist)[0])


@pytest.mark.parametrize("form", ["dense", "grid"])
def test_contact_pairs_partial_pbc(form):
    box, coords, src, tgt = _device_scene()
    inside = (coords[:, 1] >= 0) & (coords[:, 1] < box.matrix[1, 1])
    got = _assert_matches(form, coords, src[inside[src]], tgt[inside[tgt]], 0.5, box,
                          pbc=(True, False, True))
    assert len(got) > 20


@pytest.mark.parametrize("form", ["dense", "grid"])
def test_overflow_flag_and_unclipped_count(form):
    box, coords, src, tgt = _device_scene()
    full = _port(form, coords, src, tgt, 0.9, box)
    pairs, dist, count, ofl = _port(form, coords, src, tgt, 0.9, box, max_pairs=8)
    assert ofl and count == full[2] > 8
    got, _ = _listed(pairs, dist)
    assert len(got) == 8
    assert {tuple(p) for p in got.tolist()} <= {tuple(p) for p in _listed(*full[:2])[0].tolist()}
    jcount, jofl = _jax(form, coords, src, tgt, 0.9, box, max_pairs=8)[2:]
    assert jofl and jcount == count


def test_grid_overflow_flag_of_the_cell_table():
    box, coords, src, tgt = _device_scene()
    assert _port("grid", coords, src, tgt, 0.5, box, cap=1)[3]
    assert _jax("grid", coords, src, tgt, 0.5, box, cap=1)[3]


# ------------------------------------- ties, tiny grids, both step forms


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("form", ["dense", "grid"])
def test_scenes_match_host_and_jax(form, name):
    # Grids of 1 and 2 cells an axis (tiny_periodic_0.9_b, dim1_*) take the
    # min-image step with deduplicated neighbour ids; the others the
    # lattice-shift step. The solvated protein (5,000 x 500 atoms, some
    # 30,000 pairs) is held against the host only.
    coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    src = np.arange(len(coords)) if src is None else src
    got = _assert_matches(form, coords, src, tgt, cutoff, box, pbc=pbc, cap=cap,
                          jax=name != "solvated_protein", max_pairs=1 << 16)
    if name in TIE_MEMBERS:
        assert sorted(set(got[:, 0].tolist())) == TIE_MEMBERS[name]
    else:
        assert len(got) > 0


def test_shift_step_and_min_image_step_agree():
    # Zero correction candidates change no distance but select the
    # min-image step on a grid the lattice-shift step would take.
    box, coords, src, tgt = _device_scene()
    dims = neighbor.grid_dims(box.box_extents(), 0.5)
    assert min(dims) >= 3
    shift = _port("grid", coords, src, tgt, 0.5, box)
    image = _port("grid", coords, src, tgt, 0.5, box, corrections=np.zeros((26, 3), np.float32))
    np.testing.assert_array_equal(_listed(*shift[:2])[0], _listed(*image[:2])[0])
    np.testing.assert_allclose(_listed(*shift[:2])[1], _listed(*image[:2])[1], atol=1e-6)


@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 3), (2, 2, 2), (3, 4, 5)])
def test_dedupe_small_grid(dims):
    ids = np.arange(dims[0] * dims[1] * dims[2])
    cells = [_t(c)[:, None] for c in np.unravel_index(ids, dims)]
    o = torch.arange(27)[None, :]
    nb, ok = neighbor._neighbor_cells(*cells, (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1), dims,
                                      FULL)
    assert ok.all()
    got = neighbor._dedupe_small_grid(nb).numpy()
    want = np.asarray(jnb._dedupe_small_grid(jnp.asarray(nb.numpy())))
    np.testing.assert_array_equal(got, want)
    for row, raw in zip(got, nb.numpy()):
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == len(kept) and set(kept.tolist()) == set(raw.tolist())


# ------------------------------------------------------------- compaction


@pytest.mark.parametrize("size", [1, 7, 64, 500])
def test_compact_equals_nonzero_row_by_row(size):
    rng = np.random.default_rng(size)
    hit = _t(rng.uniform(size=(5, 400)) < np.array([0.0, 0.02, 0.2, 0.9, 1.0])[:, None])
    got = neighbor._compact(hit, size)
    assert got.shape == (5, size) and got.dtype == torch.int64
    for row, h in zip(got, hit):
        want = torch.nonzero_static(h, size=size, fill_value=-1)[:, 0]
        assert torch.equal(row, want)


# ----------------------------------------------------------- window forms


@pytest.mark.parametrize("name", ["random7", "tie_across_boundary", "tiny_periodic_0.9_b",
                                  "partial_pbc_TFT"])
@pytest.mark.parametrize("form", ["dense", "grid"])
def test_window_form_equals_frame_form(form, name, monkeypatch):
    # Each frame in its own box; the dense form also in runs of two frames.
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name)
    src = np.arange(coords.shape[1]) if src is None else src
    c, s, t, bm, bi = (_t(a) for a in (coords, src, tgt, boxes, invs))
    if form == "dense":
        def frame(f):
            return neighbor.contact_pairs_dense(c[f], s, t, cutoff, bm[f], bi[f], max_pairs=4096,
                                                pbc=pbc)

        def whole():
            return neighbor.contact_pairs_dense_window(c, s, t, cutoff, bm, bi, max_pairs=4096,
                                                       pbc=pbc)
    else:
        kw = dict(dims=dims, cap=cap, max_pairs=4096, pbc=pbc)

        def frame(f):
            return neighbor.contact_pairs(c[f], s, t, cutoff, bm[f], bi[f], **kw)

        def whole():
            return neighbor.contact_pairs_window(c, s, t, cutoff, bm, bi, **kw)

    want = [torch.stack(x) for x in zip(*(frame(f) for f in range(coords.shape[0])))]
    got = whole()
    assert got[0].shape == (coords.shape[0], 4096, 2) and got[2].shape == (coords.shape[0],)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not got[3].any() and got[2].sum() > 0
    if form == "dense":
        monkeypatch.setattr(neighbor, "_BLOCK_ELEMS", 2 * len(src) * len(tgt))
        assert all(torch.equal(a, b) for a, b in zip(whole(), want))
    # and every frame against the host search in its own box
    for f in range(coords.shape[0]):
        hp, _ = neighbor_host.search_pairs(cutoff, coords[f], src, tgt,
                                           PeriodicBox(boxes[f]), PbcDims(*pbc))
        listed = _listed(got[0][f].numpy(), got[1][f].numpy())[0]
        np.testing.assert_array_equal(listed, hp[np.lexsort((hp[:, 1], hp[:, 0]))])


def test_window_form_with_per_frame_corrections():
    box, coords, src, tgt = _triclinic_scene(3, 200, 4)
    rng = np.random.default_rng(0)
    frames = np.stack([coords, coords + rng.normal(0, 0.05, coords.shape).astype(np.float32)])
    scale = np.array([1.0, 1.02], np.float32)[:, None, None]
    boxes = box.matrix[None] * scale
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    corr = box.padded_corrections()[None] * scale
    c, s, t, bm, bi, k = (_t(a) for a in (frames, src, tgt, boxes, invs, corr))
    dims = neighbor.grid_dims_for(PortBox(box.matrix), 0.6)
    for whole, one in (
        (neighbor.contact_pairs_dense_window(c, s, t, 0.6, bm, bi, k, 4096),
         lambda f: neighbor.contact_pairs_dense(c[f], s, t, 0.6, bm[f], bi[f], k[f], 4096)),
        (neighbor.contact_pairs_window(c, s, t, 0.6, bm, bi, k, dims, 64, 4096),
         lambda f: neighbor.contact_pairs(c[f], s, t, 0.6, bm[f], bi[f], k[f], dims, 64, 4096)),
    ):
        for f in range(2):
            assert all(torch.equal(a[f], b) for a, b in zip(whole, one(f)))
            hp, _ = neighbor_host.search_pairs(0.6, frames[f], src, tgt, PeriodicBox(boxes[f]),
                                               PbcDims(*FULL))
            listed = _listed(whole[0][f].numpy(), whole[1][f].numpy())[0]
            np.testing.assert_array_equal(listed, hp[np.lexsort((hp[:, 1], hp[:, 0]))])
