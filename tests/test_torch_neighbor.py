"""Port vs JAX package: the periodic ``within`` search and its cell planes.

On the CPU the port's ``within_mask`` runs the plain ghost-slab twin of the
CUDA kernel. Its mask must equal, exactly, the JAX package's sparse-target
and ghost XLA paths, the ghost-slab Pallas kernel in interpret mode and the
numpy host search, on random scenes, cutoff ties, tiny and collapsed
periodic grids and partial PBC; and its overflow flag must rise in the
same scenes as the JAX ghost path's (the mask is not compared then). The
scenes (``torch_scenes.py``) are shared with ``test_torch_kernels.py``,
where the ``cuda``-marked tests hold the kernel itself against the twin on
a card, and with ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.core.pbc import PbcDims, PeriodicBox
from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import neighbor_host
from molar_tpu.ops.neighbor_pallas import within_ghost_pallas

from molar_tpu_torch.ops import neighbor, neighbor_ghost

from torch_scenes import SCENES, TIE_MEMBERS, scene


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _port(coords, src, tgt, cutoff, box, pbc, cap, tgt_cap=None, device="cpu"):
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    dev = lambda a: None if a is None else _t(a).to(device)  # noqa: E731
    mask, ofl = neighbor.within_mask(
        dev(coords), dev(src), dev(tgt), cutoff, dev(box.matrix), dev(box.inv),
        dims=dims, cap=cap, tgt_cap=tgt_cap, pbc=pbc)
    return mask.cpu().numpy(), bool(ofl)


def _jax(coords, src, tgt, cutoff, box, pbc, cap, tgt_cap=None, **kw):
    dims = jnb.grid_dims(box.box_extents(), cutoff)
    src = np.arange(len(coords)) if src is None else src
    mask, ofl = jnb.within_mask(
        jnp.asarray(coords), jnp.asarray(src), jnp.asarray(tgt), cutoff=cutoff,
        box=jnp.asarray(box.matrix), inv=jnp.asarray(box.inv), dims=dims, cap=cap,
        tgt_cap=tgt_cap, pbc=pbc, **kw)
    return np.asarray(mask), bool(ofl)


def _pallas(coords, src, tgt, cutoff, box, pbc, cap, tgt_cap):
    dims = jnb.grid_dims(box.box_extents(), cutoff)
    src = np.arange(len(coords)) if src is None else src
    mask, ofl = within_ghost_pallas(
        jnp.asarray(coords), jnp.asarray(src), jnp.asarray(tgt), cutoff,
        jnp.asarray(box.matrix), jnp.asarray(box.inv), dims, cap=cap,
        tgt_cap=tgt_cap, pbc=pbc, interpret=True)
    return np.asarray(mask), bool(ofl)


@pytest.mark.parametrize("name", SCENES)
def test_within_matches_jax_paths_and_host(name):
    coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    got, ofl = _port(coords, src, tgt, cutoff, box, pbc, cap)
    assert not ofl
    src_ids = np.arange(len(coords)) if src is None else src
    want = neighbor_host.search_within(cutoff, coords, src_ids, tgt, box, PbcDims(*pbc))
    np.testing.assert_array_equal(src_ids[got], want)
    ghost, gofl = _jax(coords, src, tgt, cutoff, box, pbc, cap, ghost=True)
    sparse, sofl = _jax(coords, src, tgt, cutoff, box, pbc, cap, max_tgt_cells=512)
    assert not gofl and not sofl
    np.testing.assert_array_equal(got, ghost)
    np.testing.assert_array_equal(got, sparse)
    if name in TIE_MEMBERS:
        assert src_ids[got].tolist() == TIE_MEMBERS[name]


@pytest.mark.parametrize("name", ["random7", "partial_pbc_TFT", "tiny_grid_1.7_0.4",
                                  "tie_across_boundary"])
def test_within_matches_ghost_pallas_interpret(name):
    coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    got, ofl = _port(coords, src, tgt, cutoff, box, pbc, cap, tgt_cap=32)
    want, wofl = _pallas(coords, src, tgt, cutoff, box, pbc, cap, 32)
    assert not ofl and not wofl
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap,tgt_cap,expect", [(2, 64, True), (64, 1, True), (64, 64, False)])
def test_overflow_flag_matches_jax(cap, tgt_cap, expect):
    rng = np.random.default_rng(3)
    box = PeriodicBox(np.diag([5.0, 5.0, 5.0]).astype(np.float32))
    coords = rng.uniform(0, 5, (2000, 3)).astype(np.float32)
    tgt = np.arange(0, 2000, 7)
    full = (True, True, True)
    got, ofl = _port(coords, None, tgt, 0.5, box, full, cap, tgt_cap)
    jmask, jofl = _jax(coords, None, tgt, 0.5, box, full, cap, tgt_cap, ghost=True)
    assert ofl == jofl == expect
    if not expect:
        np.testing.assert_array_equal(got, jmask)


def test_src_subset_equals_full_then_sliced():
    coords, _, tgt, cutoff, sides, pbc, _ = scene("random19")
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    sub = np.array([899, 5, 300, 17, 640, 2])
    full, _ = _port(coords, None, tgt, cutoff, box, pbc, 64)
    part, _ = _port(coords, sub, tgt, cutoff, box, pbc, 64)
    np.testing.assert_array_equal(part, full[sub])


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    box = PeriodicBox(np.diag([5.0, 5.5, 6.0]).astype(np.float32))
    coords = rng.uniform(-1, 7, (2000, 3)).astype(np.float32)
    tgt = np.arange(0, 2000, 7)
    for cutoff in (0.5, 0.9, 2.8, 7.0):
        assert neighbor.grid_dims(box.box_extents(), cutoff) == jnb.grid_dims(
            box.box_extents(), cutoff)
    dims = neighbor.grid_dims(box.box_extents(), 0.5)
    for kw in (dict(), dict(margin=1.0, round_to=1), dict(margin=1.5, round_to=4)):
        assert neighbor.estimate_caps(coords, box.inv, dims, tgt, **kw) == jnb.estimate_caps(
            coords, box.inv, dims, tgt, **kw)
    assert neighbor.estimate_caps(coords, box.inv, dims) == jnb.estimate_caps(
        coords, box.inv, dims)


def test_rank_and_planes_match_jax_bitwise():
    rng = np.random.default_rng(8)
    dims = (4, 3, 5)
    n_cells = 60
    flat = rng.integers(0, n_cells, 700).astype(np.int32)
    vals = [rng.uniform(0, 4, 700).astype(np.float32) for _ in range(3)]
    srt = np.sort(flat)
    np.testing.assert_array_equal(
        neighbor._rank_in_run(_t(srt).long()).numpy(), np.asarray(jnb._rank_in_run(jnp.asarray(srt))))
    planes, slot, order, ofl = neighbor._blocked_planes(
        [_t(v) for v in vals], _t(flat), n_cells, 24, [-1e17] * 3)
    jplanes, jslot, jorder, jofl = jnb._blocked_planes(
        [jnp.asarray(v) for v in vals], jnp.asarray(flat), n_cells, 24,
        [jnp.float32(-1e17)] * 3)
    for p, jp in zip(planes, jplanes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert bool(ofl) == bool(jofl) is False
    # Ghost planes: faces filled x -> y -> z so edges and corners compose.
    box = np.diag([4.0, 3.0, 5.0]).astype(np.float32)
    cx, cy, cz = (rng.integers(0, d, 700) for d in dims)
    fpad = (((cx + 1) * (dims[1] + 2) + (cy + 1)) * (dims[2] + 2) + (cz + 1)).astype(np.int32)
    for pbc in ((True, True, True), (True, False, True)):
        ghost, gofl = neighbor._ghost_planes(
            [_t(v) for v in vals], _t(fpad), dims, 24, _t(box), pbc, 1e17)
        jghost, jgofl = jnb._ghost_planes(
            [jnp.asarray(v) for v in vals], jnp.asarray(fpad), dims, 24, jnp.asarray(box), pbc,
            jnp.float32(1e17))
        assert bool(gofl) == bool(jgofl)
        for g, jg in zip(ghost, jghost):
            np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_triclinic_takes_the_correction_path():
    """A skewed box with its corrections takes the correction path, not
    the ghost kernels, and gives the host search's set."""
    from molar_tpu_torch.core.pbc import PeriodicBox as TorchBox

    jbox = PeriodicBox.from_vectors_angles(3.0, 3.2, 3.4, 75.0, 80.0, 70.0)
    box = TorchBox(jbox.matrix)
    coords = np.random.default_rng(6).uniform(0, 3, (200, 3)).astype(np.float32)
    tgt = np.arange(0, 200, 9)
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    mask, ofl = neighbor.within_mask(
        _t(coords), None, _t(tgt), 0.5, _t(box.matrix), _t(box.inv),
        corrections=_t(box.padded_corrections()), dims=neighbor.grid_dims_for(box, 0.5), cap=32)
    assert not bool(ofl)
    assert (neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches) == before
    want = neighbor_host.search_within(0.5, coords, np.arange(200), tgt, jbox, PbcDims())
    np.testing.assert_array_equal(np.flatnonzero(mask.numpy()), want)


def test_mat3_apply_matches_jax():
    from molar_tpu.core.pbc import mat3_apply as jax_mat3_apply

    from molar_tpu_torch.core.pbc import mat3_apply

    rng = np.random.default_rng(2)
    m = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    v = rng.uniform(-5, 5, (7, 11, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        mat3_apply(_t(m), _t(v)).numpy(), np.asarray(jax_mat3_apply(jnp.asarray(m), jnp.asarray(v))))


@pytest.mark.parametrize("sides", [(10.0, 10.0, 10.0), (4.0, 5.0, 6.0), (0.7, 2.0, 2.0)])
def test_periodic_box_matches_reference(sides):
    from molar_tpu_torch.core.pbc import PeriodicBox as TorchBox

    m = np.diag(sides).astype(np.float32)
    got, want = TorchBox(m), PeriodicBox(m)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.inv, want.inv)
    np.testing.assert_array_equal(got.box_extents(), want.box_extents())
    assert got.is_triclinic is False
    assert neighbor.grid_dims(got.box_extents(), 0.5) == jnb.grid_dims(want.box_extents(), 0.5)
    skew = m.copy()
    skew[0, 1] = 0.25
    assert TorchBox(skew).is_triclinic is True
