"""Port vs JAX package: the ghost-slab search over a window of frames, and
the plain twins of its two CUDA kernels.

``within_mask_window`` on CPU tensors runs the plain twin frame by frame. On
a 4-frame window, each frame in its own box and one frame overflowing its
cells, its masks and overflow flags must equal those of the JAX package's
per-frame ``within_mask`` (ghost and sparse-target XLA paths) and of
``within_ghost_pallas`` in interpret mode. The plain twins of the two
kernels — the counting sort (``_cell_bins_plain``) and the stencil over its
records, which computes each neighbour cell's periodic image on the way
(``_bins_stencil`` with ``_image_cells`` + ``_image_shift``) — must give the
plane build's per-cell members, the ghost planes' border values bit for
bit, and the window twin's masks, on every shared scene. The
``cuda``-marked tests of ``test_torch_kernels.py`` hold the kernels against
these twins on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops.neighbor_pallas import within_ghost_pallas

from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops import neighbor
from molar_tpu_torch.ops import neighbor_ghost as ng

from torch_scenes import GHOST_SCENES, blocked_members, cell_members, scene, window


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def overflow_window():
    """random19's 4-frame window at cap = tgt_cap = 32, with frame 2's
    first 40 atoms packed into one cell (that frame overflows)."""
    coords, src, tgt, cutoff, boxes, invs, pbc, _, dims = window("random19")
    coords = coords.copy()
    rng = np.random.default_rng(5)
    coords[2, :40] = coords[2, 0] + rng.uniform(0, 0.05, (40, 3)).astype(np.float32)
    masks, ofl = neighbor.within_mask_window(_t(coords), _t(src), _t(tgt), cutoff, _t(boxes),
                                             _t(invs), dims, 32, 32, pbc)
    return dict(coords=coords, tgt=tgt, cutoff=cutoff, boxes=boxes, invs=invs, pbc=pbc,
                dims=dims, masks=masks.numpy(), ofl=ofl.numpy())


def _jax_frame(w, f, variant):
    args = (jnp.asarray(w["coords"][f]), jnp.arange(w["coords"].shape[1]), jnp.asarray(w["tgt"]))
    box, inv = jnp.asarray(w["boxes"][f]), jnp.asarray(w["invs"][f])
    if variant == "pallas":
        mask, ofl = within_ghost_pallas(*args, w["cutoff"], box, inv, w["dims"], cap=32,
                                        tgt_cap=32, pbc=w["pbc"], interpret=True)
    else:
        kw = dict(ghost=True) if variant == "ghost" else dict(max_tgt_cells=512)
        mask, ofl = jnb.within_mask(*args, cutoff=w["cutoff"], box=box, inv=inv, dims=w["dims"],
                                    cap=32, tgt_cap=32, pbc=w["pbc"], **kw)
    return np.asarray(mask), bool(ofl)


@pytest.mark.parametrize("variant", ["ghost", "sparse", "pallas"])
def test_window_matches_jax_per_frame(overflow_window, variant):
    w = overflow_window
    assert w["ofl"].tolist() == [False, False, True, False]
    for f in range(w["coords"].shape[0]):
        want, wofl = _jax_frame(w, f, variant)
        assert wofl == w["ofl"][f]
        if not wofl:
            np.testing.assert_array_equal(w["masks"][f], want)
            assert want.any()


def test_counting_sort_twin_flags_the_overflowed_frame(overflow_window):
    w = overflow_window
    *_, counts, ofl = ng.cell_bins(_t(w["coords"]), None, _t(w["tgt"]), _t(w["boxes"]),
                                   _t(w["invs"]), w["dims"], 32, 32)
    np.testing.assert_array_equal(ofl.numpy(), w["ofl"])
    assert (counts[:, 0].amax(dim=1) > 32).tolist() == w["ofl"].tolist()


@pytest.mark.parametrize("name", GHOST_SCENES)
def test_image_rule_matches_ghost_plane_borders(name):
    """Every cell of the ghost-padded target planes, border cells included,
    reached from every real cell by every offset, equals the neighbour
    cell's targets shifted by the in-kernel image rule, bit for bit; past a
    non-periodic edge both hold nothing."""
    coords, src, tgt, cutoff, sides, pbc, _ = scene(name)
    pbox = PeriodicBox(np.diag(sides).astype(np.float32))
    box, inv = _t(pbox.matrix), _t(pbox.inv)
    dims = neighbor.grid_dims(pbox.box_extents(), cutoff)
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    *_, tx, ty, tz, tcx, tcy, tcz = neighbor._search_args(_t(coords), _t(src), _t(tgt), box, inv,
                                                          dims)
    tflat = (tcx * ny + tcy) * nz + tcz
    count = torch.bincount(tflat.long(), minlength=n_cells)
    cap = int(count.max())
    tflat_pad = ((tcx + 1) * (ny + 2) + (tcy + 1)) * (nz + 2) + (tcz + 1)
    ghost, gofl = neighbor._ghost_planes([tx, ty, tz], tflat_pad, dims, cap, box, pbc,
                                         neighbor.TGT_PAD)
    planes, *_ = neighbor._blocked_planes([tx, ty, tz], tflat, n_cells, cap,
                                          [neighbor.TGT_PAD] * 3)
    assert not bool(gofl)
    cells, shifts, ok = ng._image_cells(dims, pbc, "cpu")
    own = torch.arange(n_cells)
    cx, cy, cz = own // (ny * nz), (own // nz) % ny, own % nz
    seen = torch.zeros((nx + 2, ny + 2, nz + 2), dtype=torch.bool)
    for o, (ox, oy, oz) in enumerate(ng._OFFSETS):
        at = (cx + ox + 1, cy + oy + 1, cz + oz + 1)
        images = ng._image_shift(*(p[cells[o]] for p in planes), box, shifts[o][:, None, :])
        valid = ok[o][:, None] & (torch.arange(cap) < count[cells[o]][:, None])
        for g, image in zip(ghost, images):
            border = g[at]
            assert torch.equal(border[valid].view(torch.int32), image[valid].view(torch.int32))
            assert (border[~ok[o]] == neighbor.TGT_PAD).all()
        seen[at] = True
    assert seen.all()
    assert bool(ok.all()) == all(pbc)


@pytest.mark.parametrize("name", GHOST_SCENES)
def test_counting_sort_twin_matches_blocked_planes(name):
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name)
    c, s, tg, b, i = (_t(a) for a in (coords, src, tgt, boxes, invs))
    src_rec, tgt_rec, counts, ofl = ng._cell_bins_plain(c, s, tg, b, i, dims, cap, cap)
    assert not ofl.any()
    sizes = (coords.shape[1] if src is None else len(src), len(tgt))
    for f in range(coords.shape[0]):
        want = blocked_members(c[f], s, tg, b[f], i[f], dims, cap, cap)
        for k, (rec, (pos, xyz)) in enumerate(zip((src_rec[f], tgt_rec[f]), want)):
            got_pos, got_xyz = cell_members(rec, counts[f, k], cap)
            assert torch.equal(got_pos, pos) and torch.equal(got_xyz, xyz)
            assert torch.equal(counts[f, k], (pos >= 0).sum(-1).int())
            assert int(counts[f, k].sum()) == sizes[k]


@pytest.mark.parametrize("name", GHOST_SCENES)
def test_kernel_twins_match_window_twin(name):
    """The two kernels' plain twins (what the wrappers run on CPU tensors)
    give the window twin's masks, which the JAX tests hold."""
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name)
    c, s, tg, b, i = (_t(a) for a in (coords, src, tgt, boxes, invs))
    want, wofl = neighbor.within_mask_window(c, s, tg, cutoff, b, i, dims, cap, cap, pbc)
    src_rec, tgt_rec, counts, ofl = ng.cell_bins(c, s, tg, b, i, dims, cap, cap)
    got = ng.within_ghost(src_rec, tgt_rec, counts, b, dims, cap, cap, pbc,
                          neighbor._cutoff2(cutoff), want.shape[1])
    assert not wofl.any() and torch.equal(ofl, wofl)
    assert torch.equal(got, want) and want.any()
