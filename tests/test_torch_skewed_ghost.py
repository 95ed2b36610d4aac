"""The ghost-slab search on skewed, fully periodic boxes.

On a grid whose cells are at least a cutoff thick between opposite faces
(:func:`grid_dims_for`, from the cell heights) a displacement within the
cutoff moves each fractional coordinate by at most one cell, so every
periodic image within the cutoff is a +-1-cell lattice shift: the ghost
stencil finds each. ``convert.from_numpy`` therefore keeps a skewed box on
the ghost route when the grid is no finer than that; a finer grid and
``search="rows"`` fall back to the correction path.

On rhombic dodecahedra of d = 3, 4 and 6 nm, the 1 %-a-frame rescaled
dodecahedron and a skewed box with a 2-cell axis, the port's ghost route
(the kernels' plain twin on the CPU) must equal, exactly, the JAX package's
``within_mask(corrections=None, ghost=True)`` given the same box and dims;
and it must equal the port's correction route and the float64 brute force
over the lattice images, but for sources whose least distance lies within
1e-6 relative of the cutoff (the two routes round differently there). The
headline counts each window a skewed box sends through the ghost route.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu.ops import neighbor as jnb

from molar_tpu_torch import convert, headline
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops import neighbor
from molar_tpu_torch.ops.neighbor import grid_dims, grid_dims_for
from molar_tpu_torch.tasks import trajectory as traj

from torch_scenes import SKEWED_SCENES, brute_within, dodecahedron, outside_band, skewed_window

CUTOFF = 0.5
#: A source may differ between routes only this close to the cutoff.
REL_TIE = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ghost(name):
    """The scene's window and the port's ghost-route masks over it."""
    coords, tgt, boxes, invs, dims, cap, tcap = skewed_window(name)
    masks, ofl = neighbor.within_mask_window(_t(coords), None, _t(tgt), CUTOFF, _t(boxes),
                                             _t(invs), dims, cap, tcap)
    assert not ofl.any()
    return coords, tgt, boxes, invs, dims, cap, tcap, masks.numpy()


def _build(box_matrix, dims, search="ghost"):
    n = 12
    return convert.from_numpy(np.zeros((n, 3), np.float32), np.ones(n, np.float32),
                              np.arange(n), box_matrix, CUTOFF, (48, 32, 512), dims, "cpu",
                              search=search)


@pytest.mark.parametrize("name", SKEWED_SCENES)
def test_from_numpy_keeps_a_skewed_box_on_the_ghost_route(name):
    """The height-sized grid (or a coarser one) keeps ``"ghost"``; a grid
    finer on any axis, ``search="rows"`` and ``search="corrections"`` take
    the correction path, with its buffer of lattice combinations."""
    _, _, boxes, _, dims, _, _ = skewed_window(name)
    box = PeriodicBox(boxes[0])
    assert box.is_triclinic and all(d <= g for d, g in zip(dims, grid_dims_for(box, CUTOFF)))
    ghost = _build(box.matrix, dims)
    assert ghost.search == "ghost" and ghost.skewed and not hasattr(ghost, "ijk")
    coarse = _build(box.matrix, tuple(max(d - 1, 1) for d in dims))
    assert coarse.search == "ghost"
    lengths = grid_dims(box.box_extents(), CUTOFF)
    assert any(l > g for l, g in zip(lengths, grid_dims_for(box, CUTOFF)))
    for dims_, search in ((lengths, "ghost"), (dims, "rows"), (dims, "corrections")):
        tric = _build(box.matrix, dims_, search)
        assert tric.search == "corrections" and tric.ijk.shape == (26, 3)


@pytest.mark.parametrize("search", ["ghost", "rows", "corrections"])
def test_from_numpy_keeps_an_orthorhombic_route(search):
    """An orthorhombic box takes the route asked for, at any grid."""
    box = np.diag([3.0, 3.5, 4.0]).astype(np.float32)
    for dims in ((6, 7, 8), (9, 9, 9)):
        model = _build(box, dims, search)
        assert model.search == search and not model.skewed
    with pytest.raises(ValueError, match="search must be one of"):
        _build(box, (6, 7, 8), "dense")


@pytest.mark.parametrize("name", SKEWED_SCENES)
def test_skewed_ghost_route_matches_jax(name):
    """Frame by frame, the JAX package's ghost path on the same box, dims
    and caps gives the same mask, bit for bit."""
    coords, tgt, boxes, invs, dims, cap, tcap, masks = _ghost(name)
    assert masks.any()
    fn = jax.jit(functools.partial(jnb.within_mask, cutoff=CUTOFF, dims=dims, cap=cap,
                                   tgt_cap=tcap, ghost=True))
    for f in range(coords.shape[0]):
        want, ofl = fn(jnp.asarray(coords[f]), None, jnp.asarray(tgt), box=jnp.asarray(boxes[f]),
                       inv=jnp.asarray(invs[f]))
        assert not bool(ofl)
        np.testing.assert_array_equal(masks[f], np.asarray(want))


@pytest.mark.parametrize("name", SKEWED_SCENES)
def test_skewed_ghost_route_matches_corrections_and_brute_force(name):
    """Against the port's correction route (sparse targets, candidates of
    each frame's box) and the float64 brute force: equal but for sources
    within REL_TIE of the cutoff."""
    coords, tgt, boxes, invs, dims, cap, tcap, masks = _ghost(name)
    for f in range(coords.shape[0]):
        box = PeriodicBox(boxes[f])
        corr, ofl = neighbor.within_mask(
            _t(coords[f]), None, _t(tgt), CUTOFF, _t(boxes[f]), _t(invs[f]),
            corrections=_t(box.padded_corrections()), dims=dims, cap=cap, tgt_cap=tcap,
            max_tgt_cells=int(np.prod(dims)))
        assert not bool(ofl)
        want, _ = brute_within(coords[f], np.arange(coords.shape[1]), tgt, boxes[f], CUTOFF)
        for other in (corr.numpy(), want):
            far, dmin = outside_band(masks[f], other, coords[f], tgt, boxes[f], CUTOFF, REL_TIE)
            assert far.size == 0, (f, far[:10], dmin[:10])


# ------------------------------------------------------- the headline's count

N_ATOMS, N_PROTEIN, N_FRAMES, WINDOW = 1000, 100, 5, 2


@pytest.fixture
def made(monkeypatch):
    """Every ``WindowPipeline`` made while the test runs."""
    pipes = []
    base = traj.WindowPipeline

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pipes.append(self)

    monkeypatch.setattr(traj, "WindowPipeline", Recorded)
    return pipes


@pytest.mark.parametrize("shape,search,want", [
    ("dodecahedron", "ghost", "windows"), ("dodecahedron", "corrections", 0),
    ("cube", "ghost", 0)])
def test_skewed_kernel_windows_are_counted(tmp_path, made, shape, search, want):
    """``fit_within.skewed_kernel_windows`` reads one a window on a skewed
    stream through the ghost route, nothing on the correction route or a
    cube."""
    m = dodecahedron(3.0) if shape == "dodecahedron" else np.diag([2.67] * 3).astype(np.float32)
    box = PeriodicBox(m)
    coords0, masses = headline.make_system(N_ATOMS, N_PROTEIN, box.matrix)
    path = str(tmp_path / "traj.xtc")
    headline.write_trajectory(path, coords0, box.matrix, N_FRAMES)
    pidx = np.arange(N_PROTEIN)
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    ids, *_ = headline.run(path, coords0[pidx], masses[pidx], pidx, box, CUTOFF, dims, caps0,
                           WINDOW, "cpu", search=search)
    assert len(ids) == N_FRAMES
    (pipe,) = made
    t = pipe.timings
    assert t["windows"] == -(-N_FRAMES // WINDOW)
    want = t["windows"] if want == "windows" else want
    assert t.get("fit_within.skewed_kernel_windows", 0) == want
