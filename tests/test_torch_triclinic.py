"""Port vs JAX package: the triclinic correction path of the ``within`` search.

On every device the port's ``within_mask(corrections=...)`` runs plain
torch. Its mask must equal, exactly, the JAX package's ``within_mask`` given
the same padded corrections and the same grid dims, dense and sparse, on
the triclinic scenes of the JAX package's own tests; and, on rhombic
dodecahedra (the box GROMACS users pick for a solvated protein) with grids
sized by :func:`grid_dims_for`, the float64 brute force over the lattice
images, where a source may differ only if its least distance lies within
1e-6 relative of the cutoff (float32 rounding).

The JAX package sizes skewed grids from the box vectors' lengths, which
makes cells thinner than the cutoff; one test pins that the length-sized
grid misses atoms (in both packages alike) and the height-sized one does
not. The slice test streams a small dodecahedron XTC through
``FitWithinWindow`` on the correction route (asked for by name: the box's
default is the ghost route) and holds its masks (exactly) and RMSDs (to
1e-5) against a JAX-CPU window function fed the same windows, corrections
built per frame from each frame's box, and the same dims; the same stream
through the default route must equal it but for sources at the cutoff.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu.core import pbc as jpbc
from molar_tpu.core.pbc import PBC_FULL
from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import neighbor_host
from molar_tpu.tasks import trajectory as jtraj

from molar_tpu_torch import convert, headline
from molar_tpu_torch.core.pbc import PeriodicBox, build_tric_corrections
from molar_tpu_torch.io.xtc import XtcHandler
from molar_tpu_torch.ops import neighbor
from molar_tpu_torch.ops.neighbor import grid_dims, grid_dims_for
from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

from torch_scenes import brute_within, dodeca_scene, dodecahedron, outside_band

CUTOFF = 0.5
#: A source may leave the brute-force set only this close to the cutoff.
REL_TIE = 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tric_scene(name):
    """The JAX package's triclinic scenes (``test_neighbor_device.py`` and
    ``test_neighbor_adversarial.py``) -> (coords, tgt, box matrix)."""
    if name == "device_80_85_75":
        m = jpbc.PeriodicBox.from_vectors_angles(4.0, 5.0, 6.0, 80.0, 85.0, 75.0).matrix
        coords = np.random.default_rng(3).uniform(-2, 8, (400, 3)).astype(np.float32)
        return coords, np.arange(0, 400, 7), m
    if name == "adversarial_75_80_70":
        m = jpbc.PeriodicBox.from_vectors_angles(3.0, 3.2, 3.4, 75.0, 80.0, 70.0).matrix
        coords = np.random.default_rng(41).uniform(0, 3, (300, 3)).astype(np.float32)
        return coords, np.arange(0, 300, 5), m
    raise KeyError(name)


def _port(coords, src, tgt, box, dims, max_tgt_cells=None, device="cpu"):
    cap, tcap, cells = neighbor.estimate_caps(coords, box.inv, dims, tgt)
    dev = lambda a: None if a is None else _t(a).to(device)  # noqa: E731
    mask, ofl = neighbor.within_mask(
        dev(coords), dev(src), dev(tgt), CUTOFF, dev(box.matrix), dev(box.inv),
        corrections=dev(box.padded_corrections()), dims=dims, cap=cap, tgt_cap=tcap,
        max_tgt_cells=max_tgt_cells and cells + max_tgt_cells)
    return mask.cpu().numpy(), bool(ofl)


def _jax(coords, src, tgt, box, dims, max_tgt_cells=None):
    cap, tcap, cells = neighbor.estimate_caps(coords, box.inv, dims, tgt)
    mask, ofl = jnb.within_mask(
        jnp.asarray(coords), None if src is None else jnp.asarray(src), jnp.asarray(tgt),
        cutoff=CUTOFF, box=jnp.asarray(box.matrix), inv=jnp.asarray(box.inv),
        corrections=jnp.asarray(box.padded_corrections()), dims=dims, cap=cap, tgt_cap=tcap,
        max_tgt_cells=max_tgt_cells and cells + max_tgt_cells)
    return np.asarray(mask), bool(ofl)


def _assert_brute(mask, coords, tgt, m):
    """``mask`` over every atom equals the float64 brute force, but for
    sources whose least distance is within REL_TIE of the cutoff."""
    want, dmin = brute_within(coords, np.arange(len(coords)), tgt, m, CUTOFF)
    differ = np.flatnonzero(mask != want)
    far = differ[np.abs(dmin[differ] / CUTOFF - 1) > REL_TIE]
    assert far.size == 0, (far[:10], dmin[far[:10]])


@pytest.mark.parametrize("matrix", [
    _tric_scene("device_80_85_75")[2], _tric_scene("adversarial_75_80_70")[2],
    dodecahedron(3.0), dodecahedron(11.225), np.diag([4.0, 5.0, 6.0]),
    np.array([[4.0, 0.3, -0.2], [0.0, 5.0, 0.4], [0.0, 0.0, 6.0]])], ids=[
    "device", "adversarial", "dodeca3", "dodeca11", "ortho", "skew"])
def test_tric_corrections_and_heights_match_jax_and_numpy(matrix):
    got, want = PeriodicBox(matrix), jpbc.PeriodicBox(matrix)
    np.testing.assert_array_equal(got.corrections, want.corrections)
    np.testing.assert_array_equal(got.padded_corrections(), want.padded_corrections())
    np.testing.assert_array_equal(build_tric_corrections(matrix),
                                  jpbc.build_tric_corrections(matrix))
    assert got.padded_corrections().shape == (26, 3)
    assert got.is_triclinic == want.is_triclinic == (got.corrections.shape[0] > 0)
    # Heights: the distance between opposite faces, 1 / |row i of M^-1|.
    heights = got.cell_heights()
    inv64 = np.linalg.inv(got.matrix.astype(np.float64))
    np.testing.assert_allclose(heights, 1.0 / np.linalg.norm(inv64, axis=1), rtol=1e-12)
    assert (heights <= got.box_extents() * (1 + 1e-6)).all()
    if not got.is_triclinic:
        np.testing.assert_allclose(heights, got.box_extents(), rtol=1e-12)


def test_grid_dims_for():
    head = PeriodicBox(np.diag([10.0] * 3))
    assert grid_dims_for(head, CUTOFF) == grid_dims(head.box_extents(), CUTOFF) == (20, 20, 20)
    d = (1000.0 * np.sqrt(2)) ** (1 / 3)
    dodeca = PeriodicBox(dodecahedron(d))
    assert grid_dims(dodeca.box_extents(), CUTOFF) == (22, 22, 22)
    assert grid_dims_for(dodeca, CUTOFF) == (18, 18, 15)


@pytest.mark.parametrize("dims", [(4, 5, 6), (2, 3, 4), (1, 1, 3), (2, 2, 2), (3, 1, 2)])
@pytest.mark.parametrize("pbc", [(True, True, True), (True, False, True)])
def test_cell_neighbor_ids_match_jax(dims, pbc):
    got = neighbor._cell_neighbor_ids(dims, pbc, "cpu").numpy()
    np.testing.assert_array_equal(got, jnb._cell_neighbor_ids(dims, pbc))


@pytest.mark.parametrize("size", [3, 7, 64])
def test_occupied_cells_compact_like_jax_nonzero(size):
    flat = np.random.default_rng(size).integers(0, 40, 30).astype(np.int32)
    cells, valid, ofl = neighbor._occupied_cells(_t(flat), size)
    uniq = np.unique(flat)
    k = min(size, len(uniq))
    assert valid.numpy().tolist() == [True] * k + [False] * (size - k)
    np.testing.assert_array_equal(cells.numpy()[:k], uniq[:k])
    assert (cells.numpy()[k:] == 0).all() and bool(ofl) == (len(uniq) > size)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", ["device_80_85_75", "adversarial_75_80_70"])
def test_correction_path_matches_jax(name, sparse):
    """Exact equality with the JAX package on the same dims, both the
    JAX tests' length-sized grid and the height-sized one; src_idx=None
    equals the explicit arange; the host search agrees."""
    coords, tgt, m = _tric_scene(name)
    box = PeriodicBox(m)
    mtc = 8 if sparse else None
    for dims in {grid_dims(box.box_extents(), CUTOFF), grid_dims_for(box, CUTOFF)}:
        got, ofl = _port(coords, None, tgt, box, dims, mtc)
        want, wofl = _jax(coords, np.arange(len(coords)), tgt, box, dims, mtc)
        assert not ofl and not wofl
        np.testing.assert_array_equal(got, want)
    sub, _ = _port(coords, np.arange(len(coords)), tgt, box, dims, mtc)
    np.testing.assert_array_equal(sub, got)
    host = neighbor_host.search_within(CUTOFF, coords, np.arange(len(coords)), tgt,
                                       jpbc.PeriodicBox(m), PBC_FULL)
    np.testing.assert_array_equal(np.flatnonzero(got), host)


def test_correction_path_overflow_flags():
    """Each capacity that is one short raises the flag; exact ones do not."""
    coords, tgt, m = _tric_scene("device_80_85_75")
    box = PeriodicBox(m)
    dims = grid_dims_for(box, CUTOFF)
    cap, tcap, cells = neighbor.estimate_caps(coords, box.inv, dims, tgt, margin=1.0, round_to=1)
    args = (_t(coords), None, _t(tgt), CUTOFF, _t(box.matrix), _t(box.inv))
    corr = _t(box.padded_corrections())
    for caps, expect in (((cap, tcap, cells), False), ((cap - 1, tcap, cells), True),
                         ((cap, tcap - 1, cells), True), ((cap, tcap, cells - 1), True)):
        _, ofl = neighbor.within_mask(*args, corrections=corr, dims=dims, cap=caps[0],
                                      tgt_cap=caps[1], max_tgt_cells=caps[2])
        assert bool(ofl) == expect, caps


@pytest.mark.parametrize("d,seed", [(3.0, 0), (3.0, 1), (4.0, 0), (6.0, 0)])
def test_dodecahedron_matches_brute_force(d, seed):
    coords, tgt, m = dodeca_scene(d, seed)
    box = PeriodicBox(m)
    dims = grid_dims_for(box, CUTOFF)
    got, ofl = _port(coords, None, tgt, box, dims, 8)
    assert not ofl and got.any()
    _assert_brute(got, coords, tgt, m)
    if d == 3.0:
        dense, _ = _port(coords, None, tgt, box, dims)
        np.testing.assert_array_equal(dense, got)
        want, _ = _jax(coords, None, tgt, box, dims, 8)
        np.testing.assert_array_equal(got, want)


def test_length_sized_grid_misses_atoms_in_dodecahedron():
    """The reference's fault, pinned: cells sized from the vector lengths
    (6^3 at d = 3 nm) are thinner than the cutoff, and both packages miss
    the same atoms; cells sized from the heights (4^3) miss none."""
    coords, tgt, m = dodeca_scene(3.0, 0)
    box = PeriodicBox(m)
    want, _ = brute_within(coords, np.arange(len(coords)), tgt, m, CUTOFF)
    lengths = grid_dims(box.box_extents(), CUTOFF)
    assert lengths == (6, 6, 6) and grid_dims_for(box, CUTOFF) == (4, 4, 4)
    port, _ = _port(coords, None, tgt, box, lengths, 8)
    ref, _ = _jax(coords, None, tgt, box, lengths, 8)
    np.testing.assert_array_equal(port, ref)
    assert not (port & ~want).any() and (want & ~port).sum() > 0
    fixed, _ = _port(coords, None, tgt, box, grid_dims_for(box, CUTOFF), 8)
    np.testing.assert_array_equal(fixed, want)


# ---------------------------------------------------------------- the slice

D, N_PROTEIN, N_FRAMES, WINDOW = 3.0, 190, 6, 3


@pytest.fixture(scope="module")
def dodeca_system(tmp_path_factory):
    box = PeriodicBox(dodecahedron(D))
    n = int(round(100.0 * abs(np.linalg.det(box.matrix.astype(np.float64)))))
    coords0, masses = headline.make_system(n, N_PROTEIN, box.matrix)
    path = str(tmp_path_factory.mktemp("dodeca") / "traj.xtc")
    headline.write_trajectory(path, coords0, box.matrix, N_FRAMES)
    pidx = np.arange(N_PROTEIN)
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    return dict(path=path, coords0=coords0, masses=masses, box=box, pidx=pidx, dims=dims,
                caps0=caps0, n=n)


def _jax_tric_window_fn(s, caps):
    """The headline window function on JAX-CPU with the correction path:
    candidates from each frame's box (the ``selection/compiled.py`` form),
    sparse targets. -> (rmsd, masks, overflow) per frame."""
    pidx = jnp.asarray(s["pidx"])
    ref = jnp.asarray(s["coords0"][s["pidx"]])
    pm = jnp.asarray(s["masses"][s["pidx"]])
    cap, tcap, cells = caps
    cells = min(cells, int(np.prod(s["dims"])))  # the port's own cap; the masks do not change
    ijk = jnp.asarray(np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                                for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)], np.float32))

    @jax.jit
    def window_fn(coords, boxes, invs):
        coords = jtraj.decode_window_coords(coords)

        def per_frame(carry, frame):
            c, b, i = frame
            corr = (ijk[:, 0:1] * b[:, 0][None, :] + ijk[:, 1:2] * b[:, 1][None, :]
                    + ijk[:, 2:3] * b[:, 2][None, :])
            sel = jnp.stack([c[:, 0][pidx], c[:, 1][pidx], c[:, 2][pidx]], axis=-1)
            rmsd, _, _ = jmeasure.fit_rmsd(sel, ref, pm)
            mask, ofl = jnb.within_mask(c, None, pidx, cutoff=CUTOFF, box=b, inv=i,
                                        corrections=corr, dims=s["dims"], cap=cap,
                                        tgt_cap=tcap, max_tgt_cells=cells)
            return carry, (rmsd, mask, ofl)

        return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

    return window_fn


def test_fit_within_window_dodecahedron_matches_jax(dodeca_system):
    s = dodeca_system
    caps = headline.caps_for(*s["caps0"], 0)
    # Pinned by name: the default route of this box is the ghost route.
    model = convert.from_numpy(s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                               s["box"].matrix, CUTOFF, caps, s["dims"], "cpu",
                               search="corrections")
    assert model.search == "corrections" and s["dims"] == (4, 4, 4)
    corr = model.frame_corrections(torch.from_numpy(s["box"].matrix)[None])[0].numpy()
    pruned = s["box"].corrections[s["box"].corrections.any(axis=1)]
    assert len(pruned) and all(any(np.array_equal(p, c) for c in corr) for p in pruned)
    jax_fn = _jax_tric_window_fn(s, caps)
    n_frames = 0
    for window in TrajectoryReader([s["path"]]).iter_windows(WINDOW, quantized="delta"):
        transport, boxes, invs = convert.transport_to_torch(window, "cpu")
        masks, ofl = model.masks(decode_window_coords(transport), boxes, invs)
        rmsd, count, check, _ = model(transport, boxes, invs)
        jtransport = tuple(map(jnp.asarray, window[0]))
        jrmsd, jmasks, jofl = jax_fn(jtransport, jnp.asarray(window[1]), jnp.asarray(window[2]))
        assert not ofl.any() and not np.asarray(jofl).any()
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        np.testing.assert_allclose(rmsd.numpy(), np.asarray(jrmsd), atol=1e-5, rtol=0)
        assert torch.equal(count, masks.sum(dim=1)) and (count > 0).all()
        n_frames += len(window[4])
    assert n_frames == N_FRAMES


def test_fit_within_window_dodecahedron_ghost_route(dodeca_system):
    """The same stream through the default route, the ghost kernels' plain
    twin: RMSDs equal the correction route's bit for bit, masks equal its
    and the float64 brute force's but for sources within REL_TIE of the
    cutoff."""
    s = dodeca_system
    caps = headline.caps_for(*s["caps0"], 0)
    args = (s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"], s["box"].matrix, CUTOFF,
            caps, s["dims"], "cpu")
    ghost = convert.from_numpy(*args)
    corr = convert.from_numpy(*args, search="corrections")
    assert (ghost.search, corr.search) == ("ghost", "corrections")
    n_frames = 0
    for window in TrajectoryReader([s["path"]]).iter_windows(WINDOW, quantized="delta"):
        transport, boxes, invs = convert.transport_to_torch(window, "cpu")
        coords = decode_window_coords(transport)
        masks, ofl = ghost.masks(coords, boxes, invs)
        cmasks, cofl = corr.masks(coords, boxes, invs)
        assert not ofl.any() and not cofl.any() and masks.any()
        rmsd, count, _, _ = ghost(transport, boxes, invs)
        crmsd, _, _, _ = corr(transport, boxes, invs)
        assert torch.equal(rmsd, crmsd) and torch.equal(count, masks.sum(dim=1))
        for f in range(coords.shape[0]):
            c, m = coords[f].numpy(), boxes[f].numpy()
            want, _ = brute_within(c, np.arange(s["n"]), s["pidx"], m, CUTOFF)
            for other in (cmasks[f].numpy(), want):
                far, dmin = outside_band(masks[f].numpy(), other, c, s["pidx"], m, CUTOFF,
                                         REL_TIE)
                assert far.size == 0, (far[:10], dmin[:10])
        n_frames += len(window[4])
    assert n_frames == N_FRAMES


def test_dodecahedron_run_matches_brute_force(dodeca_system):
    """The user's entry point on a skewed box: the last frame's count and
    checksum are the brute force's (no source near the cutoff)."""
    s = dodeca_system
    ids, rmsd, count, check, retried = headline.run(
        s["path"], s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"], s["box"],
        CUTOFF, s["dims"], s["caps0"], WINDOW, "cpu")
    assert ids.tolist() == list(range(N_FRAMES)) and retried == 0
    assert np.isfinite(rmsd).all() and (rmsd > 0).all()
    with XtcHandler(s["path"]) as h:
        last = h.read_frame(N_FRAMES - 1).coords
    want, dmin = brute_within(last, np.arange(s["n"]), s["pidx"], s["box"].matrix, CUTOFF)
    assert np.abs(dmin / CUTOFF - 1).min() > REL_TIE
    hits = np.flatnonzero(want)
    assert count[-1] == len(hits) and check[-1] == int((hits + 1).sum()) % 2**32
