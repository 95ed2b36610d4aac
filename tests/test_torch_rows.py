"""Port vs JAX package: the row-tiled per-pair min-image ``within`` search.

On the CPU ``within_mask_rows`` (a window of one of
``within_mask_rows_window``) runs the plain plane twin of the route that
``csrc/cell_bin.cu`` + ``csrc/within_rows.cu`` take on the card.
Its mask must equal, exactly, ``within_mask_pallas`` in interpret mode (the
TPU kernel it replaces) on that kernel's own scenes (seeds 11 and 3 at
cutoffs 0.5 and 0.8, a grid with a 2-cell axis, an explicit source subset),
and the numpy host search on every orthorhombic full-PBC scene of
``torch_scenes.py``, cutoff ties included. The slice test streams a small
orthorhombic XTC through ``FitWithinWindow(search="rows")`` and holds its
masks (exactly) and RMSDs (to 1e-5) against a JAX-CPU window function that
runs ``within_mask_pallas`` on the same windows; the window's masks must be
the frame-by-frame ones, and ``run`` must retry overflowed windows on the
row route to the ghost route's result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu.core.pbc import PBC_FULL, PbcDims, PeriodicBox
from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import neighbor_host
from molar_tpu.ops.neighbor_pallas import within_mask_pallas
from molar_tpu.tasks import trajectory as jtraj

from molar_tpu_torch import convert, headline
from molar_tpu_torch.core.pbc import PeriodicBox as TorchBox
from molar_tpu_torch.ops import neighbor, neighbor_rows
from molar_tpu_torch.ops.neighbor_rows import within_mask_rows
from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

from torch_scenes import ROW_SCENES, TIE_MEMBERS, scene


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(coords, src, tgt, cutoff, sides, cap, tgt_cap=32):
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    mask, ofl = within_mask_rows(_t(coords), _t(src), _t(tgt), cutoff, _t(box.matrix),
                                 _t(box.inv), dims, cap=cap, tgt_cap=tgt_cap)
    return mask.numpy(), bool(ofl)


def _pallas(coords, src, tgt, cutoff, sides, cap, tgt_cap=32):
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    dims = jnb.grid_dims(box.box_extents(), cutoff)
    src = np.arange(len(coords)) if src is None else src
    mask, ofl = within_mask_pallas(
        jnp.asarray(coords), jnp.asarray(src), jnp.asarray(tgt), cutoff,
        jnp.asarray(box.matrix), jnp.asarray(box.inv), dims, cap=cap, tgt_cap=tgt_cap,
        interpret=True)
    return np.asarray(mask), bool(ofl)


@pytest.mark.parametrize("name", ["pallas11_0.5", "pallas3_0.8", "small_grid_2x4x4"])
def test_rows_twin_matches_pallas_interpret_and_host(name):
    """Exact mask equality, src_idx=None on the port against the explicit
    arange on the Pallas kernel."""
    coords, _, tgt, cutoff, sides, _, cap = scene(name)
    tgt_cap = 64 if name == "small_grid_2x4x4" else 32
    got, ofl = _rows(coords, None, tgt, cutoff, sides, cap, tgt_cap)
    want, wofl = _pallas(coords, None, tgt, cutoff, sides, cap, tgt_cap)
    assert not ofl and not wofl
    np.testing.assert_array_equal(got, want)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    host = neighbor_host.search_within(cutoff, coords, np.arange(len(coords)), tgt, box,
                                       PBC_FULL)
    np.testing.assert_array_equal(np.flatnonzero(got), host)


def test_rows_twin_src_subset_matches_pallas_interpret():
    coords, _, tgt, cutoff, sides, _, cap = scene("small_grid_2x4x4")
    sub = np.array([199, 3, 50, 7, 120, 64, 0])
    got, ofl = _rows(coords, sub, tgt, cutoff, sides, cap, 64)
    want, wofl = _pallas(coords, sub, tgt, cutoff, sides, cap, 64)
    full, _ = _rows(coords, None, tgt, cutoff, sides, cap, 64)
    assert not ofl and not wofl and got.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full[sub])


@pytest.mark.parametrize("name", ROW_SCENES)
def test_rows_twin_matches_host(name):
    """Exact set equality with the numpy host search; ties kept."""
    coords, src, tgt, cutoff, sides, pbc, _ = scene(name)
    assert pbc == (True, True, True)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    src_pts = coords if src is None else coords[src]
    cap, _, _ = neighbor.estimate_caps(src_pts, box.inv, neighbor.grid_dims(
        box.box_extents(), cutoff))
    _, tgt_cap, _ = neighbor.estimate_caps(coords, box.inv, neighbor.grid_dims(
        box.box_extents(), cutoff), tgt)
    got, ofl = _rows(coords, src, tgt, cutoff, sides, cap, tgt_cap)
    assert not ofl
    src_ids = np.arange(len(coords)) if src is None else src
    want = neighbor_host.search_within(cutoff, coords, src_ids, tgt, box, PbcDims(*pbc))
    np.testing.assert_array_equal(np.sort(src_ids[got]), want)
    if name in TIE_MEMBERS:
        assert src_ids[got].tolist() == TIE_MEMBERS[name]


@pytest.mark.parametrize("cap,tgt_cap,expect", [(2, 64, True), (64, 1, True), (64, 64, False)])
def test_rows_overflow_flag_matches_ghost(cap, tgt_cap, expect):
    """The row planes overflow exactly when the ghost path's planes do (the
    same occupancies in another cell order; the ghost flag is held against
    the JAX package in ``test_torch_neighbor.py``)."""
    coords, _, tgt, cutoff, sides, _, _ = scene("random19")
    _, ofl = _rows(coords, None, tgt, cutoff, sides, cap, tgt_cap)
    box = PeriodicBox(np.diag(sides).astype(np.float32))
    _, gofl = neighbor.within_mask(
        _t(coords), None, _t(tgt), cutoff, _t(box.matrix), _t(box.inv),
        dims=neighbor.grid_dims(box.box_extents(), cutoff), cap=cap, tgt_cap=tgt_cap)
    assert ofl == bool(gofl) == expect


def test_rows_planes_are_x_minor_with_validity_and_penalty():
    """The row planes: cell (cx, cy, cz) at row cy*nz + cz, column cx;
    sources carry validity 1 / 0 and targets penalty 0 / 1e12."""
    coords, _, tgt, cutoff, sides, _, cap = scene("pallas3_0.8")
    box = TorchBox(np.diag(sides))
    dims = neighbor.grid_dims_for(box, cutoff)
    nx, ny, nz = dims
    src, tgtp, lengths, _, _, ofl = neighbor_rows._rows_inputs(
        _t(coords), None, _t(tgt), _t(box.matrix), _t(box.inv), dims, cap, 32)
    assert not bool(ofl)
    assert lengths.tolist() == list(sides)
    sx, sy, sz, sval = src
    tx, ty, tz, tpen = tgtp
    assert sx.shape == (ny * nz, nx, cap) and tx.shape == (ny * nz, nx, 32)
    assert int(sval.sum()) == len(coords) and set(sval.unique().tolist()) == {0.0, 1.0}
    assert int((tpen == 0).sum()) == len(tgt)
    assert set(tpen.unique().tolist()) == {0.0, float(np.float32(1e12))}
    real = sval > 0
    rows = torch.arange(ny * nz)[:, None, None].expand_as(sx)[real]
    cols = torch.arange(nx)[None, :, None].expand_as(sx)[real]
    cell = lambda v, n, L: torch.clamp((v / L * n).floor().long(), 0, n - 1)  # noqa: E731
    assert torch.equal(cell(sx[real], nx, sides[0]), cols)
    assert torch.equal(cell(sy[real], ny, sides[1]) * nz + cell(sz[real], nz, sides[2]), rows)


# ---------------------------------------------------------------- the slice

N_ATOMS, N_PROTEIN, N_FRAMES, WINDOW, CUTOFF = 2000, 200, 6, 3, 0.5
SIDE = 10.0 * (N_ATOMS / 100_000) ** (1 / 3)  # the headline's 100 atoms/nm^3


@pytest.fixture(scope="module")
def ortho_system(tmp_path_factory):
    box = TorchBox(np.diag([SIDE] * 3))
    coords0, masses = headline.make_system(N_ATOMS, N_PROTEIN, box.matrix)
    path = str(tmp_path_factory.mktemp("rows") / "traj.xtc")
    headline.write_trajectory(path, coords0, box.matrix, N_FRAMES)
    pidx = np.arange(N_PROTEIN)
    dims = neighbor.grid_dims_for(box, CUTOFF)
    caps = headline.caps_for(*headline.base_caps(path, box.inv, dims, pidx), 0)
    return dict(path=path, coords0=coords0, masses=masses, box=box, pidx=pidx, dims=dims,
                caps=caps)


def _jax_rows_window_fn(s):
    """The headline window function on JAX-CPU with the Pallas row kernel
    in interpret mode: (rmsd, masks, overflow) per frame."""
    pidx = jnp.asarray(s["pidx"])
    ref = jnp.asarray(s["coords0"][s["pidx"]])
    pm = jnp.asarray(s["masses"][s["pidx"]])
    aidx = jnp.arange(N_ATOMS)
    cap, tcap, _ = s["caps"]

    @jax.jit
    def window_fn(coords, boxes, invs):
        coords = jtraj.decode_window_coords(coords)

        def per_frame(carry, frame):
            c, b, i = frame
            sel = jnp.stack([c[:, 0][pidx], c[:, 1][pidx], c[:, 2][pidx]], axis=-1)
            rmsd, _, _ = jmeasure.fit_rmsd(sel, ref, pm)
            mask, ofl = within_mask_pallas(c, aidx, pidx, CUTOFF, b, i, s["dims"], cap=cap,
                                           tgt_cap=tcap, interpret=True)
            return carry, (rmsd, mask, ofl)

        return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

    return window_fn


def test_fit_within_window_rows_matches_jax(ortho_system):
    s = ortho_system
    model = convert.from_numpy(s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                               s["box"].matrix, CUTOFF, s["caps"], s["dims"], "cpu",
                               search="rows")
    assert model.search == "rows"
    jax_fn = _jax_rows_window_fn(s)
    n_frames = 0
    for window in TrajectoryReader([s["path"]]).iter_windows(WINDOW, quantized="delta"):
        transport, boxes, invs = convert.transport_to_torch(window, "cpu")
        masks, ofl = model.masks(decode_window_coords(transport), boxes, invs)
        rmsd, count, check, ofl2 = model(transport, boxes, invs)
        jtransport = tuple(map(jnp.asarray, window[0]))
        jrmsd, jmasks, jofl = jax_fn(jtransport, jnp.asarray(window[1]), jnp.asarray(window[2]))
        assert not ofl.any() and not ofl2.any() and not np.asarray(jofl).any()
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        np.testing.assert_allclose(rmsd.numpy(), np.asarray(jrmsd), atol=1e-5, rtol=0)
        assert torch.equal(count, masks.sum(dim=1)) and (count > 0).all()
        ids1 = np.arange(1, N_ATOMS + 1, dtype=np.uint32)
        want_check = [int(np.sum(ids1[m], dtype=np.uint32)) for m in np.asarray(jmasks)]
        assert check.tolist() == want_check
        n_frames += len(window[4])
    assert n_frames == N_FRAMES


def test_rows_route_equals_ghost_route_through_run(ortho_system):
    """The user's entry point on both orthorhombic routes: the same frames,
    counts and checksums (random-walk frames, no exact ties)."""
    s = ortho_system
    args = (s["path"], s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"], s["box"],
            CUTOFF, s["dims"], headline.base_caps(s["path"], s["box"].inv, s["dims"], s["pidx"]),
            WINDOW, "cpu")
    ghost = headline.run(*args)
    rows = headline.run(*args, search="rows")
    for a, b in zip(ghost[:4], rows[:4]):
        np.testing.assert_array_equal(a, b)
    assert ghost[4] == rows[4] == 0


def test_rows_window_masks_equal_frame_by_frame(ortho_system):
    """``FitWithinWindow.masks`` searches the window in one call; every
    frame must come out as ``within_mask_rows`` gives it alone."""
    s = ortho_system
    cap, tcap, _ = s["caps"]
    model = convert.from_numpy(s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                               s["box"].matrix, CUTOFF, s["caps"], s["dims"], "cpu",
                               search="rows")
    window = next(iter(TrajectoryReader([s["path"]]).iter_windows(WINDOW, quantized="delta")))
    transport, boxes, invs = convert.transport_to_torch(window, "cpu")
    coords = decode_window_coords(transport)
    masks, ofl = model.masks(coords, boxes, invs)
    assert masks.shape == (WINDOW, N_ATOMS) and ofl.shape == (WINDOW,) and not ofl.any()
    for f in range(WINDOW):
        one, one_ofl = within_mask_rows(coords[f], None, model.protein_idx, CUTOFF, boxes[f],
                                        invs[f], s["dims"], cap=cap, tgt_cap=tcap)
        assert not bool(one_ofl) and one.any() and torch.equal(one, masks[f])


def test_rows_route_retries_overflowed_windows_like_ghost(ortho_system):
    """Tier-0 capacities that are too small: both routes retry every window
    and end at the result of the run that never overflowed."""
    s = ortho_system
    cap0, tcap0, cells0 = headline.base_caps(s["path"], s["box"].inv, s["dims"], s["pidx"])
    small = (cap0 // 3, tcap0 // 3, cells0)
    assert headline.caps_for(*small, 0)[0] < cap0  # tier 0 must overflow

    def run(caps0, search):
        return headline.run(s["path"], s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                            s["box"], CUTOFF, s["dims"], caps0, WINDOW, "cpu", search=search)

    want = run((cap0, tcap0, cells0), "rows")
    rows, ghost = run(small, "rows"), run(small, "ghost")
    assert want[4] == 0 and rows[4] == ghost[4] == N_FRAMES // WINDOW
    for a, b, c in zip(want[:4], rows[:4], ghost[:4]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
