"""The port's CUDA kernels against their plain twins on the shared scenes.

This file imports no JAX, so it runs where the card is. The ``cuda``-marked
tests launch ``csrc/cell_bin.cu`` + ``csrc/within_ghost.cu`` (random
scenes, cutoff ties, tiny and collapsed periodic grids, partial PBC, a
small solvated protein, and windows of frames each in its own box) and
``csrc/cell_bin.cu`` + ``csrc/within_rows.cu`` (the orthorhombic full-PBC
scenes plus the row search's own, one with a 2-cell axis, one frame and
windows of frames each in its own box, in the tiled and the block-per-cell
launch), and require each mask, overflow flag and cell's member set to
equal the plain twin's exactly; they also
hold the triclinic correction path (plain torch) on the card against the
CPU on a rhombic dodecahedron, with host syncs made errors, the compiled
selections of ``selection/compiled.py`` (window functions over a 4-frame
window, in a cube and in a dodecahedron) against the same functions on the
CPU, mask for mask, with host syncs made errors and one ``cell_bins`` and
one ``within_ghost`` launch a ghost-route node, and at division ties (a
0-d device divisor is a true division), the RMSD
fit against a float64 Kabsch with TF32 pinned off and deliberately on, and
the espaloma GNN forward on the card against the torch-CPU forward, its
charges against the numpy walk with TF32 pinned off and deliberately on,
a window and a stream through a ``MeshWindowRunner`` of one, two and three
shards on this card against the unsharded ones (the ghost kernels once a
shard), and the grid contact list of a window at once against its frame
loop and the CPU, orthorhombic and triclinic, with host syncs made errors.
They skip without a card. On the card, without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The CPU tests here check what the plain twin must give on the tie scenes,
that each kernel wrapper takes the plain twin only for CPU tensors (without
counting a launch), and that it refuses any other non-CUDA device.
"""

import numpy as np
import pytest
import torch

from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops import neighbor, neighbor_ghost, neighbor_rows

from torch_scenes import (
    GHOST_SCENES, ROW_SCENES, SELECTION_TEXTS, TIE_MEMBERS, blocked_members, cell_members,
    dodeca_scene, scene, selection_scene, window,
)


def _search(name, device, **kw):
    coords, src, tgt, cutoff, sides, pbc, cap = scene(name)
    box = PeriodicBox(np.diag(sides))
    dims = neighbor.grid_dims(box.box_extents(), cutoff)

    def dev(a):
        return None if a is None else torch.as_tensor(a).to(device)

    kw.setdefault("cap", cap)
    mask, ofl = neighbor.within_mask(
        dev(coords), dev(src), dev(tgt), cutoff, dev(box.matrix), dev(box.inv),
        dims=dims, pbc=pbc, **kw)
    src_ids = np.arange(len(coords)) if src is None else src
    return src_ids[mask.cpu().numpy()], bool(ofl)


@pytest.mark.parametrize("name", sorted(TIE_MEMBERS))
def test_plain_twin_keeps_exact_ties(name):
    got, ofl = _search(name, "cpu")
    assert not ofl and got.tolist() == TIE_MEMBERS[name]


def _ghost_inputs(device, n_frames=2):
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window("random19", n_frames)
    t = [torch.as_tensor(a).to(device) for a in (coords, tgt, boxes, invs)]
    return t, dims, cap, pbc, neighbor._cutoff2(cutoff)


def test_kernel_wrapper_runs_plain_twin_on_cpu_tensors():
    (coords, tgt, boxes, invs), dims, cap, pbc, c2 = _ghost_inputs("cpu")
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    bins = neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims, cap, cap)
    want = neighbor_ghost._cell_bins_plain(coords, None, tgt, boxes, invs, dims, cap, cap)
    assert all(torch.equal(a, b) for a, b in zip(bins, want))
    got = neighbor_ghost.within_ghost(*bins[:3], boxes, dims, cap, cap, pbc, c2, coords.shape[1])
    twin = neighbor_ghost._bins_stencil(*bins[:3], boxes, dims, cap, cap, pbc, c2,
                                        coords.shape[1])
    assert (neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches) == before
    assert got.any() and not got.all() and torch.equal(got, twin)


def _stencil_on_a_prefix(device):
    """The stencil over records binned from every atom, asked for the first
    half of the atoms only -> (that mask, the whole mask's first half)."""
    (coords, tgt, boxes, invs), dims, cap, pbc, c2 = _ghost_inputs(device)
    bins = neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims, cap, cap)
    n = coords.shape[1]
    whole = neighbor_ghost.within_ghost(*bins[:3], boxes, dims, cap, cap, pbc, c2, n)
    part = neighbor_ghost.within_ghost(*bins[:3], boxes, dims, cap, cap, pbc, c2, n // 2)
    return part, whole[:, : n // 2]


def test_stencil_twin_writes_only_positions_below_n_src():
    part, want = _stencil_on_a_prefix("cpu")
    assert part.shape == want.shape and want.any() and torch.equal(part, want)


def test_kernel_wrapper_refuses_other_devices():
    (coords, tgt, boxes, invs), dims, cap, pbc, c2 = _ghost_inputs("meta")
    recs = [torch.zeros(2, 120, cap, 4, device="meta") for _ in range(2)]
    counts = torch.zeros(2, 2, 120, dtype=torch.int32, device="meta")
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims, cap, cap)
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_ghost.within_ghost(*recs, counts, boxes, dims, cap, cap, pbc, c2, 900)
    assert (neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches) == before


def _rows_search(name, device, plain=False, **kw):
    coords, src, tgt, cutoff, sides, _, cap = scene(name)
    box = PeriodicBox(np.diag(sides))
    dims = neighbor.grid_dims_for(box, cutoff)

    def dev(a):
        return None if a is None else torch.as_tensor(a).to(device)

    kw.setdefault("cap", cap)
    kw.setdefault("tgt_cap", cap)
    mask, ofl = neighbor_rows.within_mask_rows(
        dev(coords), dev(src), dev(tgt), cutoff, dev(box.matrix), dev(box.inv), dims,
        plain=plain, **kw)
    src_ids = np.arange(len(coords)) if src is None else src
    return src_ids[mask.cpu().numpy()], bool(ofl)


@pytest.mark.parametrize("name", sorted(TIE_MEMBERS))
def test_rows_plain_twin_keeps_exact_ties(name):
    got, ofl = _rows_search(name, "cpu")
    assert not ofl and got.tolist() == TIE_MEMBERS[name]


def _rows_stencil_inputs(device, n_frames=2):
    """random19's window binned on ``device`` -> the arguments of
    ``within_rows`` up to ``c2``, and the number of sources."""
    (coords, tgt, boxes, invs), dims, cap, _, c2 = _ghost_inputs(device, n_frames)
    bins = neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims, cap, cap)
    return (*bins[:3], boxes, dims, cap, cap, c2), coords.shape[1]


def test_rows_wrapper_runs_plain_twin_on_cpu_tensors():
    args, n = _rows_stencil_inputs("cpu")
    before = neighbor_rows.within_rows.launches
    got = neighbor_rows.within_rows(*args, n)
    want = neighbor_rows._rows_bins_stencil(*args, n)
    assert neighbor_rows.within_rows.launches == before
    assert got.any() and not got.all() and torch.equal(got, want)


def _rows_stencil_on_a_prefix(device):
    args, n = _rows_stencil_inputs(device)
    rows = neighbor_rows.within_rows
    return rows(*args, n // 2), rows(*args, n)[:, : n // 2]


def test_rows_stencil_twin_writes_only_positions_below_n_src():
    part, want = _rows_stencil_on_a_prefix("cpu")
    assert part.shape == want.shape and want.any() and torch.equal(part, want)


def test_rows_wrapper_refuses_other_devices():
    recs = [torch.zeros(2, 120, 24, 4, device="meta") for _ in range(2)]
    counts = torch.zeros(2, 2, 120, dtype=torch.int32, device="meta")
    boxes = torch.ones(2, 3, 3, device="meta")
    before = neighbor_rows.within_rows.launches
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_rows.within_rows(*recs, counts, boxes, (4, 5, 6), 24, 24, 0.25, 900)
    assert neighbor_rows.within_rows.launches == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GHOST_SCENES)
def test_kernel_matches_plain_on_card(cuda_device, name):
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    got, ofl = _search(name, cuda_device)
    torch.cuda.synchronize()
    assert neighbor_ghost.cell_bins.launches == before[0] + 1
    assert neighbor_ghost.within_ghost.launches == before[1] + 1
    twin, tofl = _search(name, cuda_device, plain=True)
    want, wofl = _search(name, "cpu")
    assert ofl is tofl is wofl is False
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,tgt_cap", [(2, 64), (64, 1)])
def test_kernel_overflow_flag_on_card(cuda_device, cap, tgt_cap):
    _, ofl = _search("random19", cuda_device, cap=cap, tgt_cap=tgt_cap)
    _, wofl = _search("random19", "cpu", cap=cap, tgt_cap=tgt_cap)
    assert ofl is wofl is True


@pytest.mark.cuda
@pytest.mark.parametrize("name", GHOST_SCENES)
def test_ghost_window_on_card_matches_twin(cuda_device, name):
    """A 4-frame window, each frame in its own box: masks and flags against
    the plain twin, the binning's counts against ``bincount`` and each
    cell's members (positions and coordinates) against the plain plane
    build, frame by frame."""
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name)
    d = [None if a is None else torch.as_tensor(a).to(cuda_device)
         for a in (coords, src, tgt, boxes, invs)]
    masks, ofl = neighbor.within_mask_window(*d[:3], cutoff, *d[3:], dims, cap, cap, pbc)
    twin, tofl = neighbor.within_mask_window(*d[:3], cutoff, *d[3:], dims, cap, cap, pbc,
                                             plain=True)
    assert not ofl.any() and torch.equal(ofl, tofl)
    assert torch.equal(masks, twin) and masks.any()
    src_rec, tgt_rec, counts, _ = neighbor_ghost.cell_bins(*d, dims, cap, cap)
    sizes = (coords.shape[1] if src is None else len(src), len(tgt))
    for f in range(coords.shape[0]):
        want = blocked_members(d[0][f], d[1], d[2], d[3][f], d[4][f], dims, cap, cap)
        for k, (rec, (pos, xyz)) in enumerate(zip((src_rec[f], tgt_rec[f]), want)):
            got_pos, got_xyz = cell_members(rec, counts[f, k], cap)
            assert torch.equal(got_pos, pos) and torch.equal(got_xyz, xyz)
            assert torch.equal(counts[f, k], (pos >= 0).sum(-1).int())
            assert int(counts[f, k].sum()) == sizes[k]


@pytest.mark.cuda
def test_binning_flags_an_index_outside_the_frame(cuda_device):
    (coords, tgt, boxes, invs), dims, cap, pbc, c2 = _ghost_inputs(cuda_device)
    tgt = tgt.clone()
    tgt[-1] = coords.shape[1]
    *_, ofl = neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims, cap, cap)
    assert ofl.all()


@pytest.mark.cuda
def test_stencil_kernel_writes_only_positions_below_n_src(cuda_device):
    part, want = _stencil_on_a_prefix(cuda_device)
    assert part.shape == want.shape and want.any() and torch.equal(part, want)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_planes(cuda_device):
    (coords, tgt, boxes, invs), dims, cap, pbc, c2 = _ghost_inputs(cuda_device)
    with pytest.raises(ValueError, match="shape"):
        neighbor_ghost.cell_bins(coords, None, tgt, boxes[:1], invs, dims, cap, cap)
    with pytest.raises(TypeError, match="float32"):
        neighbor_ghost.cell_bins(coords.double(), None, tgt, boxes, invs, dims, cap, cap)
    with pytest.raises(TypeError, match="int64"):
        neighbor_ghost.cell_bins(coords, None, tgt.int(), boxes, invs, dims, cap, cap)
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_ghost.cell_bins(coords.transpose(0, 1).contiguous().transpose(0, 1), None, tgt,
                                 boxes, invs, dims, cap, cap)
    src_rec, tgt_rec, counts, _ = neighbor_ghost.cell_bins(coords, None, tgt, boxes, invs, dims,
                                                           cap, cap)
    n = coords.shape[1]
    with pytest.raises(ValueError, match="shape"):
        neighbor_ghost.within_ghost(src_rec, tgt_rec, counts, boxes, dims, cap + 8, cap, pbc, c2, n)
    with pytest.raises(TypeError, match="int32"):
        neighbor_ghost.within_ghost(src_rec, tgt_rec, counts.long(), boxes, dims, cap, cap, pbc,
                                    c2, n)
    with pytest.raises(ValueError, match="bad sizes"):
        neighbor_ghost.within_ghost(src_rec, tgt_rec, counts, boxes, (0, 1, 1), cap, cap, pbc,
                                    c2, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROW_SCENES)
def test_rows_kernel_matches_plain_on_card(cuda_device, name):
    before = neighbor_ghost.cell_bins.launches, neighbor_rows.within_rows.launches
    got, ofl = _rows_search(name, cuda_device)
    torch.cuda.synchronize()
    assert neighbor_ghost.cell_bins.launches == before[0] + 1
    assert neighbor_rows.within_rows.launches == before[1] + 1
    twin, tofl = _rows_search(name, cuda_device, plain=True)
    want, wofl = _rows_search(name, "cpu")
    assert ofl is tofl is wofl is False
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, want)
    if name in TIE_MEMBERS:
        assert got.tolist() == TIE_MEMBERS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,tgt_cap", [(2, 64), (64, 1)])
def test_rows_kernel_overflow_flag_on_card(cuda_device, cap, tgt_cap):
    _, ofl = _rows_search("random19", cuda_device, cap=cap, tgt_cap=tgt_cap)
    _, wofl = _rows_search("random19", "cpu", cap=cap, tgt_cap=tgt_cap)
    assert ofl is wofl is True


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROW_SCENES + ["crowded"])
def test_rows_window_on_card_matches_twins(cuda_device, name):
    """A 4-frame window, each frame in its own box: masks and flags against
    the plane twin and the ghost route; the stencil kernel, in the tiled and
    the block-per-cell launch, against its record twin on the same records."""
    coords, src, tgt, cutoff, boxes, invs, pbc, cap, dims = window(name)
    d = [None if a is None else torch.as_tensor(a).to(cuda_device)
         for a in (coords, src, tgt, boxes, invs)]
    call = (*d[:3], cutoff, *d[3:], dims, cap, cap)
    masks, ofl = neighbor_rows.within_mask_rows_window(*call)
    twin, tofl = neighbor_rows.within_mask_rows_window(*call, plain=True)
    ghost, _ = neighbor.within_mask_window(*call)
    assert not ofl.any() and torch.equal(ofl, tofl)
    assert masks.any() and torch.equal(masks, twin) and torch.equal(masks, ghost)
    src_rec, tgt_rec, counts, _ = neighbor_ghost.cell_bins(*d, dims, cap, cap)
    args = (src_rec, tgt_rec, counts, d[3], dims, cap, cap, neighbor._cutoff2(cutoff),
            masks.shape[1])
    assert torch.equal(neighbor_rows.within_rows(*args), masks)
    assert torch.equal(neighbor_rows.within_rows(*args, cells_per_block=1), masks)
    assert torch.equal(neighbor_rows._rows_bins_stencil(*args), masks)


@pytest.mark.cuda
def test_rows_stencil_kernel_writes_only_positions_below_n_src(cuda_device):
    part, want = _rows_stencil_on_a_prefix(cuda_device)
    assert part.shape == want.shape and want.any() and torch.equal(part, want)


@pytest.mark.cuda
def test_rows_kernel_wrapper_rejects_bad_planes(cuda_device):
    (src_rec, tgt_rec, counts, boxes, dims, cap, _, c2), n = _rows_stencil_inputs(cuda_device)
    rows = neighbor_rows.within_rows
    with pytest.raises(ValueError, match="shape"):
        rows(src_rec, tgt_rec, counts, boxes, dims, cap + 8, cap, c2, n)
    with pytest.raises(ValueError, match="shape"):
        rows(src_rec, tgt_rec, counts, boxes[:1], dims, cap, cap, c2, n)
    with pytest.raises(TypeError, match="float32"):
        rows(src_rec.double(), tgt_rec, counts, boxes, dims, cap, cap, c2, n)
    with pytest.raises(TypeError, match="int32"):
        rows(src_rec, tgt_rec, counts.long(), boxes, dims, cap, cap, c2, n)
    with pytest.raises(ValueError, match="contiguous"):
        rows(src_rec.transpose(1, 2).contiguous().transpose(1, 2), tgt_rec, counts, boxes, dims,
             cap, cap, c2, n)
    with pytest.raises(ValueError, match="bad sizes"):
        rows(src_rec, tgt_rec, counts, boxes, (0, 1, 1), cap, cap, c2, n)
    with pytest.raises(ValueError, match="cells_per_block"):
        rows(src_rec, tgt_rec, counts, boxes, dims, cap, cap, c2, n, cells_per_block=33)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_correction_path_on_card_matches_cpu_without_sync(cuda_device, sparse):
    coords, tgt, m = dodeca_scene(4.0, 0)
    box = PeriodicBox(m)
    dims = neighbor.grid_dims_for(box, 0.5)
    cap, tcap, cells = neighbor.estimate_caps(coords, box.inv, dims, tgt)
    kw = dict(dims=dims, cap=cap, tgt_cap=tcap, max_tgt_cells=cells if sparse else None)

    def run(device):
        d = [torch.as_tensor(a).to(device) for a in
             (coords, tgt, box.matrix, box.inv, box.padded_corrections())]
        torch.cuda.synchronize()
        if device != "cpu":
            torch.cuda.set_sync_debug_mode("error")
        try:
            mask, ofl = neighbor.within_mask(d[0], None, d[1], 0.5, d[2], d[3],
                                             corrections=d[4], **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return mask.cpu().numpy(), bool(ofl)

    got, ofl = run(cuda_device)
    want, wofl = run("cpu")
    assert ofl is wofl is False and got.any()
    np.testing.assert_array_equal(got, want)


def _fit_rmsd64(frames, ref, masses):
    """Float64 mass-weighted RMSD of each frame to ``ref`` after the optimal
    rigid fit (Kabsch by SVD, reflections excluded)."""
    w = masses / masses.sum()
    b = ref - w @ ref
    out = []
    for x in frames.astype(np.float64):
        a = x - w @ x
        u, _, vt = np.linalg.svd((a * w[:, None]).T @ b)
        r = vt.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(vt.T @ u.T))]) @ u.T
        out.append(np.sqrt(w @ ((a @ r.T - b) ** 2).sum(1)))
    return np.array(out)


@pytest.mark.cuda
def test_fit_rmsd_tf32_on_card(cuda_device):
    """The headline's fit (5,000 selected atoms, 16 random-walk frames)
    against a float64 Kabsch, with TF32 pinned off and deliberately on; the
    pins are restored. TF32 is live when on (a 2048² product moves off
    float64 by more than 1e-4 relative) but does not move the fit off the
    1e-5 RMSD bar: measured 9.5e-9 pinned and 9.2e-9 with TF32 on an H100.
    The optimal RMSD is stationary in the rotation, so the covariance
    product's rounding enters only at second order."""
    from molar_tpu_torch.headline import make_system
    from molar_tpu_torch.ops.measure import fit_rmsd

    coords0, masses = make_system(100_000, 5000, np.diag([10.0] * 3))
    ref, m = coords0[:5000], masses[:5000]
    steps = np.random.default_rng(1).normal(0, 0.02, (16, 5000, 3))
    frames = (ref[None] + np.cumsum(steps, axis=0)).astype(np.float32)
    want = _fit_rmsd64(frames, ref.astype(np.float64), m.astype(np.float64))
    args = [torch.as_tensor(a).to(cuda_device) for a in (frames, ref, m)]
    a, b = np.random.default_rng(2).normal(size=(2, 2048, 2048)).astype(np.float32)
    prod = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.as_tensor(a).to(cuda_device), torch.as_tensor(b).to(cuda_device)

    def errors():
        fit = float(np.abs(fit_rmsd(*args)[0].cpu().numpy() - want).max())
        return fit, float(np.abs((ta @ tb).cpu().numpy() - prod).max() / np.abs(prod).max())

    pinned, pinned_prod = errors()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32, tf32_prod = errors()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    print(f"max abs error vs float64: fit_rmsd pinned {pinned:.3e}, TF32 {tf32:.3e}; "
          f"2048^2 product (relative) pinned {pinned_prod:.3e}, TF32 {tf32_prod:.3e}")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert pinned_prod < 1e-5 < 1e-4 < tf32_prod
    assert pinned <= 1e-5 and tf32 <= 1e-5


def _sasa_scene(n=600, seed=31):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.4, 3.6, (4, n, 3)).astype(np.float32)
    coords[1:] = coords[0] + np.cumsum(rng.normal(0, 0.01, (3, n, 3)), axis=0).astype(np.float32)
    return coords, rng.uniform(0.27, 0.33, n).astype(np.float32), (4.0, 4.0, 4.0), (6, 6, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_cap,k_cap,overflows", [(48, 96, False), (4, 96, True),
                                                      (48, 8, True)])
def test_sasa_lists_on_card_equal_the_cpu(cuda_device, cell_cap, k_cap, overflows):
    """The device list build (plain torch) on the card against the CPU:
    lists equal slot by slot where no flag is set, flags equal, and no
    host sync inside the build."""
    from molar_tpu_torch.ops import sasa_lr

    coords, radii, extents, dims = _sasa_scene()
    want, wofl = sasa_lr.neighbor_lists_device(torch.as_tensor(coords), torch.as_tensor(radii),
                                               extents, dims, cell_cap, k_cap)
    c, r = torch.as_tensor(coords).to(cuda_device), torch.as_tensor(radii).to(cuda_device)
    sasa_lr.neighbor_lists_device(c, r, extents, dims, cell_cap, k_cap)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, ofl = sasa_lr.neighbor_lists_device(c, r, extents, dims, cell_cap, k_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ofl.cpu().tolist() == wofl.tolist() == [overflows] * 4
    if not overflows:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [None, 500])
def test_sasa_on_card_matches_the_cpu(cuda_device, block):
    """Exact Lee-Richards areas of a 4-frame window on the card against the
    CPU, 2e-6 nm^2 an atom (``atan2`` and ``acos`` differ by ulps), with
    host syncs made errors; the banded form and Shrake-Rupley too."""
    from molar_tpu_torch.ops import sasa, sasa_lr

    coords, radii, extents, dims = _sasa_scene()
    want, wofl = sasa_lr.sasa_window(torch.as_tensor(coords), torch.as_tensor(radii), extents,
                                     dims, 48, 96, n_slices=32, block=block)
    c, r = torch.as_tensor(coords).to(cuda_device), torch.as_tensor(radii).to(cuda_device)
    sasa_lr.sasa_window(c, r, extents, dims, 48, 96, n_slices=32, block=block)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, ofl = sasa_lr.sasa_window(c, r, extents, dims, 48, 96, n_slices=32, block=block)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not ofl.any() and not wofl.any()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-6, rtol=0)
    assert float(got.sum()) > 0

    nbr, _ = sasa_lr.neighbor_lists(coords[0], radii, cap=128, skin=0.1)
    nbz, starts, w, g = sasa_lr.band_neighbor_lists(coords[0], radii, nbr, 32, skin=0.1)
    banded = sasa_lr.sasa_banded(c[0], r, nbz, starts, w, g, n_slices=32, block=block)
    np.testing.assert_allclose(banded.cpu().numpy(), want[0].numpy(), atol=4e-6, rtol=0)
    nbm, _ = sasa.neighbor_matrix(coords[0], radii, cap=128)
    sr = sasa.shrake_rupley(c[:2], r, nbm, n_points=240)
    sr_cpu = sasa.shrake_rupley(torch.as_tensor(coords[:2]), torch.as_tensor(radii),
                                torch.as_tensor(nbm), n_points=240)
    # A sample point on a neighbour's surface may fall on either side.
    assert (sr.cpu() - sr_cpu).abs().max() <= 4 * np.pi * 0.33**2 / 240 * 2


@pytest.mark.cuda
def test_sasa_series_on_card(cuda_device):
    from molar_tpu_torch.ops import sasa_lr

    coords, radii, extents, _ = _sasa_scene()
    vdw = radii.astype(np.float64) - 0.14
    on_card = sasa_lr.SasaSeries(coords[0], vdw, n_slices=32, extents=extents)
    on_cpu = sasa_lr.SasaSeries(coords[0], vdw, n_slices=32, extents=extents, device="cpu")
    assert on_card.device.type == "cuda"
    for c in coords:
        np.testing.assert_allclose(on_card.update(c).cpu().numpy(), on_cpu.update(c).numpy(),
                                   atol=2e-6, rtol=0)


def _membrane_case(kind: str):
    """A 72-lipid bilayer of the membrane workload with the options of
    ``kind``, its spec, its box and a window of 6 frames."""
    import dataclasses

    from molar_tpu_torch import workloads as wl

    b = wl.synth_bilayer(6, 6)
    spec, box = b.spec, b.box
    if kind == "smooth2_shells2":
        spec = dataclasses.replace(spec, options=dataclasses.replace(
            spec.options, max_smooth_iter=2, n_shells_smoothing=2))
    if kind == "triclinic":
        box = box.copy()
        box[0, 1] = 0.9
        spec = dataclasses.replace(spec, triclinic=True)
    return spec, b.coords, box, b.frames(6)[:, spec.subset]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["workload", "smooth2_shells2", "triclinic"])
def test_membrane_window_on_card_matches_cpu_without_sync(cuda_device, kind):
    """The membrane window function on the card against the CPU (the bars
    of ``torch_scenes.MEMBRANE_BARS``), with host syncs made errors."""
    from molar_tpu_torch.convert import transport_to_torch
    from molar_tpu_torch.membrane import MembraneDevice
    from molar_tpu_torch.membrane.device import to_numpy

    from torch_scenes import membrane_diffs, membrane_within_bars

    spec, coords, box, frames = _membrane_case(kind)
    cpu = MembraneDevice(spec, coords, box, engine="cpu")
    card = MembraneDevice(spec, coords, box, device=cuda_device)
    assert card.patch_cap == cpu.patch_cap
    want = cpu.compute_window(frames)
    boxes = np.broadcast_to(box, (len(frames), 3, 3)).astype(np.float32)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    window = transport_to_torch((frames, boxes, invs), cuda_device)
    card.window_fn(*window)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = card.window_fn(*window)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    diffs = membrane_diffs(want, to_numpy(got), spec.sp_lipids)
    assert membrane_within_bars(diffs), diffs
    assert want["valid"].any() and not want["overflow"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["box", "dodecahedron"])
@pytest.mark.parametrize("text", SELECTION_TEXTS)
def test_compiled_selection_on_card_matches_cpu(cuda_device, kind, text):
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.selection import FrameSelection

    top, coords, boxes, invs = selection_scene(kind)
    st0 = State(coords=coords[0], box=PeriodicBox(boxes[0]))
    card = FrameSelection(text, top, st0, device=cuda_device)
    cpu = FrameSelection(text, top, st0, device="cpu")
    assert card.tier == cpu.tier
    if card.tier != "device":
        assert kind == "dodecahedron" and "yny" in text  # partial PBC, skewed box: host tier
        return
    window = [torch.from_numpy(a) for a in (coords, boxes, invs)]
    on_card = [a.to(cuda_device) for a in window]
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    rows_before = neighbor_rows.within_rows.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        masks, overflow = card.compiled(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_ofl = cpu.compiled(*window)
    k = card.compiled.ghost_nodes
    assert (neighbor_ghost.cell_bins.launches - before[0],
            neighbor_ghost.within_ghost.launches - before[1]) == (k, k)
    assert neighbor_rows.within_rows.launches == rows_before
    assert not overflow.any() and not want_ofl.any()
    np.testing.assert_array_equal(masks.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_compiled_division_keeps_ties_on_card(cuda_device):
    """A math constant is a 0-d device tensor, so ``x / 3`` is a true
    division on the card: at the exact ties x = 1.5 (1.5 / 3 = 0.5), 2.0 and
    3.3f (3.3f / 1.1f = 3 in float32) the card's masks equal the CPU's."""
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.selection import FrameSelection

    top, coords, boxes, invs = selection_scene("box", n_frames=1)
    coords[0, :5, 0] = [1.5, 2.0, 3.3, 1.5 + 2**-22, 2.0 - 2**-22]
    st0 = State(coords=coords[0], box=PeriodicBox(boxes[0]))
    three = torch.tensor(3.0, device=cuda_device)
    assert torch.div(torch.tensor([1.5], device=cuda_device), three).item() == 0.5
    window = [torch.from_numpy(a) for a in (coords, boxes, invs)]
    for text in ("x / 3 <= 0.5", "x / 2 < 1.0", "x / 1.1 == 3.0", "x / 0.3 >= 5.0"):
        card = FrameSelection(text, top, st0, device=cuda_device)
        cpu = FrameSelection(text, top, st0, device="cpu")
        got, _ = card.compiled(*(a.to(cuda_device) for a in window))
        want, _ = cpu.compiled(*window)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=text)
        assert want[0, :5].any(), text


def _espaloma_inputs():
    """Features and adjacency of 20 corpus ligands and a 24-residue peptide."""
    from molar_tpu_torch.ff import espaloma

    from torch_molecules import ligand_corpus, peptide

    return [espaloma.featurize(*m) for m in ligand_corpus(20) + [peptide(24)]]


@pytest.mark.cuda
def test_espaloma_forward_on_card_matches_cpu(cuda_device):
    """The GNN forward on the card against the torch-CPU forward (e and s
    within 1e-5), and ``espaloma_charges`` on the card against the numpy
    walk (1e-4), with host syncs only where the call reads its result."""
    from molar_tpu_torch.ff import espaloma

    from torch_molecules import ligand_corpus

    cpu, card = espaloma.load_gnn("cpu"), espaloma.load_gnn(cuda_device)
    assert all(b.device.type == "cuda" for b in card.buffers())
    worst = 0.0
    for feat, adj in _espaloma_inputs():
        args = torch.from_numpy(feat), torch.from_numpy(adj)
        want = cpu(*args)
        got = card(*(a.to(cuda_device) for a in args))
        assert all(g.device.type == "cuda" and g.shape == (len(feat),) for g in got)
        worst = max(worst, *(float((g.cpu() - w).abs().max()) for g, w in zip(got, want)))
    assert worst <= 1e-5, worst
    for z, fc, bonds in ligand_corpus(5):
        want = espaloma.equilibrate(*espaloma.run_gnn(*espaloma.featurize(z, fc, bonds)))
        got = espaloma.espaloma_charges(z, fc, bonds)
        assert np.abs(got - want).max() <= 1e-4 and abs(got.sum()) < 1e-4


@pytest.mark.cuda
def test_espaloma_tf32_on_card(cuda_device):
    """How far TF32 moves the charges: the card's charges against the
    numpy walk with TF32 pinned off and deliberately on (the pins are
    restored), on 20 ligands and a 24-residue peptide. Pinned they stay
    within the 1e-4 bar; with TF32 they leave it, so the pins stay."""
    from molar_tpu_torch.ff import espaloma

    card = espaloma.load_gnn(cuda_device)
    inputs = _espaloma_inputs()
    want = [espaloma.equilibrate(*espaloma.run_gnn(f, a)) for f, a in inputs]

    def error():
        worst = 0.0
        for (f, a), w in zip(inputs, want):
            e, s = card(torch.from_numpy(f).to(cuda_device), torch.from_numpy(a).to(cuda_device))
            q = espaloma.equilibrate(e.cpu().numpy(), s.cpu().numpy())
            worst = max(worst, float(np.abs(q - w).max()))
        return worst

    pinned = error()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = error()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    print(f"max abs charge error vs the numpy walk: pinned {pinned:.3e}, TF32 {tf32:.3e}")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert pinned <= 1e-4 < tf32


def _mesh_headline(tmp_path, n=4000, npro=400, side=3.42, frames=7):
    from molar_tpu_torch import headline

    box = PeriodicBox(np.diag([side] * 3))
    coords0, masses = headline.make_system(n, npro, box.matrix)
    path = str(tmp_path / "t.xtc")
    headline.write_trajectory(path, coords0, box.matrix, frames)
    pidx = np.arange(npro)
    dims = neighbor.grid_dims_for(box, 0.5)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    return path, coords0[pidx], masses[pidx], pidx, box, dims, caps0


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_mesh_runner_on_card_matches_the_unsharded_window(cuda_device, tmp_path, n_shards):
    """A window of 7 frames through a runner whose shards all sit on this
    card (ragged for 2 and 3 shards): counts and checksums equal the
    unsharded window's, RMSD within 1e-6, and each shard launches both
    ghost kernels once."""
    from molar_tpu_torch import convert, headline
    from molar_tpu_torch.parallel import MeshWindowRunner
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    path, ref, masses, pidx, box, dims, caps0 = _mesh_headline(tmp_path)
    model = convert.from_numpy(ref, masses, pidx, box.matrix, 0.5, headline.caps_for(*caps0, 1),
                               dims, cuda_device)
    (item,) = TrajectoryReader([path]).iter_windows(7, quantized=True)
    want = model(*convert.transport_to_torch(item, cuda_device))
    runner = MeshWindowRunner([cuda_device] * n_shards)
    before = neighbor_ghost.cell_bins.launches, neighbor_ghost.within_ghost.launches
    got = runner.call(model, *item[:3])
    torch.cuda.synchronize()
    assert neighbor_ghost.cell_bins.launches == before[0] + n_shards
    assert neighbor_ghost.within_ghost.launches == before[1] + n_shards
    assert not want[3].any() and all(g.device == cuda_device for g in got)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert float((got[0] - want[0]).abs().max()) <= 1e-6
    # and the stream, with the retry, through the runner
    ids, rmsd, count, check, _ = headline.run(path, ref, masses, pidx, box, 0.5, dims, caps0, 4,
                                              cuda_device)
    mids, mrmsd, mcount, mcheck, _ = headline.run(path, ref, masses, pidx, box, 0.5, dims, caps0,
                                                  4, cuda_device, mesh=runner)
    assert np.array_equal(ids, mids) and np.array_equal(count, mcount)
    assert np.array_equal(check, mcheck) and np.abs(rmsd - mrmsd).max() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("triclinic", [False, True])
def test_grid_contact_window_on_card_matches_the_frame_loop(cuda_device, triclinic):
    """The grid contact list of a window at once against its frame loop on
    the card (the same pairs in the same order, distances, counts and
    flags) and against the CPU as pair sets, with host syncs made errors."""
    rng = np.random.default_rng(0)
    m = (np.array([[4.0, 0, 2.0], [0, 4.0, 2.0], [0, 0, 2.828]], np.float32) if triclinic
         else np.diag([4.0, 4.4, 4.8]).astype(np.float32))
    box = PeriodicBox(m)
    b, n = 6, 3000
    coords = torch.as_tensor((rng.uniform(-0.1, 1.1, (b, n, 3)) @ m.T.astype(np.float64))
                             .astype(np.float32))
    boxes = torch.as_tensor(np.repeat(m[None], b, 0))
    invs = torch.as_tensor(np.repeat(box.inv[None], b, 0))
    corr = torch.as_tensor(box.padded_corrections()) if triclinic else None
    src, tgt = torch.arange(0, 2100), torch.arange(2100, 3000)
    dims = neighbor.grid_dims_for(box, 0.4)
    args = (coords, src, tgt, 0.4, boxes, invs, corr, dims, 16, 1 << 14)
    dev_args = tuple(a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = neighbor.contact_pairs_window(*dev_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    loop = neighbor.contact_pairs_window(*dev_args, plain=True)
    cpu = neighbor.contact_pairs_window(*args)
    assert all(torch.equal(a, c) for a, c in zip(got, loop))
    assert not got[3].any() and torch.equal(got[2].cpu(), cpu[2])
    for f in range(b):
        gp, cp = got[0][f].cpu().numpy(), cpu[0][f].numpy()
        assert set(map(tuple, gp[gp[:, 0] >= 0].tolist())) == set(map(tuple,
                                                                       cp[cp[:, 0] >= 0].tolist()))
