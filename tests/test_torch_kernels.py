"""The port's CUDA kernels against their plain twins on the shared scenes.

This file imports no JAX, so it runs where the card is. The ``cuda``-marked
tests launch ``csrc/within_ghost.cu`` (random scenes, cutoff ties, tiny and
collapsed periodic grids, partial PBC, a small solvated protein) and
``csrc/within_rows.cu`` (the orthorhombic full-PBC scenes plus the row
kernel's own, one with a 2-cell axis), and require each mask and overflow
flag to equal the plain twin's exactly; they also hold the triclinic
correction path (plain torch) on the card against the CPU on a rhombic
dodecahedron, with host syncs made errors. They skip without a card. On
the card, without the repository's conftest (which imports JAX):

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

from torch_scenes import ROW_SCENES, SCENES, TIE_MEMBERS, dodeca_scene, scene


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


def test_kernel_wrapper_runs_plain_twin_on_cpu_tensors():
    g = torch.Generator().manual_seed(4)
    src = [torch.rand(8, 4, generator=g) for _ in range(3)]
    ghost = [torch.rand(4, 4, 4, 4, generator=g) for _ in range(3)]
    before = neighbor_ghost.within_ghost.launches
    got = neighbor_ghost.within_ghost(src, ghost, (2, 2, 2), 4, 4, 0.25)
    want = neighbor_ghost._ghost_stencil(src, ghost, (2, 2, 2), 4, 4, 0.25)
    assert neighbor_ghost.within_ghost.launches == before
    assert got.any() and torch.equal(got, want)


def test_kernel_wrapper_refuses_other_devices():
    src = [torch.zeros(8, 4, device="meta") for _ in range(3)]
    ghost = [torch.zeros(4, 4, 4, 4, device="meta") for _ in range(3)]
    before = neighbor_ghost.within_ghost.launches
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_ghost.within_ghost(src, ghost, (2, 2, 2), 4, 4, 0.25)
    assert neighbor_ghost.within_ghost.launches == before


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


def test_rows_wrapper_runs_plain_twin_on_cpu_tensors():
    g = torch.Generator().manual_seed(4)
    src = [torch.rand(4, 2, 4, generator=g) for _ in range(3)] + [torch.ones(4, 2, 4)]
    tgt = [torch.rand(4, 2, 4, generator=g) for _ in range(3)] + [torch.zeros(4, 2, 4)]
    lengths = torch.tensor([2.0, 2.0, 2.0])
    before = neighbor_rows.within_rows.launches
    got = neighbor_rows.within_rows(src, tgt, lengths, (2, 2, 2), 4, 4, 0.04)
    want = neighbor_rows._rows_stencil(src, tgt, lengths, (2, 2, 2), 4, 4, 0.04)
    assert neighbor_rows.within_rows.launches == before
    assert got.any() and not got.all() and torch.equal(got, want)


def test_rows_wrapper_refuses_other_devices():
    src = [torch.zeros(4, 2, 4, device="meta") for _ in range(4)]
    lengths = torch.ones(3, device="meta")
    before = neighbor_rows.within_rows.launches
    with pytest.raises(ValueError, match="CUDA"):
        neighbor_rows.within_rows(src, src, lengths, (2, 2, 2), 4, 4, 0.25)
    assert neighbor_rows.within_rows.launches == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_plain_on_card(cuda_device, name):
    before = neighbor_ghost.within_ghost.launches
    got, ofl = _search(name, cuda_device)
    torch.cuda.synchronize()
    assert neighbor_ghost.within_ghost.launches == before + 1
    want, wofl = _search(name, "cpu")
    assert ofl is wofl is False
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,tgt_cap", [(2, 64), (64, 1)])
def test_kernel_overflow_flag_on_card(cuda_device, cap, tgt_cap):
    _, ofl = _search("random19", cuda_device, cap=cap, tgt_cap=tgt_cap)
    _, wofl = _search("random19", "cpu", cap=cap, tgt_cap=tgt_cap)
    assert ofl is wofl is True


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_planes(cuda_device):
    src = [torch.zeros(8, 4, device=cuda_device) for _ in range(3)]
    ghost = [torch.zeros(4, 4, 4, 4, device=cuda_device) for _ in range(3)]
    with pytest.raises(ValueError, match="shape"):
        neighbor_ghost.within_ghost(src, ghost, (2, 2, 2), 8, 4, 0.25)
    with pytest.raises(TypeError, match="float32"):
        neighbor_ghost.within_ghost([s.double() for s in src], ghost, (2, 2, 2), 4, 4, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_ghost.within_ghost(
            [torch.zeros(4, 8, device=cuda_device).t() for _ in range(3)], ghost,
            (2, 2, 2), 4, 4, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROW_SCENES)
def test_rows_kernel_matches_plain_on_card(cuda_device, name):
    before = neighbor_rows.within_rows.launches
    got, ofl = _rows_search(name, cuda_device)
    torch.cuda.synchronize()
    assert neighbor_rows.within_rows.launches == before + 1
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
def test_rows_kernel_wrapper_rejects_bad_planes(cuda_device):
    src = [torch.zeros(4, 2, 4, device=cuda_device) for _ in range(4)]
    lengths = torch.ones(3, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        neighbor_rows.within_rows(src, src, lengths, (2, 2, 2), 8, 4, 0.25)
    with pytest.raises(ValueError, match="shape"):
        neighbor_rows.within_rows(src, src, lengths[:2], (2, 2, 2), 4, 4, 0.25)
    with pytest.raises(TypeError, match="float32"):
        neighbor_rows.within_rows([s.double() for s in src], src, lengths, (2, 2, 2), 4, 4, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_rows.within_rows(
            [torch.zeros(4, 4, 2, device=cuda_device).transpose(1, 2) for _ in range(4)], src,
            lengths, (2, 2, 2), 4, 4, 0.25)


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
