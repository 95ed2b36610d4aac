"""The ghost-slab kernel against its plain twin on the shared scenes.

This file imports no JAX, so it runs where the card is. The ``cuda``-marked
tests launch ``csrc/within_ghost.cu`` on random scenes, cutoff ties, tiny
and collapsed periodic grids, partial PBC and a small solvated protein, and
require its mask and overflow flag to equal the plain twin's exactly; they
skip without a card. On the card, without the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The CPU tests here check what the plain twin must give on the tie scenes,
that the kernel wrapper takes the plain twin only for CPU tensors (without
counting a launch), and that it refuses any other non-CUDA device.
"""

import numpy as np
import pytest
import torch

from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops import neighbor, neighbor_ghost

from torch_scenes import SCENES, TIE_MEMBERS, scene


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
