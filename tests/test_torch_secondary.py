"""DSSP, dss and host SASA of the port against the JAX package's, on the CPU.

The golden files of the reference are not in the repo, so synthetic chains
stand in for them: an ideal alpha-helix, beta-strand and beta-hairpin built
by NeRF (``tests/torch_structures.py``), and three noisy copies of each
(N(0, 0.02 nm) on every atom). ``Sel.dssp`` (the ``gmx`` and ``vanilla``
flavours) and ``Sel.dss`` strings must equal the JAX package's, and the
helix's interior must read ``H``. ``Sel.sasa`` must equal the JAX package's
host Lee-Richards, and the port's ``ops.sasa_lr.sasa`` on the CPU within
1e-4 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.ops import dss as ref_dss
from molar_tpu.ops import dssp as ref_dssp
from molar_tpu_torch.config import set_default_device
import molar_tpu_torch as mt
from molar_tpu_torch.ops import dss, dssp, sasa_lr

from torch_structures import CHAINS, scene_pdb

SEEDS = (0, 1, 2, 3)  # 0: ideal, the others noisy
NOISE = 0.02
SASA_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (the test workers share the cores),
    and the CPU as the device of ``device=None`` (the port's entry points
    take the card unless asked for the CPU); both restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = set_default_device("cpu")
    yield
    set_default_device(old)
    torch.set_num_threads(n)


def _pair(tmp_path, chain, seed, **kw):
    path = tmp_path / f"{chain}_{seed}.pdb"
    path.write_text(scene_pdb(seed=seed, chains=(chain,), noise=NOISE if seed else 0.0, **kw))
    return molar_tpu.System.from_file(str(path)), mt.System.from_file(str(path))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_dssp_and_dss_equal_the_reference(tmp_path, chain, seed):
    ref, mine = _pair(tmp_path, chain, seed, n_water=0, n_ligand=0)
    r, m = ref("protein"), mine("protein")
    for flavor in ("gmx", "vanilla"):
        assert m.dssp(flavor) == r.dssp(flavor)
    assert m.dss() == r.dss()
    for algo in ("dssp", "dssp_gmx", "dss"):
        assert m.ss_compute(algo) == r.ss_compute(algo)
    got, want = dssp.compute_dssp(m, "gmx"), ref_dssp.compute_dssp(r, "gmx")
    assert got.ss_string() == want.ss_string()
    assert dss.compute_dss(m).ss_string() == ref_dss.compute_dss(r).ss_string()
    if chain == "helix" and seed == 0:
        n = len(CHAINS["helix"])
        assert m.dssp("gmx")[1:-1] == "H" * (n - 2) == m.dss()[1:-1]
    if chain == "hairpin":
        assert "E" in r.dssp("gmx")
    with pytest.raises(ValueError):
        m.ss_compute("stride")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_sasa_equals_the_reference_and_the_card_s_function(tmp_path, chain, seed):
    ref, mine = _pair(tmp_path, chain, seed, n_water=6, n_ligand=1)
    text = "not resname SOL" if seed % 2 else "all"
    r, m = ref(text).sasa(), mine(text).sasa()
    np.testing.assert_array_equal(m.areas(), r.areas())
    assert m.total_area() == r.total_area()
    sel = mine(text)
    radii = (mine.topology.vdw()[sel.indices] + 0.14).astype(np.float32)
    nbr, overflow = sasa_lr.neighbor_lists(sel.coords, radii, cap=64)
    assert not overflow
    got = sasa_lr.sasa(torch.from_numpy(sel.coords), torch.from_numpy(radii),
                       torch.from_numpy(nbr), 64).numpy()
    scale = np.maximum(np.abs(m.areas()), 1e-3)
    assert np.max(np.abs(got - m.areas()) / scale) < SASA_RTOL
    assert abs(got.sum() - m.total_area()) < SASA_RTOL * m.total_area()


def test_sasa_volume_equals_the_reference(tmp_path):
    ref, mine = _pair(tmp_path, "hairpin", 1, n_water=0, n_ligand=0)
    r = ref("protein").sasa(probe=0.12, with_volume=True, n_slices=32)
    m = mine("protein").sasa(probe=0.12, with_volume=True, n_slices=32)
    assert m.total_volume() == r.total_volume() > 0
    np.testing.assert_array_equal(m.areas(), r.areas())
