"""espaloma charges of the port against the JAX package's, on the CPU.

The port's parsed model equals the JAX package's graph (ops, names,
initializers bit for bit); its SSSR rings and its featurisation equal the
reference's exactly on small molecules chosen for the branches of the
aromaticity and hybridisation rules and on 20 molecules of
``chip_smoke.py``'s seeded corpus; its torch forward on the CPU agrees with
the reference's numpy walk and with its jitted JAX forward (JAX on the
CPU) within the bar of ``tests/test_espaloma.py`` (e and s 1e-5, charges
1e-4). Pad rows change no real row; the backend switch mirrors the
reference's; ``apply_charges`` on the port's ``System`` equals the JAX one
on a system with the same bonds and no bond-order or formal-charge column,
and within 1e-5 on nitrobenzene and acetate with both columns (a System, a
Sel, indices); weights carried across from the JAX package's graph equal the port's own.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.atom import Atom
from molar_tpu.core.topology import Topology as RefTopology
from molar_tpu.ff import espaloma as ref
from molar_tpu.ops.perception import sssr_rings as ref_sssr_rings
from molar_tpu_torch import convert
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.core.system import System
from molar_tpu_torch.ff import espaloma
from molar_tpu_torch.ops.perception import sssr_rings

from torch_molecules import RINGS, ligand_corpus, with_hydrogens

# The bar of tests/test_espaloma.py::test_gnn_jax_parity.
ES_TOL, Q_TOL = 1e-5, 1e-4


def _ring(name):
    z, fc, bonds = RINGS[name]
    return with_hydrogens(z, bonds, fc)


def _named():
    # Azulene: a 7-ring fused to a 5-ring; neither ring is a Hueckel ring
    # alone (7 and 5 pi electrons), the fused system (10) is.
    azulene = with_hydrogens([6] * 10, [(0, 1, 1), (1, 2, 2), (2, 3, 1), (3, 4, 2), (4, 5, 1),
                                        (5, 6, 2), (6, 0, 1), (6, 7, 1), (7, 8, 2), (8, 9, 1),
                                        (9, 0, 2)])
    nitrobenzene = with_hydrogens([6] * 6 + [7, 8, 8],
                                  RINGS["benzene"][2] + [(0, 6, 1), (6, 7, 2), (6, 8, 1)],
                                  [0] * 6 + [1, 0, -1])
    return {
        **{name: _ring(name) for name in ("benzene", "pyridine", "pyrrole", "furan",
                                          "naphthalene", "cyclohexanone")},
        "azulene": azulene,
        "acetonitrile": with_hydrogens([6, 6, 7], [(0, 1, 1), (1, 2, 3)]),
        "nitrobenzene": nitrobenzene,
        "acetate": with_hydrogens([6, 6, 8, 8], [(0, 1, 1), (1, 2, 2), (1, 3, 1)], [0, 0, 0, -1]),
        # A lone sodium ion: its element is outside the mass table.
        "sodium": (np.array([11]), np.array([1]), []),
    }


MOLECULES = {**_named(), **{f"corpus{k}": m for k, m in enumerate(ligand_corpus(20))}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops; on a pool of threads they crawl when the test
    workers share the cores. One thread for this module, restored after
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gnn():
    return espaloma.load_gnn("cpu")


def test_graph_equals_the_reference():
    mine, theirs = espaloma._graph(), ref._graph()
    assert mine.inputs == theirs.inputs == ["features", "adjacency_mean"]
    assert mine.outputs == theirs.outputs
    assert len(mine.nodes) == len(theirs.nodes) == 27
    for a, b in zip(mine.nodes, theirs.nodes):
        assert (a.op_type, a.name, a.inputs, a.outputs) == (b.op_type, b.name, b.inputs, b.outputs)
        assert {k: (v.i, v.ints) for k, v in a.attrs.items()} == \
            {k: (v.i, v.ints) for k, v in b.attrs.items()}
    assert [n.op_type for n in mine.nodes].count("MatMul") == 14
    assert sorted(mine.initializers) == sorted(theirs.initializers)
    for k, v in mine.initializers.items():
        w = theirs.initializers[k]
        assert v.dtype == w.dtype and v.shape == w.shape and v.tobytes() == w.tobytes(), k


def _pairs(bonds):
    return np.asarray([(i, j) for i, j, _ in bonds]).reshape(-1, 2)


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_sssr_rings_equal_the_reference(name):
    z, _, bonds = MOLECULES[name]
    assert sssr_rings(len(z), _pairs(bonds)) == ref_sssr_rings(len(z), _pairs(bonds))


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_featurize_equals_the_reference(name):
    z, fc, bonds = MOLECULES[name]
    feat, adj = espaloma.featurize(z, fc, bonds)
    want_feat, want_adj = ref.featurize(z, fc, bonds)
    assert feat.dtype == want_feat.dtype and adj.dtype == want_adj.dtype
    assert np.array_equal(feat, want_feat) and np.array_equal(adj, want_adj)


def test_the_molecules_reach_the_rule_branches():
    """The named molecules exercise what they are named for."""
    def aromatic(name):
        return espaloma.featurize(*MOLECULES[name])[0][:, 103].astype(bool)

    assert aromatic("azulene")[:10].all() and aromatic("naphthalene")[:10].all()
    assert aromatic("pyrrole")[:5].all() and aromatic("furan")[:5].all()
    assert not aromatic("cyclohexanone").any() and aromatic("nitrobenzene")[:6].all()
    feat = espaloma.featurize(*MOLECULES["acetonitrile"])[0]
    assert feat[1, 111] == 1.0  # the nitrile carbon is SP
    assert espaloma.featurize(*MOLECULES["sodium"])[0][0, 104] == 0.0
    charged = [k for k, (_, fc, _) in MOLECULES.items() if k.startswith("corpus") and fc.any()]
    assert charged


@pytest.mark.parametrize("name", sorted(MOLECULES))
def test_torch_forward_matches_numpy_and_jax(gnn, name):
    feat, adj = espaloma.featurize(*MOLECULES[name])
    e, s = gnn(torch.from_numpy(feat), torch.from_numpy(adj))
    e, s = e.numpy(), s.numpy()
    q = espaloma.equilibrate(e, s)
    for want_e, want_s in (ref.run_gnn(feat, adj), ref.run_gnn_jax(feat, adj)):
        assert np.abs(e - want_e).max() <= ES_TOL and np.abs(s - want_s).max() <= ES_TOL
        assert np.abs(q - ref.equilibrate(want_e, want_s)).max() <= Q_TOL
    assert abs(q.sum()) < Q_TOL


@pytest.mark.parametrize("name", ["benzene", "corpus3", "corpus7"])
def test_pad_rows_change_no_real_row(gnn, name):
    """Zero features and zero adjacency in both directions on 16-multiple
    padding, as ``run_gnn_jax`` pads: a real row's products read no pad
    column."""
    feat, adj = espaloma.featurize(*MOLECULES[name])
    n = len(feat)
    n_pad = -(-n // 16) * 16 + 16
    f = np.zeros((n_pad, 116), np.float32)
    f[:n] = feat
    a = np.zeros((n_pad, n_pad), np.float32)
    a[:n, :n] = adj
    e, s = gnn(torch.from_numpy(feat), torch.from_numpy(adj))
    pe, ps = gnn(torch.from_numpy(f), torch.from_numpy(a))
    assert pe.shape == (n_pad,)
    assert torch.allclose(pe[:n], e, rtol=0, atol=1e-6)
    assert torch.allclose(ps[:n], s, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["numpy", "torch", "auto", "jax"])
def test_backend_switch_mirrors_the_reference(monkeypatch, mode):
    monkeypatch.setenv("MOLAR_ESPALOMA_BACKEND", mode)
    assert espaloma._use_torch() is ref._use_jax()
    assert espaloma._use_torch() is (mode != "numpy")


def test_charges_take_the_card_unless_asked(monkeypatch):
    z, fc, bonds = MOLECULES["pyridine"]
    want = ref.equilibrate(*ref.run_gnn(*ref.featurize(z, fc, bonds)))
    monkeypatch.setenv("MOLAR_ESPALOMA_BACKEND", "auto")
    assert np.abs(espaloma.espaloma_charges(z, fc, bonds, device="cpu") - want).max() <= Q_TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            espaloma.espaloma_charges(z, fc, bonds)
    monkeypatch.setenv("MOLAR_ESPALOMA_BACKEND", "numpy")
    assert np.array_equal(espaloma.espaloma_charges(z, fc, bonds), want)


def _two_molecules():
    """A corpus ligand (resname LIG) and acetate (resname ACT), bonded as
    written, in a 3 nm box -> (JAX System, port System)."""
    mols = [MOLECULES["corpus5"], MOLECULES["acetate"]]
    z = np.concatenate([m[0] for m in mols])
    bonds, off = [], 0
    for m in mols:
        bonds += [(i + off, j + off) for i, j, _ in m[2]]
        off += len(m[0])
    n = len(z)
    resname = ["LIG"] * len(mols[0][0]) + ["ACT"] * len(mols[1][0])
    resid = np.where(np.arange(n) < len(mols[0][0]), 1, 2)
    coords = np.random.default_rng(3).uniform(0, 3, (n, 3)).astype(np.float32)
    atoms = [Atom(name=f"A{k}", resname=resname[k], resid=int(resid[k]),
                  atomic_number=int(z[k]), mass=1.0) for k in range(n)]
    top = RefTopology.from_atoms(atoms)
    top.assign_resindex()
    top.set_bonds(bonds)
    box = np.diag([3.0] * 3).astype(np.float32)
    theirs = molar_tpu.System(top, molar_tpu.core.state.State(
        coords=coords, box=molar_tpu.PeriodicBox(box)))
    mine_top = convert.topology_from_numpy(
        top.names(), top.resnames(), top.resid, top.resindex, top.chain, top.mass, top.charge,
        top.occupancy, top.bfactor, top.atomic_number, top.bonds)
    return theirs, System(mine_top, State(coords=coords, box=PeriodicBox(box)))


@pytest.mark.parametrize("text", [None, "resname LIG"])
def test_apply_charges_equals_the_reference(text):
    theirs, mine = _two_molecules()
    assert theirs.topology.bond_orders is None and theirs.topology.formal_charge is None
    want = ref.apply_charges(theirs if text is None else theirs(text))
    idx = None if text is None else mine.select_indices(text)
    got = espaloma.apply_charges(mine, idx, device="cpu")
    assert got.shape == want.shape and np.abs(got - want).max() <= Q_TOL
    assert np.abs(mine.topology.charge - theirs.topology.charge).max() <= Q_TOL
    if text is not None:
        assert not mine.topology.charge[~np.isin(np.arange(mine.n_atoms), idx)].any()


def test_weights_carried_across_equal_the_port_s_own(gnn):
    carried = convert.espaloma_from_numpy(ref._graph().initializers, "cpu")
    mine, theirs = dict(gnn.named_buffers()), dict(carried.named_buffers())
    assert sorted(mine) == sorted(theirs) == sorted(ref._graph().initializers)
    for k, v in mine.items():
        assert v.dtype == theirs[k].dtype and torch.equal(v, theirs[k]), k
    assert mine["permute"].shape == (116, 128) and mine["val_3"].dtype == torch.int64
    feat, adj = espaloma.featurize(*MOLECULES["corpus0"])
    args = torch.from_numpy(feat), torch.from_numpy(adj)
    assert all(torch.equal(a, b) for a, b in zip(gnn(*args), carried(*args)))


def _charged_pair():
    """Nitrobenzene (an aromatic ring, an N=O double bond, N+ and O-) and
    acetate (C=O, O-), with bond-order and formal-charge columns ->
    (JAX System, port System)."""
    mols = [("NBZ", MOLECULES["nitrobenzene"]), ("ACT", MOLECULES["acetate"])]
    atoms, bonds, orders, off = [], [], [], 0
    for resid, (resname, (z, fc, bs)) in enumerate(mols, start=1):
        atoms += [Atom(name=f"A{k}", resname=resname, resid=resid, atomic_number=int(z[k]),
                       mass=1.0, formal_charge=int(fc[k])) for k in range(len(z))]
        bonds += [(i + off, j + off) for i, j, _ in bs]
        orders += [o for *_, o in bs]
        off += len(z)
    top = RefTopology.from_atoms(atoms)
    top.assign_resindex()
    top.set_bonds(bonds, orders)
    coords = np.random.default_rng(4).uniform(0, 3, (off, 3)).astype(np.float32)
    theirs = molar_tpu.System(top, molar_tpu.core.state.State(coords=coords))
    mine_top = convert.topology_from_numpy(
        top.names(), top.resnames(), top.resid, top.resindex, top.chain, top.mass, top.charge,
        top.occupancy, top.bfactor, top.atomic_number, top.bonds, top.bond_orders,
        top.formal_charge)
    return theirs, System(mine_top, State(coords=coords))


@pytest.mark.parametrize("what", ["system", "sel", "indices"])
def test_apply_charges_reads_bond_orders_and_formal_charges(what):
    theirs, mine = _charged_pair()
    assert (mine.topology.bond_orders == 2).any() and mine.topology.formal_charge.min() == -1
    if what == "system":
        want, got = ref.apply_charges(theirs), mine.apply_charges(device="cpu")
    elif what == "sel":
        want = ref.apply_charges(theirs("resname NBZ"))
        got = espaloma.apply_charges(mine("resname NBZ"), device="cpu")
    else:
        want = ref.apply_charges(theirs("resname NBZ"))
        got = espaloma.apply_charges(mine, mine.select_indices("resname NBZ"), device="cpu")
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    np.testing.assert_allclose(mine.topology.charge, theirs.topology.charge, rtol=0, atol=1e-5)
    # Read as all-single and neutral (the columns dropped), the charges move.
    single = espaloma.espaloma_charges(mine.topology.atomic_number[:len(got)],
                                       np.zeros(len(got), int),
                                       [(int(a), int(b), 1) for a, b in mine.topology.bonds
                                        if b < len(got)], device="cpu")
    assert np.abs(single - got).max() > 1e-3
    with pytest.raises(ValueError, match="indices"):
        espaloma.apply_charges(mine("resname ACT"), [0], device="cpu")
