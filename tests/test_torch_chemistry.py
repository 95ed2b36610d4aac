"""The port's chemistry (``ops/perception``, ``ff/gaff``, ``ops/surface``)
against the JAX package's, on the CPU.

Molecules are ``tests/torch_molecules.py``'s ``ligand_corpus`` (seeded
drug-like ligands written in a Kekule form) and ``peptide``, each built as
a ``System`` in both packages from the same columns. ``perceive`` gives the
same rings, aromatic flags, total charge, atom flags and bond orders;
``implicit_hydrogens`` the same counts, on the molecules, on their heavy
atoms alone and after perception; ``target_valence`` the same table.
``apply_ff`` with ``gaff`` and ``gaff2`` writes the same types into
``type_name``, through ``System.apply_ff`` and a ``Sel``, and raises the
same ``FFError``s (aromatic input, a selection that cuts a bond); the DEF
parser gives the same rules and errors. Surfaces: ``sas_mesh`` /
``ses_mesh`` vertices within 1e-9 nm and triangles equal, their area and
volume within 1e-9 relative, ``dedupe_mesh`` and ``write_obj`` byte-equal,
through ``Sel.sas_mesh`` / ``Sel.ses_mesh`` too.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.atom import Atom as RefAtom
from molar_tpu.core.state import State as RefState
from molar_tpu.core.topology import Topology as RefTopology
from molar_tpu.ff import gaff as ref_gaff
from molar_tpu.ops import perception as ref_perception
from molar_tpu.ops import surface as ref_surface

from molar_tpu_torch.config import set_default_device
import molar_tpu_torch as mt
from molar_tpu_torch.ff import FFError, apply_ff, gaff, gaff_types, parse_def
from molar_tpu_torch.ops import perception, surface

from test_torch_system import same_topology
from torch_molecules import ligand_corpus, molecule_system, peptide
from torch_structures import scene_pdb

N_LIGANDS = 24


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


MOLECULES = ligand_corpus(N_LIGANDS, seed=5) + [peptide(4)]


def pair(k, heavy_only=False):
    """(JAX system, port system) of molecule ``k`` from the same columns."""
    z, fc, bonds = MOLECULES[k]
    mine = molecule_system(z, fc, bonds, seed=k)
    if heavy_only:
        keep = np.flatnonzero(np.asarray(z) != 1)
        mine = mine.select(keep).to_system()
    top = mine.topology
    atoms = [RefAtom(name=str(n), resname="MOL", resid=1, atomic_number=int(top.atomic_number[i]),
                     mass=float(top.mass[i]), chain="A", formal_charge=int(top.formal_charge[i]))
             for i, n in enumerate(top.names())]
    rtop = RefTopology.from_atoms(atoms)
    rtop.set_bonds(top.bonds, top.bond_orders)
    rtop.resindex = top.resindex.copy()
    ref = molar_tpu.System(rtop, RefState(coords=mine.state.coords.copy()))
    same_topology(ref.topology, mine.topology)
    return ref, mine


@pytest.mark.parametrize("k", range(len(MOLECULES)))
def test_perceive_equals_the_reference(k):
    ref, mine = pair(k)
    want, got = ref.perceive(), mine.perceive()
    assert got.rings == want.rings and got.aromatic == want.aromatic
    assert got.total_charge == want.total_charge
    assert got.aromatic_rings() == want.aromatic_rings()
    same_topology(ref.topology, mine.topology)  # flags and bond orders written alike
    # idempotent, as the reference
    again = perception.perceive(mine.topology)
    assert again.rings == got.rings and again.aromatic == got.aromatic
    np.testing.assert_array_equal(
        perception.implicit_hydrogens(mine.topology),
        ref_perception.implicit_hydrogens(ref.topology))


@pytest.mark.parametrize("k", range(0, len(MOLECULES), 3))
def test_implicit_hydrogens_equal_the_reference(k):
    for heavy in (False, True):
        ref, mine = pair(k, heavy_only=heavy)
        got = perception.implicit_hydrogens(mine.topology)
        np.testing.assert_array_equal(got, ref_perception.implicit_hydrogens(ref.topology))
        assert (got.sum() > 0) == heavy
    z = MOLECULES[k][0]
    rings = perception.rings_with_aromaticity(len(z), mine.topology.bonds,
                                              list(mine.topology.bond_orders), np.asarray(z))
    assert rings == ref_perception.rings_with_aromaticity(
        len(z), ref.topology.bonds, list(ref.topology.bond_orders), np.asarray(z))


def test_target_valence_equals_the_reference():
    for z in (1, 5, 6, 7, 8, 9, 15, 16, 17, 26, 35, 53):
        for fc in range(-2, 3):
            assert perception.target_valence(z, fc) == ref_perception.target_valence(z, fc)


@pytest.mark.parametrize("ff", ["gaff", "gaff2"])
def test_gaff_types_equal_the_reference(ff):
    for k in range(len(MOLECULES)):
        ref, mine = pair(k)
        want = ref_gaff.apply_ff(ref, ff)
        got = mine.apply_ff(ff)
        assert got == want, k
        assert list(mine.topology.type_names()) == list(ref.topology.type_names())
        z, _, bonds = MOLECULES[k]
        assert gaff_types(z, bonds, ff) == ref_gaff.gaff_types(z, bonds, ff)
    # a Sel of one molecule of a two-molecule system types only its atoms
    a, b = (molecule_system(*MOLECULES[k], seed=k) for k in (0, 1))
    a.append_system(b)
    sel = a.select(np.arange(len(MOLECULES[0][0])))
    assert apply_ff(sel, ff) == ref_gaff.apply_ff(pair(0)[0], ff)
    assert len(set(a.topology.type_names()[len(sel):])) == 1  # the rest unset


def test_gaff_errors_are_the_reference_s():
    ref, mine = pair(0)
    ref.perceive()
    mine.perceive()
    with pytest.raises(ref_gaff.FFError) as want:
        ref.apply_ff()
    with pytest.raises(FFError) as got:
        mine.apply_ff()
    assert str(got.value) == str(want.value) and "aromatic" in str(got.value)
    ref, mine = pair(1)
    with pytest.raises(ref_gaff.FFError) as want:
        ref_gaff.apply_ff(ref.select(np.arange(3)))
    with pytest.raises(FFError) as got:
        apply_ff(mine.select(np.arange(3)))
    assert str(got.value) == str(want.value) and "bond-complete" in str(got.value)


DEF = """\
WILDATOM XX C N O S P
WILDATOM XA O S
ATD  cx   *   6   4   *   *   [RG3]   &
ATD  c    *   6   3   *   *   *   (O1)   &
ATD  ca   *   6   3   *   *   [AR1.AR2.AR3]   &
ATD  c2   *   6   3   *   *   [sb'',db]   &
ATD  c3   *   6   4   &
ATD  n4   *   7   4   &
ATD  hn   *   1   1   *   *   *   (N)   &
ATD  h1   *   1   1   *   1   *   (C(XA))   &
ATD  ho   *   1   1   *   *   *   (O)   &
"""


def test_parse_def_equals_the_reference():
    got, want = parse_def(DEF), ref_gaff.parse_def(DEF)
    assert json.dumps(got) == json.dumps(want) and len(got[0]) == 9
    for bad in ("WILDATOM XX Qq\n", "ATD  c  *  6  3  *  *  [QQ1]  &\n"):
        with pytest.raises(ref_gaff.FFError) as w:
            ref_gaff.parse_def(bad)
        with pytest.raises(FFError) as g:
            parse_def(bad)
        assert str(g.value) == str(w.value)
    assert gaff.TABLE_DIR.is_dir() and {p.name for p in gaff.TABLE_DIR.glob("gaff*_rules.json")} \
        == {"gaff_rules.json", "gaff2_rules.json"}


SURFACE_SCENES = {
    "one": (np.array([[1.0, 1.0, 1.0]]), np.array([0.19])),
    "fused": (np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.1, 0.25, 0.05]]),
              np.array([0.19, 0.17, 0.15])),
    "cluster": (np.random.default_rng(4).uniform(0, 0.8, (12, 3)),
                np.random.default_rng(5).uniform(0.12, 0.2, 12)),
}


@pytest.mark.parametrize("kind", ["sas", "ses"])
@pytest.mark.parametrize("scene", sorted(SURFACE_SCENES))
def test_meshes_equal_the_reference(scene, kind, tmp_path):
    coords, radii = SURFACE_SCENES[scene]
    fn, ref_fn = getattr(surface, f"{kind}_mesh"), getattr(ref_surface, f"{kind}_mesh")
    v, t = fn(coords, radii, probe=0.14, spacing=0.05)
    rv, rt = ref_fn(coords, radii, probe=0.14, spacing=0.05)
    assert v.shape == rv.shape and len(t) > 0
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(t, rt)
    for f in ("mesh_area", "mesh_volume"):
        assert getattr(surface, f)(v, t) == pytest.approx(getattr(ref_surface, f)(rv, rt),
                                                          rel=1e-9)
    dv, dt = surface.dedupe_mesh(v, t)
    rdv, rdt = ref_surface.dedupe_mesh(rv, rt)
    np.testing.assert_allclose(dv, rdv, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(dt, rdt)
    surface.write_obj(str(tmp_path / "a.obj"), dv, dt)
    ref_surface.write_obj(str(tmp_path / "b.obj"), rdv, rdt)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()


def test_marching_tetrahedra_equals_the_reference():
    rng = np.random.default_rng(9)
    vals = rng.normal(0, 1, (6, 5, 7))
    for field in (vals, np.ones((4, 4, 4)), -np.ones((4, 4, 4))):
        v, t = surface.marching_tetrahedra(field, np.array([0.1, -0.2, 0.3]), 0.07)
        rv, rt = ref_surface.marching_tetrahedra(field, np.array([0.1, -0.2, 0.3]), 0.07)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(t, rt)


def test_sel_meshes_equal_the_reference(tmp_path):
    path = tmp_path / "scene.pdb"
    path.write_text(scene_pdb(seed=2, n_water=4, n_ligand=1))
    ref, mine = molar_tpu.System.from_file(str(path)), mt.System.from_file(str(path))
    for kind in ("sas_mesh", "ses_mesh"):
        v, t = getattr(mine("resname LIG"), kind)(spacing=0.06)
        rv, rt = getattr(ref("resname LIG"), kind)(spacing=0.06)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(t, rt)
        assert surface.mesh_area(v, t) > 0
