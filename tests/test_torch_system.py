"""``System`` / ``Sel`` / ``Particle`` of the port against the JAX package's,
on the CPU.

Both packages read the same PDB scene (``tests/torch_structures.py``: a
helix and a hairpin chain, water, ligands with CONECT bonds, a 4 nm box)
and run the same calls: every selection form and its errors, sub-selection,
set operations and splits, every measure with no PBC, an orthorhombic and a
triclinic box and partial PBC, fits and transforms, wrap and unwrap,
``within_of`` and ``distance_search`` (float cutoff and ``'vdw'``), editing,
``Particle``, ``to_system`` and ``to_gromacs_ndx``. Index sets must be
equal; values agree within 1e-6 relative. The numpy functions of
``ops/measure_host`` are held to the JAX package's on seeded inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.atom import Atom as RefAtom
from molar_tpu.ops import measure_host as ref_measure
from molar_tpu.selection import SelectionSyntaxError as RefSyntaxError
import molar_tpu_torch as mt
from molar_tpu_torch.core.atom import Atom
from molar_tpu_torch.ops import measure_host
from molar_tpu_torch.selection import SelectionSyntaxError

from torch_structures import scene_pdb

RTOL = 1e-6
TRIC = molar_tpu.PeriodicBox.from_vectors_angles(4.0, 4.2, 3.9, 75.0, 82.0, 68.0).matrix


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (the test workers share the cores),
    restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("system") / "scene.pdb"
    path.write_text(scene_pdb(seed=3))
    return str(path)


@pytest.fixture
def pair(scene_path):
    """(JAX system, port system) read from the same PDB, fresh for each test
    (several tests edit them)."""
    return molar_tpu.System.from_file(scene_path), mt.System.from_file(scene_path)


def same(a, b, rtol=RTOL):
    """Equal structure; arrays and floats within ``rtol``."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y, rtol)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=rtol, atol=1e-12)


def same_topology(ref, mine):
    assert ref.n_atoms == mine.n_atoms
    assert list(ref.names()) == list(mine.names())
    assert list(ref.resnames()) == list(mine.resnames())
    for col in ("resid", "resindex", "atomic_number", "mass", "charge", "chain", "bfactor",
                "occupancy", "bonds", "molecules"):
        np.testing.assert_array_equal(getattr(mine, col), getattr(ref, col), err_msg=col)
    for col in ("bond_orders", "formal_charge", "type_id", "flags"):
        a, b = getattr(ref, col), getattr(mine, col)
        assert (a is None) == (b is None), col
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=col)
    assert (ref.type_names() is None) == (mine.type_names() is None)
    if ref.type_name is not None:
        assert list(ref.type_names()) == list(mine.type_names())


def same_state(ref, mine):
    np.testing.assert_array_equal(mine.coords, ref.coords)
    for col in ("velocities", "forces"):
        a, b = getattr(ref, col), getattr(mine, col)
        assert (a is None) == (b is None), col
        if a is not None:
            np.testing.assert_array_equal(b, a)
    assert mine.time == ref.time and mine.step == ref.step
    assert (ref.box is None) == (mine.box is None)
    if ref.box is not None:
        np.testing.assert_array_equal(mine.box.matrix, ref.box.matrix)


def same_system(ref, mine):
    same_topology(ref.topology, mine.topology)
    same_state(ref.state, mine.state)


def test_scene_reads_alike(pair):
    ref, mine = pair
    same_system(ref, mine)
    assert mine.n_atoms > 250 and mine.topology.n_bonds == 9


# -- selection forms ------------------------------------------------------------

FORMS = {
    "all": None,
    "text": "protein and name CA",
    "within": "within 0.5 pbc of resname LIG",
    "same_residue": "same residue as (name OW and z < 2.0)",
    "resid_range": "resid 3:7 or chain B",
    "range_tuple": (2, 10),
    "list": [5, 3, 3, 1],
    "array": np.array([7, 2, 40]),
    "range": range(0, 40, 3),
    "slice": slice(5, 60, 7),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_selection_forms_equal_the_reference(pair, form):
    ref, mine = pair
    want = ref(FORMS[form]).indices
    np.testing.assert_array_equal(mine(FORMS[form]).indices, want)
    np.testing.assert_array_equal(mine.select(FORMS[form]).indices, want)
    if isinstance(FORMS[form], str):
        np.testing.assert_array_equal(mine(mt.SelectionExpr(FORMS[form])).indices, want)
        np.testing.assert_array_equal(mine.select_indices(FORMS[form]), want)
    np.testing.assert_array_equal(mine(mine(FORMS[form])).indices, want)


ERRORS = {
    "empty_text": ("resname XYZ", mt.SelectionError, molar_tpu.SelectionError),
    "empty_range": ((5, 5), mt.SelectionError, molar_tpu.SelectionError),
    "out_of_bounds": ([10 ** 6], mt.SelectionError, molar_tpu.SelectionError),
    "negative": ([-1, 3], mt.SelectionError, molar_tpu.SelectionError),
    "syntax": ("name CA and (", SelectionSyntaxError, RefSyntaxError),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_selection_errors_equal_the_reference(pair, case):
    ref, mine = pair
    form, mine_err, ref_err = ERRORS[case]
    with pytest.raises(ref_err):
        ref(form)
    with pytest.raises(mine_err):
        mine(form)


SUBFORMS = {"text": "name CA", "local": [0, 2, 4], "tuple": (1, 5), "slice": slice(0, 10, 2),
            "range": range(3)}


@pytest.mark.parametrize("form", sorted(SUBFORMS))
def test_sub_selections_equal_the_reference(pair, form):
    ref, mine = pair
    want = ref("protein").select(SUBFORMS[form]).indices
    np.testing.assert_array_equal(mine("protein")(SUBFORMS[form]).indices, want)


def test_sub_selection_and_system_errors(pair):
    ref, mine = pair
    for sys_, err in ((ref, molar_tpu.SelectionError), (mine, mt.SelectionError)):
        with pytest.raises(err):
            sys_("resname LIG").select([100])
        with pytest.raises(err):
            sys_("resname LIG").select("name XX")
        with pytest.raises(err):
            type(sys_)(sys_.topology)
        with pytest.raises(err):
            sys_.set_state(type(sys_.state)(coords=np.zeros((3, 3), np.float32)))
    assert len(mt.System()) == 0


def test_set_operations_equal_the_reference(pair):
    ref, mine = pair
    ra, rb = ref("protein"), ref("within 0.6 pbc of resname LIG")
    ma, mb = mine("protein"), mine("within 0.6 pbc of resname LIG")
    for op in (lambda a, b: a | b, lambda a, b: a & b, lambda a, b: a - b,
               lambda a, b: ~a, lambda a, b: b - a):
        np.testing.assert_array_equal(op(ma, mb).indices, op(ra, rb).indices)
    with pytest.raises(mt.SelectionError):
        ma - ma
    with pytest.raises(mt.SelectionError, match="different systems"):
        ma | mt.System(mine.topology, mine.state)("protein")


def test_splits_equal_the_reference(pair):
    ref, mine = pair
    ref.topology.molecules = np.array([[0, 63], [64, 131], [132, 200]], np.int32)
    mine.topology.molecules = ref.topology.molecules.copy()

    def idx(sels):
        return [s.indices.tolist() for s in sels]

    r, m = ref("not resname SOL"), mine("not resname SOL")
    assert idx(m.split_resindex()) == idx(r.split_resindex())
    assert idx(m.split_chain()) == idx(r.split_chain())
    assert idx(m.split_molecule()) == idx(r.split_molecule())
    assert idx(m.split_contig(mine.topology.resid // 3)) == idx(
        r.split_contig(ref.topology.resid // 3))
    assert idx(m.split_contig(lambda i: i // 10)) == idx(r.split_contig(lambda i: i // 10))
    key = lambda p: None if p.resname == "LIG" else p.chain  # noqa: E731
    assert idx(m.split_by(key)) == idx(r.split_by(key))
    r, m = ref("name CA and resid 2:20 or name O1"), mine("name CA and resid 2:20 or name O1")
    np.testing.assert_array_equal(m.whole_residues().indices, r.whole_residues().indices)
    np.testing.assert_array_equal(m.whole_chains().indices, r.whole_chains().indices)
    np.testing.assert_array_equal(m.segment_ids(), r.segment_ids())
    np.testing.assert_array_equal(m.segment_ids(mine.topology.chain.view(np.int32)),
                                  r.segment_ids(ref.topology.chain.view(np.int32)))


# -- measures -------------------------------------------------------------------

CASES = {"no_pbc": (None, None), "ortho_full": ("ortho", "full"), "ortho_yny": ("ortho", "yny"),
         "tric_full": ("tric", "full"), "tric_yny": ("tric", "yny"), "tric_none": ("tric", None)}


def _boxed(pair, box):
    ref, mine = pair
    if box == "tric":
        ref.state.box = molar_tpu.PeriodicBox(TRIC)
        mine.state.box = mt.PeriodicBox(TRIC)
    return ref, mine


def _dims(pbc):
    if pbc is None:
        return None, None
    if pbc == "full":
        return molar_tpu.PBC_FULL, mt.PBC_FULL
    return molar_tpu.PbcDims(True, False, True), mt.PbcDims(True, False, True)


@pytest.mark.parametrize("text", ["protein", "chain B and name CA", "resname LIG", "resname SOL"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_measures_equal_the_reference(pair, case, text):
    box, pbc = CASES[case]
    ref, mine = _boxed(pair, box)
    rp, mp = _dims(pbc)
    r, m = ref(text), mine(text)
    same(r.com(rp), m.com(mp))
    same(r.cog(rp), m.cog(mp))
    same(r.gyration(rp), m.gyration(mp))
    same(r.inertia(rp), m.inertia(mp))
    same(r.principal_transform(rp), m.principal_transform(mp))
    same(r.min_max(), m.min_max())
    if pbc == "full":
        same(r.gyration_pbc(), m.gyration_pbc())
        same(r.inertia_pbc(), m.inertia_pbc())
        same(r.principal_transform_pbc(), m.principal_transform_pbc())


def test_measure_errors_equal_the_reference(pair):
    ref, mine = pair
    ref.state.box = None
    mine.state.box = None
    with pytest.raises(ValueError, match="periodic box"):
        ref("protein").com(molar_tpu.PBC_FULL)
    with pytest.raises(ValueError, match="periodic box"):
        mine("protein").com(mt.PBC_FULL)
    r, m = ref("resname LIG"), mine("resname LIG")
    r.set_same_mass(0.0)
    m.set_same_mass(0.0)
    with pytest.raises(ref_measure.MeasureError):
        r.com()
    with pytest.raises(measure_host.MeasureError):
        m.com()
    with pytest.raises(measure_host.MeasureError):
        m.rmsd(mine("protein"))


def _moved(sys_, rotate_about):
    """A copy of the system with chain A rotated and shifted."""
    other = type(sys_)(sys_.topology, sys_.state.copy())
    sel = other("chain A")
    sel.rotate([0.3, -0.5, 0.8], 0.7, pivot=rotate_about)
    sel.translate([0.1, -0.2, 0.05])
    sel.rotate([1.0, 0.2, 0.0], -0.4)
    return other


def test_fits_and_transforms_equal_the_reference(pair):
    ref, mine = pair
    pivot = np.array([1.0, 2.0, 0.5])
    ref2, mine2 = _moved(ref, pivot), _moved(mine, pivot)
    same_state(ref2.state, mine2.state)
    r1, r2, m1, m2 = ref("chain A"), ref2("chain A"), mine("chain A"), mine2("chain A")
    same(r1.rmsd(r2), m1.rmsd(m2))
    same(r1.rmsd_mw(r2), m1.rmsd_mw(m2))
    same(r1.fit_transform(r2), m1.fit_transform(m2))
    same(molar_tpu.fit_transform(r1, r2), mt.fit_transform(m1, m2))
    same(molar_tpu.rmsd_py(r1, r2), mt.rmsd_py(m1, m2))
    same(molar_tpu.rmsd_mw(r1, r2), mt.rmsd_mw(m1, m2))
    # Matching by names: the two selections' name sequences differ.
    r3, m3 = ref2("chain A and name CA C"), mine2("chain A and name CA C")
    r4, m4 = ref("chain A and name CA C O"), mine("chain A and name CA C O")
    same(r3.fit_transform_matching(r4), m3.fit_transform_matching(m4))
    same(molar_tpu.fit_transform_matching(r3, r4), mt.fit_transform_matching(m3, m4))
    r2.fit(r1)
    m2.fit(m1)
    same_state(ref2.state, mine2.state)
    assert m2.rmsd(m1) < 1e-5
    r, m = ref("resname LIG"), mine("resname LIG")
    rot, tr = m.principal_transform()
    r.apply_transform(rot, tr)
    m.apply_transform(rot, tr)
    same_state(ref.state, mine.state)


def test_wrap_and_unwrap_equal_the_reference(pair):
    ref, mine = pair
    for sys_ in pair:
        sys_.state.coords[::7] += np.float32(3.1)
        sys_.state.coords[3::11] -= np.float32(2.3)
    ref("all").wrap()
    mine("all").wrap()
    same_state(ref.state, mine.state)
    assert mine.state.box.is_inside(mine.state.coords).all()
    ref("chain A").unwrap_simple()
    mine("chain A").unwrap_simple()
    same_state(ref.state, mine.state)
    ref("resname LIG").unwrap_simple(molar_tpu.PbcDims(True, False, True))
    mine("resname LIG").unwrap_simple(mt.PbcDims(True, False, True))
    same_state(ref.state, mine.state)
    rp = ref("chain B or resname LIG").unwrap_connectivity(0.2)
    mp = mine("chain B or resname LIG").unwrap_connectivity(0.2)
    assert [p.indices.tolist() for p in mp] == [p.indices.tolist() for p in rp]
    same_state(ref.state, mine.state)


# -- searches -------------------------------------------------------------------


@pytest.mark.parametrize("pbc", ["none", "full"])
@pytest.mark.parametrize("cutoff", [0.35, 0.6])
def test_within_of_equals_the_reference(pair, pbc, cutoff):
    ref, mine = pair
    rp, mp = (molar_tpu.PBC_NONE, mt.PBC_NONE) if pbc == "none" else _dims("full")
    want = ref("resname SOL").within_of(cutoff, ref("resname LIG or chain A"), rp).indices
    got = mine("resname SOL").within_of(cutoff, mine("resname LIG or chain A"), mp).indices
    np.testing.assert_array_equal(got, want)
    text = f"resname SOL and within {cutoff} {'pbc ' if pbc == 'full' else ''}of (resname LIG or chain A)"
    np.testing.assert_array_equal(mine(text).indices, want)


def _pairs(out):
    pairs, dist = out
    order = np.lexsort((pairs[:, 1], pairs[:, 0])) if len(pairs) else np.arange(0)
    return pairs[order], dist[order]


@pytest.mark.parametrize("cutoff", [0.3, "vdw"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("pbc", ["none", "full"])
def test_distance_search_equals_the_reference(pair, cutoff, two, pbc):
    ref, mine = pair
    rp, mp = (molar_tpu.PBC_NONE, mt.PBC_NONE) if pbc == "none" else _dims("full")
    r1, m1 = ref("not resname SOL"), mine("not resname SOL")
    r2, m2 = (ref("resname SOL"), mine("resname SOL")) if two else (None, None)
    rpairs, rdist = _pairs(molar_tpu.distance_search(cutoff, r1, r2, rp))
    mpairs, mdist = _pairs(mt.distance_search(cutoff, m1, m2, mp))
    assert len(rpairs) > 0
    np.testing.assert_array_equal(mpairs, rpairs)
    same(rdist, mdist)
    with pytest.raises(mt.SelectionError):
        mt.distance_search("far", m1)


def test_rebound_state_searches_and_measures(pair):
    ref, mine = pair
    r, m = ref("resname LIG"), mine("resname LIG")
    rst, mst = ref.state.copy(), mine.state.copy()
    rst.coords[r.indices] += np.float32(0.5)
    mst.coords[m.indices] += np.float32(0.5)
    assert m.set_state(mst) is mine.state
    r.state = rst
    same(r.com(), m.com())
    assert mine("resname LIG").com()[0] != m.com()[0]
    np.testing.assert_array_equal(m.within_of(0.8, mine("resname SOL")).indices,
                                  r.within_of(0.8, ref("resname SOL")).indices)
    with pytest.raises(mt.SelectionError):
        m.state = mt.State(coords=np.zeros((2, 3), np.float32))


# -- editing --------------------------------------------------------------------


def test_append_remove_keep_equal_the_reference(pair):
    ref, mine = pair
    names = [("NA", "NA", 2.0), ("CL", "CL", 2.1)]
    ref_sel = ref.append_atoms([RefAtom(name=n, resname=rn, resid=900 + k).guess_element_and_mass()
                                for k, (n, rn, _) in enumerate(names)],
                               np.array([[x, x, x] for *_, x in names]))
    mine_sel = mine.append_atoms([Atom(name=n, resname=rn, resid=900 + k).guess_element_and_mass()
                                  for k, (n, rn, _) in enumerate(names)],
                                 np.array([[x, x, x] for *_, x in names]))
    np.testing.assert_array_equal(mine_sel.indices, ref_sel.indices)
    ref_sel.set_same_resname("ION")
    mine_sel.set_same_resname("ION")
    same_system(ref, mine)
    ref.append(ref("resname LIG"))
    mine.append(mine("resname LIG"))
    same_system(ref, mine)
    ref.append_system(ref("chain A").to_system())
    mine.append_system(mine("chain A").to_system())
    same_system(ref, mine)
    ref.remove("resname SOL and z > 2.0")
    mine.remove("resname SOL and z > 2.0")
    same_system(ref, mine)
    ref.keep("not name HW1")
    mine.keep("not name HW1")
    same_system(ref, mine)


def test_state_edits_and_tiling_equal_the_reference(pair):
    ref, mine = pair
    for sys_ in pair:
        sys_.state.velocities = np.arange(sys_.n_atoms * 3, dtype=np.float32).reshape(-1, 3)
    rst, mst = ref.state.copy(), mine.state.copy()
    rst.coords += np.float32(0.25)
    mst.coords += np.float32(0.25)
    rst.time = mst.time = 12.5
    held_ref, held_mine = ref.state, mine.state
    ref.replace_state_deep(rst)
    mine.replace_state_deep(mst)
    assert mine.state is held_mine and mine.state.time == 12.5 and mst.time == 0.0
    same_state(held_ref, held_mine)
    same_state(rst, mst)
    ref("resname LIG").replace_state_deep(rst)
    mine("resname LIG").replace_state_deep(mst)
    same_state(ref.state, mine.state)
    ref.multiply_periodically(2, 1, 2)
    mine.multiply_periodically(2, 1, 2)
    same_system(ref, mine)
    other_ref = molar_tpu.System(ref.topology, ref.state.copy())
    other_mine = mt.System(mine.topology, mine.state.copy())
    other_ref.state.box = molar_tpu.PeriodicBox(TRIC)
    other_mine.state.box = mt.PeriodicBox(TRIC)
    ref.set_box_from(other_ref)
    mine.set_box_from(other_mine)
    assert mine.state.box is not other_mine.state.box
    same_state(ref.state, mine.state)
    ref("name CA").set_box_from(ref)
    mine("name CA").set_box_from(mine)
    mst.set_box_from(mine)
    rst.set_box_from(ref)
    same_state(rst, mst)


SETTERS = {"resname": "XXX", "name": "QQ", "chain": "Z", "mass": 3.5, "charge": -0.25,
           "resid": 77, "bfactor": 9.5}


@pytest.mark.parametrize("what", sorted(SETTERS))
def test_set_same_equals_the_reference(pair, what):
    ref, mine = pair
    getattr(ref("chain B"), f"set_same_{what}")(SETTERS[what])
    getattr(mine("chain B"), f"set_same_{what}")(SETTERS[what])
    same_topology(ref.topology, mine.topology)
    np.testing.assert_array_equal(mine(f"chain {'Z' if what == 'chain' else 'B'}").indices,
                                  ref(f"chain {'Z' if what == 'chain' else 'B'}").indices)


def test_particles_equal_the_reference(pair):
    ref, mine = pair
    r, m = ref("resname LIG"), mine("resname LIG")
    for rp, mp in zip(r, m):
        assert (mp.id, mp.name, mp.resname, mp.resid, mp.resindex, mp.atomic_number,
                mp.chain) == (rp.id, rp.name, rp.resname, rp.resid, rp.resindex,
                              rp.atomic_number, rp.chain)
        same((rp.mass, rp.charge, rp.bfactor, rp.occupancy, rp.x, rp.y, rp.z, rp.pos),
             (mp.mass, mp.charge, mp.bfactor, mp.occupancy, mp.x, mp.y, mp.z, mp.pos))
        assert mp.atom == Atom(**vars(rp.atom))
    for p in (r[1], m[1]):
        p.name = "C9"
        p.resname = "LIH"
        p.x = 1.25
        p.pos = p.pos + np.float32(0.5)
        p.mass = 99.0
    same_system(ref, mine)
    assert repr(m[1]) == repr(r[1])
    assert [a.name for a in m.iter_atoms()] == [a.name for a in r.iter_atoms()]
    same(list(r.iter_pos()), list(m.iter_pos()))
    same(list(ref.iter_pos())[:5], list(mine.iter_pos())[:5])
    same(m.get_coord(), r.get_coord())
    m.set_coord(m.get_coord() * 2)
    r.set_coord(r.get_coord() * 2)
    same_system(ref, mine)


def test_to_system_and_ndx_equal_the_reference(pair):
    ref, mine = pair
    for text in ("chain A", "resname LIG", "resname SOL and name OW"):
        same_system(ref(text).to_system(), mine(text).to_system())
        assert mine(text).to_gromacs_ndx(text) == ref(text).to_gromacs_ndx(text)
    moved = mine("chain A")
    assert (moved >> mine).indices.tolist() == moved.indices.tolist()
    assert mine.bind(ref("chain A")).indices.tolist() == moved.indices.tolist()


def test_unported_chemistry_names_its_module(pair):
    """The chemistry of ``ops/perception``, ``ff/gaff`` and ``ops/surface``
    is ported: on the scene, perception, GAFF typing of the ligands and
    their meshes equal the reference's (meshes within 1e-9 nm)."""
    ref, mine = pair
    want, got = ref.perceive(), mine.perceive()
    assert got.rings == want.rings and got.aromatic == want.aromatic
    same_topology(ref.topology, mine.topology)
    from molar_tpu.ff import apply_ff as ref_apply_ff
    from molar_tpu_torch.ff import apply_ff

    types = apply_ff(mine("resname LIG"))
    assert types == ref_apply_ff(ref("resname LIG")) and len(types) > 0
    for kind in ("sas_mesh", "ses_mesh"):
        v, t = getattr(mine("resname LIG"), kind)(spacing=0.08)
        rv, rt = getattr(ref("resname LIG"), kind)(spacing=0.08)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(t, rt)


def test_top_level_names_are_the_reference_s():
    ref = set(molar_tpu.__dict__) - {"greeting"}
    public = {n for n in ref if not n.startswith("_") and n not in ("config", "core", "selection",
                                                                     "utils", "io", "ops")}
    missing = [n for n in public if not hasattr(mt, n)]
    assert not missing, missing


@pytest.mark.parametrize("package", ["core", "ff", "io", "membrane", "ops", "selection",
                                     "tasks"])
def test_subpackage_names_are_the_reference_s(package):
    """Every name a subpackage of the JAX package exports (its ``__all__``)
    is exported by the port's subpackage of the same name."""
    import importlib

    ref = importlib.import_module(f"molar_tpu.{package}")
    mine = importlib.import_module(f"molar_tpu_torch.{package}")
    missing = [n for n in ref.__all__ if not hasattr(mine, n) or n not in mine.__all__]
    assert not missing, missing


# -- measure_host ---------------------------------------------------------------


def _inputs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    c2 = (c1 @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(0, 0.05, (n, 3))).astype(
        np.float32)
    return c1, c2, rng.uniform(1, 16, n).astype(np.float32)


MEASURE = {
    "min_max": lambda M, c1, c2, m: M.min_max(c1),
    "center": lambda M, c1, c2, m: M.center(c1, m),
    "gyration": lambda M, c1, c2, m: M.gyration(c1, m),
    "inertia_tensor": lambda M, c1, c2, m: M.inertia_tensor(c1, m),
    "inertia": lambda M, c1, c2, m: M.inertia(c1, m),
    "principal_transform": lambda M, c1, c2, m: M.principal_transform(c1, m),
    "rmsd": lambda M, c1, c2, m: M.rmsd(c1, c2),
    "rmsd_mw": lambda M, c1, c2, m: M.rmsd_mw(c1, c2, m),
    "rot_transform": lambda M, c1, c2, m: M.rot_transform(c1 - c1.mean(0), c2 - c2.mean(0), m),
    "fit_transform": lambda M, c1, c2, m: M.fit_transform(c1, c2, m),
    "fit_transform_at_origin": lambda M, c1, c2, m: M.fit_transform_at_origin(c1, c2, m),
    "apply_transform": lambda M, c1, c2, m: M.apply_transform(c1, *M.fit_transform(c1, c2, m)),
    "tail_sz": lambda M, c1, c2, m: M.lipid_tail_order("sz", c1[:12], c2[:1], [1] * 11),
    "tail_scd": lambda M, c1, c2, m: M.lipid_tail_order("scd", c1[:12], c2[:10],
                                                        [1, 1, 2, 1, 1, 1, 1, 2, 1, 1, 1]),
    "tail_scdcorr": lambda M, c1, c2, m: M.lipid_tail_order("scdcorr", c1[:12], c2[:1],
                                                            [1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2]),
    "tail_batch": lambda M, c1, c2, m: M.lipid_tail_order_batch(
        "scdcorr", c1[:36].reshape(3, 12, 3), c2[:3], [1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1]),
}


@pytest.mark.parametrize("name", sorted(MEASURE))
def test_measure_host_equals_the_reference(name):
    c1, c2, m = _inputs()
    same(MEASURE[name](ref_measure, c1, c2, m), MEASURE[name](measure_host, c1, c2, m))
    box = mt.PeriodicBox(TRIC)
    same(ref_measure.center_pbc(c1, m, molar_tpu.PeriodicBox(TRIC)),
         measure_host.center_pbc(c1, m, box))
    same(ref_measure.gyration(c1, m, molar_tpu.PeriodicBox(TRIC)), measure_host.gyration(c1, m, box))
    with pytest.raises(measure_host.MeasureError):
        measure_host.lipid_tail_order("sz", c1[:2], c2[:1], [1])


def test_topology_columns_and_editing_equal_the_reference():
    """A topology with every optional column, built from Atoms in the JAX
    package and from plain columns in the port: the same rows, adjacency,
    subsets, removals and concatenations."""
    rng = np.random.default_rng(6)
    n = 12
    atoms = [RefAtom(name=f"C{k}", resname="MOL" if k < 8 else "ION", resid=1 + k // 8,
                     atomic_number=6 if k < 8 else 11, mass=12.0, charge=float(k) / 10,
                     chain="AB"[k // 8], type_name=f"t{k % 3}", type_id=k % 4,
                     formal_charge=(k % 3) - 1, flags=k % 2)
             for k in range(n)]
    ref = molar_tpu.Topology.from_atoms(atoms)
    ref.assign_resindex()
    ref.set_bonds([(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (5, 6), (6, 7)],
                  [4, 4, 4, 4, 4, 4, 1, 2])
    ref.molecules = np.array([[0, 7], [8, 11]], np.int32)
    from molar_tpu_torch.convert import topology_from_numpy

    mine = topology_from_numpy(ref.names(), ref.resnames(), ref.resid, ref.resindex, ref.chain,
                               ref.mass, ref.charge, ref.occupancy, ref.bfactor,
                               ref.atomic_number, ref.bonds, ref.bond_orders, ref.formal_charge,
                               ref.type_names(), ref.molecules)
    mine.type_id, mine.flags = ref.type_id.copy(), ref.flags.copy()
    same_topology(ref, mine)
    assert [mine.atom(i) == Atom(**vars(ref.atom(i))) for i in range(n)] == [True] * n
    np.testing.assert_array_equal(mine.adjacency.offsets, ref.adjacency.offsets)
    np.testing.assert_array_equal(mine.adjacency.neighbors, ref.adjacency.neighbors)
    np.testing.assert_array_equal(mine.adjacency.of(5), ref.adjacency.of(5))
    idx = rng.permutation(n)[:7]
    ref.molecules = mine.molecules = np.zeros((0, 2), np.int32)
    same_topology(ref.subset(idx), mine.subset(idx))
    same_topology(ref.remove_atoms([1, 6, 9]), mine.remove_atoms([1, 6, 9]))
    same_topology(ref.concat(ref.subset(idx)), mine.concat(mine.subset(idx)))
    plain = molar_tpu.Topology.from_atoms([RefAtom(name="X")])
    same_topology(ref.concat(plain), mine.concat(mt.Topology.from_atoms([Atom(name="X")])))
    ref.add_bonds([(8, 9)], [3])
    mine.add_bonds([(8, 9)], [3])
    mine.set_bond_orders(ref.bond_orders)
    same_topology(ref, mine)
    with pytest.raises(ValueError):
        mine.set_bonds([(0, 0)])
    with pytest.raises(ValueError):
        mine.set_bond_orders([1])
