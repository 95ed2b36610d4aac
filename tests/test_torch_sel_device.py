"""The card's form of the user API (``core/sel_device`` and the device tier
of ``System.select``) against the JAX package's ``Sel``, on the CPU.

A ``System`` on a card sends ``Sel``'s measures, ``within_of``,
``distance_search``, ``sasa`` and a state-dependent selection text through
torch; on the CPU it keeps the host's numpy functions. Here the route test
of :func:`molar_tpu_torch.config.on_host` is replaced (the ``card``
fixture) so that a CPU ``System`` takes the card's route on CPU tensors:
the plain twins of the kernels, the same torch code otherwise.

Both packages read the same seeded PDB scene (``tests/torch_structures.py``,
a 4 nm box; no box, orthorhombic and a skewed box, full and partial PBC).
Bars: measures within 1e-6 relative (float64 on both sides), RMSD within
1e-5, R within 1e-6 relative; within sets and pair sets identical (pairs
after a sort, distances within 1e-6 nm), cutoff ties included (scenes of
exactly representable coordinates, as ``tests/test_neighbor_adversarial.py``
builds them); in a skewed box the JAX package's length-sized grid misses
atoms, so the sets are held to a float64 brute force over the lattice
images there. SASA areas within 2e-5 nm^2 an atom; the volume's voxel
count is the host's, so the volume equals it to 1e-12 relative. The
capacity retries are forced; a pymolar-style ``AnalysisTask`` runs through
all of it against the JAX package's; and the device rule: without a card a
default-device call raises, files still read, two devices in one call
raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.atom import Atom as RefAtom
from molar_tpu.core.state import State as RefState
from molar_tpu.core.topology import Topology as RefTopology
from molar_tpu.tasks.trajectory import AnalysisTask as RefAnalysisTask
import molar_tpu_torch as mt
from molar_tpu_torch import config
from molar_tpu_torch.config import set_default_device
from molar_tpu_torch.core import sel_device
from molar_tpu_torch.core.atom import Atom
from molar_tpu_torch.core.topology import Topology
from molar_tpu_torch.ops import neighbor, neighbor_host
from molar_tpu_torch.selection import FrameSelection, compiled
from molar_tpu_torch.tasks.trajectory import AnalysisTask

import torch_scenes
from torch_structures import scene_pdb

RTOL = 1e-6
RMSD_ATOL = 1e-5
DIST_ATOL = 1e-6
SASA_ATOL = 2e-5
VOLUME_RTOL = 1e-12
TRIC = molar_tpu.PeriodicBox.from_vectors_angles(4.0, 4.2, 3.9, 75.0, 82.0, 68.0).matrix


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (the test workers share the cores),
    and the CPU as the device of ``device=None``; both restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = set_default_device("cpu")
    yield
    set_default_device(old)
    torch.set_num_threads(n)


@pytest.fixture
def card(monkeypatch):
    """CPU systems take the card's route (``core/sel_device``, the device
    tier of ``FrameSelection``) on CPU tensors."""
    monkeypatch.setattr(config, "on_host", lambda device: False)


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("sel_device") / "scene.pdb"
    path.write_text(scene_pdb(seed=3))
    return str(path)


@pytest.fixture
def pair(scene_path, card):
    """(JAX system, port system on the card's route) from the same PDB."""
    return molar_tpu.System.from_file(scene_path), mt.System.from_file(scene_path)


def same(a, b, rtol=RTOL, atol=1e-12):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y, rtol, atol)
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=rtol, atol=atol)


def same_inertia(a, b):
    """(moments, axes, com): moments and com within :data:`RTOL` relative,
    the axes' entries (a rotation's, at most 1) within 1e-6."""
    same(a[0], b[0])
    same(a[1], b[1], rtol=0, atol=RTOL)
    same(a[2], b[2])


def same_transform(a, b):
    """(R, t): R's entries within 1e-6, t within 1e-6 relative (1e-6 nm)."""
    same(a[0], b[0], rtol=0, atol=RTOL)
    same(a[1], b[1], atol=RTOL)


def _box(pair, kind):
    ref, mine = pair
    if kind is None:
        ref.state.box = mine.state.box = None
    elif kind == "tric":
        ref.state.box = molar_tpu.PeriodicBox(TRIC)
        mine.state.box = mt.PeriodicBox(TRIC)
    return ref, mine


def _dims(pbc):
    return {None: (None, None), "none": (molar_tpu.PBC_NONE, mt.PBC_NONE),
            "full": (molar_tpu.PBC_FULL, mt.PBC_FULL),
            "yny": (molar_tpu.PbcDims(True, False, True), mt.PbcDims(True, False, True))}[pbc]


def brute(coords, src, tgt, cutoff):
    """The float64 brute force of a within set in the skewed box."""
    return np.asarray(src)[torch_scenes.brute_within(coords, src, tgt, TRIC, cutoff)[0]]


# -- measures -------------------------------------------------------------------

CASES = {"no_box": (None, None), "ortho_full": ("ortho", "full"), "ortho_yny": ("ortho", "yny"),
         "tric_full": ("tric", "full"), "tric_yny": ("tric", "yny"), "tric_none": ("tric", None)}


@pytest.mark.parametrize("text", ["protein", "chain B and name CA", "resname LIG", "resname SOL"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_measures_equal_the_reference(pair, case, text):
    box, pbc = CASES[case]
    ref, mine = _box(pair, box)
    rp, mp = _dims(pbc)
    r, m = ref(text), mine(text)
    same(r.com(rp), m.com(mp))
    same(r.cog(rp), m.cog(mp))
    same(r.gyration(rp), m.gyration(mp))
    same_inertia(r.inertia(rp), m.inertia(mp))
    same_transform(r.principal_transform(rp), m.principal_transform(mp))
    same(r.min_max(), m.min_max(), rtol=0, atol=0)
    if pbc == "full":
        same(r.gyration_pbc(), m.gyration_pbc())
        same_inertia(r.inertia_pbc(), m.inertia_pbc())
        same_transform(r.principal_transform_pbc(), m.principal_transform_pbc())


def test_measure_errors_equal_the_reference(pair):
    ref, mine = pair
    r, m = ref("resname LIG"), mine("resname LIG")
    r.set_same_mass(0.0)
    m.set_same_mass(0.0)
    for call in (lambda s: s.com(), lambda s: s.gyration(), lambda s: s.inertia()):
        with pytest.raises(ValueError, match="zero total mass"):
            call(r)
        with pytest.raises(ValueError, match="zero total mass"):
            call(m)
    with pytest.raises(ValueError, match="equal size"):
        mine("protein").rmsd(mine("resname LIG"))
    with pytest.raises(ValueError, match="equal size"):
        mine("protein").fit_transform(mine("resname LIG"))


def _moved(sys_):
    other = type(sys_)(sys_.topology, sys_.state.copy())
    sel = other("chain A")
    sel.rotate([0.3, -0.5, 0.8], 0.7, pivot=np.array([1.0, 2.0, 0.5]))
    sel.translate([0.1, -0.2, 0.05])
    return other


def test_fits_equal_the_reference(pair):
    ref, mine = pair
    ref2, mine2 = _moved(ref), _moved(mine)
    r1, r2, m1, m2 = ref("chain A"), ref2("chain A"), mine("chain A"), mine2("chain A")
    same(r1.rmsd(r2), m1.rmsd(m2), rtol=0, atol=RMSD_ATOL)
    same(r1.rmsd_mw(r2), m1.rmsd_mw(m2), rtol=0, atol=RMSD_ATOL)
    same_transform(r1.fit_transform(r2), m1.fit_transform(m2))
    same_transform(molar_tpu.fit_transform(r1, r2), mt.fit_transform(m1, m2))
    r3, m3 = ref2("chain A and name CA C"), mine2("chain A and name CA C")
    r4, m4 = ref("chain A and name CA C O"), mine("chain A and name CA C O")
    same_transform(r3.fit_transform_matching(r4), m3.fit_transform_matching(m4))
    r2.fit(r1)
    m2.fit(m1)
    same(ref2.state.coords, mine2.state.coords, rtol=0, atol=1e-6)
    same(r2.rmsd_mw(r1), m2.rmsd_mw(m1), rtol=0, atol=RMSD_ATOL)
    assert m2.rmsd(m1) < 1e-5


# -- within ---------------------------------------------------------------------


@pytest.mark.parametrize("pbc", ["none", "full", "yny"])
@pytest.mark.parametrize("cutoff", [0.35, 0.6])
def test_within_of_and_select_equal_the_reference(pair, pbc, cutoff):
    ref, mine = pair
    rp, mp = _dims(pbc)
    want = ref("resname SOL").within_of(cutoff, ref("resname LIG or chain A"), rp).indices
    got = mine("resname SOL").within_of(cutoff, mine("resname LIG or chain A"), mp).indices
    np.testing.assert_array_equal(got, want)
    word = {"none": "", "full": "pbc ", "yny": "pbc yny "}[pbc]
    text = f"resname SOL and within {cutoff} {word}of (resname LIG or chain A)"
    np.testing.assert_array_equal(mine(text).indices, ref(text).indices)
    np.testing.assert_array_equal(mine(text).indices, want)


def test_within_in_a_skewed_box_holds_to_a_brute_force(pair):
    ref, mine = _box(pair, "tric")
    src, tgt = mine("resname SOL"), mine("resname LIG or chain A")
    for cutoff in (0.35, 0.6):
        want = brute(mine.state.coords, src.indices, tgt.indices, cutoff)
        np.testing.assert_array_equal(src.within_of(cutoff, tgt, mt.PBC_FULL).indices, want)
        text = f"resname SOL and within {cutoff} pbc of (resname LIG or chain A)"
        np.testing.assert_array_equal(mine(text).indices, want)
    # Partial PBC in a skewed box is the host function's, as FrameSelection's host tier.
    yny = mt.PbcDims(True, False, True)
    want = neighbor_host.search_within(0.5, mine.state.coords, src.indices, tgt.indices,
                                       mine.state.box, yny)
    np.testing.assert_array_equal(src.within_of(0.5, tgt, yny).indices, want)
    fs = FrameSelection("within 0.5 pbc yny of resname LIG", mine.topology, mine.state,
                        device="cpu")
    assert fs.tier == "host"


def _scene(name):
    """(coords f32, box matrix or None, pbc, sources, targets, cutoff): the
    shared neighbour scenes (``torch_scenes.SCENES``: ties, tiny and
    collapsed periodic grids, partial PBC, a solvated protein) and a tie
    without PBC."""
    if name == "tie_no_pbc":
        eps = torch_scenes.EPS
        c = [[1, 1, 1], [1.5, 1, 1], [1.5 + eps, 1, 1], [1, 0.5, 1], [1, 1, 0.5 - eps]]
        return np.array(c, np.float32), None, (False,) * 3, np.arange(1, 5), np.array([0]), 0.5
    coords, src, tgt, cutoff, sides, pbc, _ = torch_scenes.scene(name)
    src = np.arange(len(coords)) if src is None else src
    return coords, np.diag(sides), pbc, src, tgt, cutoff


def _systems(coords, box):
    """The JAX and the port system of carbon atoms at ``coords``."""
    n = len(coords)
    ref = molar_tpu.System(
        RefTopology.from_atoms([RefAtom(name="C", resname="X", resid=i + 1)
                                .guess_element_and_mass() for i in range(n)]),
        RefState(coords=coords.copy(), box=None if box is None else molar_tpu.PeriodicBox(box)))
    mine = mt.System(
        Topology.from_atoms([Atom(name="C", resname="X", resid=i + 1).guess_element_and_mass()
                             for i in range(n)]),
        mt.State(coords=coords.copy(), box=None if box is None else mt.PeriodicBox(box)))
    return ref, mine


@pytest.mark.parametrize("scene", torch_scenes.SCENES + ["tie_no_pbc"])
def test_within_scenes_equal_the_reference(card, scene):
    coords, box, pbc, src, tgt, cutoff = _scene(scene)
    ref, mine = _systems(coords, box)
    rp, mp = molar_tpu.PbcDims(*pbc), mt.PbcDims(*pbc)
    want = ref(list(src)).within_of(cutoff, ref(list(tgt)), rp).indices
    got = mine(list(src)).within_of(cutoff, mine(list(tgt)), mp).indices
    np.testing.assert_array_equal(got, want)
    word = "" if not any(pbc) else "pbc " + "".join("y" if p else "n" for p in pbc) + " "
    text = (f"index {' '.join(map(str, src))} and within {cutoff} {word}of "
            f"index {' '.join(map(str, tgt))}")
    np.testing.assert_array_equal(mine(text).indices, ref(text).indices)
    np.testing.assert_array_equal(mine(text).indices, want)
    members = dict(torch_scenes.TIE_MEMBERS, tie_no_pbc=[1, 3]).get(scene)
    if members is not None:  # the ties kept, those just past them dropped
        assert want.tolist() == members


# -- sub-selections and select ----------------------------------------------------

SUBFORMS = {"text": "name CA", "local": [0, 2, 4], "tuple": (1, 5), "slice": slice(0, 10, 2),
            "range": range(3), "within": "within 0.5 pbc of resname LIG",
            "within_nopbc": "within 0.6 of chain B", "self": "within 0.3 pbc self of name CA",
            "coord": "x < 2.0 and not within 0.4 of name O",
            "point": "within 1.5 of 2.0 2.0 2.0"}


@pytest.mark.parametrize("form", sorted(SUBFORMS))
def test_sub_selections_equal_the_reference(pair, form):
    """In the parent's context (the subset is the search domain and the
    global set): equal sets, or the same empty-selection error."""
    ref, mine = pair
    found = 0
    for parent in ("protein", "all", "chain A or resname SOL"):
        try:
            want = ref(parent).select(SUBFORMS[form]).indices
        except molar_tpu.SelectionError:
            with pytest.raises(mt.SelectionError, match="empty"):
                mine(parent)(SUBFORMS[form])
            continue
        np.testing.assert_array_equal(mine(parent)(SUBFORMS[form]).indices, want)
        found += 1
    assert found


TEXTS = ["within 0.5 pbc of resname LIG", "resname SOL and within 0.4 of chain A",
         "x < 2.0 and name CA", "not within 0.45 pbc of protein",
         "within 0.4 pbc self of resname LIG", "same residue as within 0.3 of resname LIG",
         "within 0.3 of com of resname LIG"]


@pytest.mark.parametrize("text", TEXTS)
def test_select_equals_the_reference(pair, text):
    ref, mine = pair
    np.testing.assert_array_equal(mine(text).indices, ref(text).indices)
    np.testing.assert_array_equal(mine.select_indices(text), ref(text).indices)
    tier = FrameSelection(text, mine.topology, mine.state, device="cpu").tier
    assert tier == ("host" if ("same" in text or "com of" in text) else "device")


# -- distance_search ----------------------------------------------------------------


@pytest.mark.parametrize("form", ["dense", "grid"])
@pytest.mark.parametrize("cutoff", [0.3, "vdw"])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("pbc", ["none", "full"])
def test_distance_search_equals_the_reference(pair, monkeypatch, form, cutoff, two, pbc):
    if form == "grid":
        monkeypatch.setattr(neighbor, "DENSE_LIMIT", 0)
    ref, mine = pair
    rp, mp = _dims(pbc)
    r1, m1 = ref("not resname SOL"), mine("not resname SOL")
    r2, m2 = (ref("resname SOL"), mine("resname SOL")) if two else (None, None)
    rpairs, rdist = molar_tpu.distance_search(cutoff, r1, r2, rp)
    order = np.lexsort((rpairs[:, 1], rpairs[:, 0]))
    mpairs, mdist = mt.distance_search(cutoff, m1, m2, mp)
    assert len(rpairs) > 0
    np.testing.assert_array_equal(mpairs, rpairs[order])
    same(rdist[order], mdist, rtol=0, atol=DIST_ATOL)
    assert mdist.dtype == np.float32


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("pbc", ["none", "full"])
def test_distance_search_returns_one_order_on_both_routes(scene_path, monkeypatch, two, pbc):
    """The host route and the card's give the same arrays, both sorted by
    (i, j), with no sort by the caller."""
    host = mt.System.from_file(scene_path, device="cpu")
    card = mt.System.from_file(scene_path, device="cpu")
    _, p = _dims(pbc)

    def search(system):
        other = system("resname SOL") if two else None
        return mt.distance_search(0.3, system("not resname SOL"), other, p)

    want, wdist = search(host)
    monkeypatch.setattr(config, "on_host", lambda device: False)
    got, gdist = search(card)
    assert len(want) > 0
    np.testing.assert_array_equal(want, want[np.lexsort((want[:, 1], want[:, 0]))])
    np.testing.assert_array_equal(got, want)
    same(wdist, gdist, rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("form", ["dense", "grid"])
def test_distance_search_in_a_skewed_box(pair, monkeypatch, form):
    """The skewed box's correction candidates; held to the port's host
    search (cell-height grid, equal to a float64 brute force), since the
    JAX package's length-sized grid misses pairs."""
    if form == "grid":
        monkeypatch.setattr(neighbor, "DENSE_LIMIT", 0)
    _, mine = _box(pair, "tric")
    m1, m2 = mine("not resname SOL"), mine("resname SOL")
    want, wdist = neighbor_host.search_pairs(0.35, mine.state.coords, m1.indices, m2.indices,
                                             mine.state.box, mt.PBC_FULL)
    order = np.lexsort((want[:, 1], want[:, 0]))
    got, gdist = mt.distance_search(0.35, m1, m2, mt.PBC_FULL)
    np.testing.assert_array_equal(got, want[order])
    same(wdist[order], gdist, rtol=0, atol=DIST_ATOL)
    near = brute(mine.state.coords, m1.indices, m2.indices, 0.35)
    np.testing.assert_array_equal(np.unique(got[:, 0]), near)


# -- SASA ------------------------------------------------------------------------------


@pytest.mark.parametrize("text,slices", [("resname LIG", 64), ("chain A and resid 1:4", 32)])
def test_sasa_equals_the_reference(pair, text, slices):
    ref, mine = pair
    want = ref(text).sasa(n_slices=slices).areas()
    got = mine(text).sasa(n_slices=slices)
    same(want, got.areas(), rtol=0, atol=SASA_ATOL)
    assert abs(got.total_area() - want.sum()) <= SASA_ATOL * len(want)
    with pytest.raises(ValueError, match="without volumes"):
        got.total_volume()


def test_sasa_volume_equals_the_reference(pair):
    ref, mine = pair
    want = ref("resname LIG").sasa(with_volume=True, n_slices=16)
    got = mine("resname LIG").sasa(with_volume=True, n_slices=16)
    assert got.total_volume() > 0
    same(want.total_volume(), got.total_volume(), rtol=VOLUME_RTOL)


# -- capacity retries ---------------------------------------------------------------------


def test_within_overflow_is_retried_never_read(pair, monkeypatch):
    ref, mine = pair
    real = compiled.search_caps
    calls = []

    def quarter(*a):
        return tuple(max(c // 4, 1) for c in real(*a))

    window = neighbor.within_mask_window

    def counted(*a, **k):
        masks, ofl = window(*a, **k)
        calls.append(bool(ofl.any()))
        return masks, ofl

    monkeypatch.setattr(compiled, "search_caps", quarter)
    monkeypatch.setattr(neighbor, "within_mask_window", counted)
    want = ref("resname SOL").within_of(0.6, ref("protein"), molar_tpu.PBC_FULL).indices
    got = mine("resname SOL").within_of(0.6, mine("protein"), mt.PBC_FULL).indices
    np.testing.assert_array_equal(got, want)
    assert calls[0] and not calls[-1] and len(calls) >= 2
    monkeypatch.setattr(compiled, "search_caps", lambda *a: (1,) * (len(a) - 4))
    with pytest.raises(RuntimeError, match=r"largest capacity tier 2 \(caps x4\)"):
        mine("resname SOL").within_of(0.6, mine("protein"), mt.PBC_FULL)


def test_pair_and_sasa_overflows_are_retried(pair, monkeypatch):
    ref, mine = pair
    monkeypatch.setattr(sel_device, "_MAX_PAIRS0", 4)
    monkeypatch.setattr(neighbor, "DENSE_LIMIT", 0)
    monkeypatch.setattr(compiled, "search_caps", lambda *a: (2,) * (len(a) - 4))
    rp, rd = molar_tpu.distance_search(0.3, ref("protein"), ref("resname SOL"))
    mp, md = mt.distance_search(0.3, mine("protein"), mine("resname SOL"))
    np.testing.assert_array_equal(mp, rp[np.lexsort((rp[:, 1], rp[:, 0]))])
    monkeypatch.setattr(sel_device, "_SASA_K0", 2)
    want = ref("resname LIG").sasa(n_slices=16).areas()
    same(want, mine("resname LIG").sasa(n_slices=16).areas(), rtol=0, atol=SASA_ATOL)


# -- the slice as a whole ---------------------------------------------------------------


def _task(base, log):
    """A pymolar-style task: a within text, a fit, an RMSD, a COM, a
    within_of and SASA a frame."""

    class Task(base):
        def pre_process(self):
            self.ref = self.src("chain A").to_system()

        def process_frame(self):
            sel = self.src("chain A")
            near = self.src("resname SOL and within 0.5 pbc of resname LIG")
            sel.fit(self.ref("all"))
            log.append((near.indices.tolist(), sel.rmsd_mw(self.ref("all")),
                        self.src("protein").com(),
                        self.src("resname SOL").within_of(0.4, sel, _full(self.src))
                        .indices.tolist(),
                        self.src("resname LIG").sasa(n_slices=16).areas()))

    return Task()


def _full(system):
    return molar_tpu.PBC_FULL if isinstance(system, molar_tpu.System) else mt.PBC_FULL


def test_analysis_task_through_the_card_route_equals_the_reference(scene_path, card, tmp_path):
    ref = molar_tpu.System.from_file(scene_path)
    rng = np.random.default_rng(5)
    xtc = str(tmp_path / "t.xtc")
    with molar_tpu.io.FileHandler(xtc, "w") as fh:
        for k in range(3):
            st = ref.state.copy()
            st.coords = (st.coords + rng.normal(0, 0.02, st.coords.shape)).astype(np.float32)
            st.time = float(k)
            fh.write(ref.topology, st)
    want, got = [], []
    _task(RefAnalysisTask, want).run(["-f", scene_path, xtc, "--log", "0"])
    task = _task(AnalysisTask, got)
    task.run(["-f", scene_path, xtc, "--log", "0"], device="cpu")
    assert task.src.device == torch.device("cpu") and len(got) == len(want) == 3
    for (wn, wr, wc, ww, wa), (gn, gr, gc, gw, ga) in zip(want, got):
        assert gn == wn and gw == ww and len(gn) > 0
        same(wr, gr, rtol=0, atol=RMSD_ATOL)
        same(wc, gc)
        same(wa, ga, rtol=0, atol=SASA_ATOL)


# -- the device rule ------------------------------------------------------------------------


def test_without_a_card_a_default_device_call_raises(scene_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    old = set_default_device(None)
    try:
        system = mt.System.from_file(scene_path)  # reading resolves nothing
        lig = system("resname LIG")  # a static text needs no device
        system.save(str(tmp_path / "copy.gro"))
        for call in (lambda: lig.com(), lambda: lig.gyration(), lambda: lig.sasa(),
                     lambda: lig.within_of(0.5, system("protein")),
                     lambda: system("within 0.5 of resname LIG"),
                     lambda: mt.distance_search(0.3, lig),
                     lambda: AnalysisTask().run(["-f", scene_path, "--log", "0"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        cpu = mt.System.from_file(scene_path, device="cpu")
        assert cpu("resname LIG").com().shape == (3,)
    finally:
        set_default_device(old)


def test_the_device_is_kept_and_two_devices_raise(scene_path):
    cpu = mt.System.from_file(scene_path, device="cpu")
    assert cpu.device == torch.device("cpu")
    assert cpu("resname LIG").to_system().device == torch.device("cpu")
    other = mt.System.from_file(scene_path, device="cuda")  # never resolved on a card here
    assert (cpu("protein") >> other).system is other
    a, b = cpu("chain A"), other("chain A")
    for call in (lambda: a.rmsd(b), lambda: a.rmsd_mw(b), lambda: a.fit_transform(b),
                 lambda: a.within_of(0.5, b), lambda: mt.distance_search(0.3, a, b)):
        with pytest.raises(mt.SelectionError, match="different devices"):
            call()
    cpu.append(cpu("resname LIG"))
    cpu.multiply_periodically(1, 1, 2)
    assert cpu._device == torch.device("cpu")
