"""The port's other file formats against the JAX package's, on the CPU.

TRR, AMBER NetCDF, SDF / MOL and ITP: a file written by the port's writer
is byte-equal to the JAX package's file of the same data, and both
packages read every file to equal ``Topology`` and ``State`` (every column,
coordinates bit for bit), with the seeks, the selective reads and the
windowed reads. TPR and CPT: a minimal tpx file (``tests/torch_gromacs.py``,
single and double precision) and a checkpoint through the pure decoder,
equal in both; the v118 version floor raises alike; the GROMACS plugin
compiled with g++ against the stub headers of ``tests/fixtures/gmx_stub``
drives both packages' ``TprHandler`` / ``CptHandler`` to equal results.
A ``WindowAnalysisTask`` counting a ``within`` selection over a TRR and a
NetCDF of an XTC's decoded frames gives the JAX package's counts, the
TRR's equal to the XTC's frame for frame and the NetCDF's to its own
frames' host evaluation (the NetCDF stores Angstrom in f32, so its
coordinates round-trip the XTC's within 1e-6 nm, not bit for bit).
Exact equality everywhere unless a tolerance is named.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.state import State as RefState
from molar_tpu.io import FileHandler as RefFileHandler
from molar_tpu.io import tpr as ref_tpr
from molar_tpu.io import tpx as ref_tpx
from molar_tpu.io.itp import ItpHandler as RefItp
from molar_tpu.io.netcdf_amber import NetcdfHandler as RefNetcdf
from molar_tpu.io.sdf import SdfHandler as RefSdf
from molar_tpu.io.trr import TrrHandler as RefTrr
from molar_tpu.selection import FrameSelection as RefFrameSelection
from molar_tpu.tasks.trajectory import WindowAnalysisTask as RefTask

import molar_tpu_torch as mt
from molar_tpu_torch import io as mio
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.io import tpr, tpx
from molar_tpu_torch.io.itp import ItpHandler
from molar_tpu_torch.io.netcdf_amber import NetcdfHandler
from molar_tpu_torch.io.sdf import SdfHandler
from molar_tpu_torch.io.trr import TrrHandler
from molar_tpu_torch.io.xtc import XtcHandler
from molar_tpu_torch.selection import FrameSelection, SelectionExpr
from molar_tpu_torch.tasks.trajectory import WindowAnalysisTask

import torch_gromacs
from test_torch_selection import _pdb_system, frames, port_topology
from test_torch_system import same_state, same_topology
from torch_molecules import ligand_corpus, molecule_system, peptide

REPO = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 6
TEXT = "name OW and within 0.5 pbc of protein"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """conf.gro and an XTC of ``N_FRAMES`` frames (changing boxes, 10 ps a
    frame), and the XTC's decoded frames as port states with seeded
    velocities and forces."""
    d = tmp_path_factory.mktemp("formats")
    ref = _pdb_system(d / "sys.pdb")
    top = port_topology(ref.topology)
    coords, boxes, _ = frames(ref.state.coords, N_FRAMES, seed=5)
    gro, xtc = str(d / "conf.gro"), str(d / "traj.xtc")
    mio.gro.write_gro(gro, top, State(coords=coords[0], box=PeriodicBox(boxes[0])))
    with XtcHandler(xtc, "w") as w:
        for k in range(N_FRAMES):
            w.write_raw(coords[k], boxes[k], step=k, time=10.0 * k)
    rng = np.random.default_rng(11)
    states = []
    with XtcHandler(xtc) as h:
        for k in range(N_FRAMES):
            fr = h.read_frame(k)
            states.append(State(coords=fr.coords, box=fr.box, time=fr.time, step=k,
                                velocities=rng.normal(0, 1, fr.coords.shape).astype(np.float32),
                                forces=rng.normal(0, 9, fr.coords.shape).astype(np.float32)))
    return d, gro, xtc, states


def ref_state(st: State, keep=("velocities", "forces")) -> RefState:
    return RefState(coords=st.coords.copy(), time=st.time, step=st.step,
                    box=None if st.box is None else molar_tpu.PeriodicBox(st.box.matrix),
                    velocities=st.velocities if "velocities" in keep else None,
                    forces=st.forces if "forces" in keep else None)


def write_both(handlers, path_mine, path_ref, states, indices=None, keep=("velocities",
                                                                           "forces")):
    mine, ref = handlers
    with mine(str(path_mine), "w") as a:
        for st in states:
            a.write(None, State(coords=st.coords, box=st.box, time=st.time, step=st.step,
                                velocities=st.velocities if "velocities" in keep else None,
                                forces=st.forces if "forces" in keep else None), indices)
    b = ref(str(path_ref), "w")
    for st in states:
        b.write(None, ref_state(st, keep), indices)
    b.close()
    return pathlib.Path(path_mine).read_bytes(), pathlib.Path(path_ref).read_bytes()


@pytest.mark.parametrize("keep, subset", [
    (("velocities", "forces"), False), ((), False), (("velocities",), True)])
def test_trr_files_and_reads_equal_the_reference(scene, tmp_path, keep, subset):
    _, _, _, states = scene
    idx = np.arange(0, states[0].n_atoms, 3) if subset else None
    mine, ref = write_both((TrrHandler, RefTrr), tmp_path / "a.trr", tmp_path / "b.trr",
                           states, idx, keep)
    assert mine == ref and len(mine) > 0
    path = str(tmp_path / "a.trr")
    with TrrHandler(path) as h:
        r = RefTrr(path)
        assert h.n_frames == r.n_frames == N_FRAMES and h.n_atoms == r.n_atoms
        np.testing.assert_array_equal(h.times, r.times)
        for k in range(N_FRAMES):
            same_state(r.read_frame(k), h.read_frame(k))
            same_state(r.read_frame(k, False, False), h.read_frame(k, False, False))
        for a, b in zip(r.read_frames(1, 4), h.read_frames(1, 4)):
            np.testing.assert_array_equal(b, a)
        h.seek_time(25.0)
        r.seek_time(25.0)
        same_state(r.read_state(), h.read_state())
        same_state(r.read_state_pick(False, True), h.read_state_pick(False, True))
        same_state(r.seek_last(), h.seek_last())
        assert h.read_state() is None and r.read_state() is None
        assert h.tell_first() == r.tell_first()
        r.close()
    with mio.FileHandler(path) as fm, RefFileHandler(path) as fr:
        for a, b in zip(fr, fm):
            same_state(a, b)


def test_netcdf_files_and_reads_equal_the_reference(scene, tmp_path):
    _, _, _, states = scene
    mine, ref = write_both((NetcdfHandler, RefNetcdf), tmp_path / "a.nc", tmp_path / "b.nc",
                           states)
    assert mine == ref and mine[:3] == b"CDF"
    for name in ("a.nc", "a.ncdf"):
        path = str(tmp_path / name)
        if name != "a.nc":
            shutil.copy(tmp_path / "a.nc", path)
        with mio.FileHandler(path) as fm, RefFileHandler(path) as fr:
            want, got = list(fr), list(fm)
        assert len(got) == len(want) == N_FRAMES
        for a, b in zip(want, got):
            same_state(a, b)
    with NetcdfHandler(str(tmp_path / "a.nc")) as h:
        r = RefNetcdf(str(tmp_path / "a.nc"))
        for a, b in zip(r.read_frames(2, 9), h.read_frames(2, 9)):
            np.testing.assert_array_equal(b, a)
        h.seek_time(30.0)
        r.seek_time(30.0)
        same_state(r.read_state(), h.read_state())
        same_state(r.seek_last(), h.seek_last())
    # Angstrom in f32: the XTC's frames come back within 1e-6 nm.
    for a, b in zip(states, got):
        assert np.abs(a.coords - b.coords).max() <= 1e-6


def _molecules():
    return [molecule_system(*m, seed=k)
            for k, m in enumerate(ligand_corpus(6, seed=3) + [peptide(3)])]


@pytest.mark.parametrize("ext", ["sdf", "sd", "mol"])
def test_sdf_files_and_reads_equal_the_reference(tmp_path, ext):
    mols = _molecules() if ext != "mol" else _molecules()[:1]
    path = str(tmp_path / f"a.{ext}")
    with SdfHandler(path, "w") as w:
        for m in mols:
            w.write(m.topology, m.state)
    # Each package reads the port's file record by record and writes what
    # it read: three files, one byte string.
    back = {}
    for tag, handler in (("mine", SdfHandler), ("ref", RefSdf)):
        h = handler(path)
        back[tag] = []
        while True:
            try:
                back[tag].append(h.read())
            except EOFError:
                break
        h.close()
        out = handler(str(tmp_path / f"{tag}.{ext}"), "w")
        for top, st in back[tag]:
            out.write(top, st)
        out.close()
    text = pathlib.Path(path).read_bytes()
    assert (tmp_path / f"mine.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes() \
        == text
    assert len(back["mine"]) == len(back["ref"]) == len(mols)
    for (rt, rs), (t, s), m in zip(back["ref"], back["mine"], mols):
        same_topology(rt, t)
        same_state(rs, s)
        np.testing.assert_array_equal(t.bond_orders, m.topology.bond_orders)
        # (a molecule without charges reads back without the column)
        fc = np.zeros(t.n_atoms, np.int8) if t.formal_charge is None else t.formal_charge
        np.testing.assert_array_equal(fc, m.topology.formal_charge)
    # The facade and System.from_file take the first record, in both.
    same_topology(molar_tpu.System.from_file(path).topology, mt.System.from_file(path).topology)


SDF_ERRORS = {
    "v3000": "\n  x\n\n  0  0  0     0  0            999 V3000\nM  END\n",
    "no_atoms": "\n  x\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\nM  END\n",
    "truncated_atoms": "\n  x\n\n  2  0  0  0  0  0  0  0  0  0999 V2000\n    0.0 0.0\n",
    "bond_range": ("\n  x\n\n  1  1  0  0  0  0  0  0  0  0999 V2000\n"
                   "    0.0000    0.0000    0.0000 C   0  0\n  1  5  1  0\nM  END\n"),
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(SDF_ERRORS))
def test_sdf_errors_are_the_reference_s(tmp_path, case):
    path = tmp_path / "e.sdf"
    path.write_text(SDF_ERRORS[case])
    with pytest.raises(Exception) as want:
        RefSdf(str(path)).read()
    with pytest.raises(Exception) as got:
        SdfHandler(str(path)).read()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


ITP = """; test itp
[ moleculetype ]
MOL 3
[ atoms ]
     1   CT      1    LIG     C1      1    -0.10    12.011
     2   HC      1    LIG     H1      2     0.05     1.008
     3   OH      2    LIG     O2      3    -0.50    15.999
     4   HO      2    LIG     HO2     4     0.55     1.008
[ bonds ]
    1    2    1
    1    3    1
    3    4    1
[ pairs ]
    2    4    1
"""


def test_itp_reads_and_writes_equal_the_reference(tmp_path):
    path = tmp_path / "m.itp"
    path.write_text(ITP)
    with mio.FileHandler(str(path)) as fm, RefFileHandler(str(path)) as fr:
        top, rtop = fm.read_topology(), fr.read_topology()
    same_topology(rtop, top)
    with ItpHandler(str(tmp_path / "a.itp"), "w") as w:
        w.write(top)
    r = RefItp(str(tmp_path / "b.itp"), "w")
    r.write(rtop)
    r.close()
    assert (tmp_path / "a.itp").read_bytes() == (tmp_path / "b.itp").read_bytes()
    with ItpHandler(str(tmp_path / "a.itp")) as h:
        same_topology(rtop, h.read_topology())
    (tmp_path / "bad.itp").write_text("[ atoms ]\n 1 CT x\n")
    with pytest.raises(Exception) as want:
        RefItp(str(tmp_path / "bad.itp")).read_topology()
    with pytest.raises(mio.MalformedFileError) as got:
        ItpHandler(str(tmp_path / "bad.itp")).read_topology()
    assert type(want.value).__name__ == "MalformedFileError" and str(got.value) == str(want.value)


def _gromacs_scene(n_water=4, seed=0):
    n, _ = torch_gromacs.molecule_counts(n_water)
    rng = np.random.default_rng(seed)
    box_rows = np.array([[2.5, 0.0, 0.0], [0.0, 2.6, 0.0], [0.3, -0.2, 2.7]])
    return rng.uniform(0, 2.4, (n, 3)), rng.normal(0, 0.5, (n, 3)), box_rows


@pytest.mark.parametrize("precision", [4, 8])
@pytest.mark.parametrize("velocities", [True, False])
def test_synthetic_tpr_reads_equal_the_reference(tmp_path, precision, velocities):
    coords, vels, box_rows = _gromacs_scene()
    path = str(tmp_path / "topol.tpr")
    torch_gromacs.write_tpx(path, coords, vels if velocities else None, box_rows, 4,
                            precision=precision)
    with mio.FileHandler(path) as fm, RefFileHandler(path) as fr:
        (top, st), (rtop, rst) = fm.read(), fr.read()
        with pytest.raises(EOFError):
            fm.read()
    same_topology(rtop, top)
    same_state(rst, st)
    assert top.n_bonds == 4 + 2 * 4 and top.molecules.shape == (5, 2)
    assert list(top.type_names()[:5]) == ["CT", "CT", "OH", "HO", "N3"]
    np.testing.assert_allclose(st.coords, coords, atol=1e-6)
    np.testing.assert_allclose(st.box.matrix, box_rows.T, atol=1e-6)
    assert (st.velocities is not None) == velocities
    # The decoder's own records, and the System of the file.
    h, t, box, c, v = tpx.read_tpx(path)
    rh, rt, rbox, rc, rv = ref_tpx.read_tpx(path)
    assert (h.file_version, h.precision, h.natoms) == (rh.file_version, rh.precision, rh.natoms)
    assert [m.bonds for m in t.moltypes] == [m.bonds for m in rt.moltypes]
    assert t.molblocks == rt.molblocks
    np.testing.assert_array_equal(c, rc)
    same_topology(molar_tpu.System.from_file(path).topology, mt.System.from_file(path).topology)


def test_synthetic_cpt_reads_equal_the_reference(tmp_path):
    coords, vels, box_rows = _gromacs_scene(seed=1)
    for tag, v in (("v", vels), ("x", None)):
        path = str(tmp_path / f"state_{tag}.cpt")
        torch_gromacs.write_cpt(path, coords, v, box_rows, step=5000, time=10.0)
        with mio.FileHandler(path) as fm, RefFileHandler(path) as fr:
            st, rst = fm.read_state(), fr.read_state()
            assert fm.read_state() is None and fr.read_state() is None
        same_state(rst, st)
        assert tpx.read_cpt(path)[:3] == ref_tpx.read_cpt(path)[:3] == (len(coords), 5000, 10.0)
        assert (st.velocities is not None) == (v is not None)


def test_tpx_version_floor_raises_as_the_reference(tmp_path):
    coords, vels, box_rows = _gromacs_scene()
    path = str(tmp_path / "old.tpr")
    torch_gromacs.write_tpx(path, coords, vels, box_rows, 4, version=118)
    assert tpx.MIN_TPX_VERSION == ref_tpx.MIN_TPX_VERSION == 119
    for mod in (tpx, ref_tpx):
        with pytest.raises(mod.TpxError, match=r"fileVersion 118 is older than the supported "
                                               r"range \(>= 119"):
            mod.read_tpx(path)
        with pytest.raises(mod.TpxError, match="fileVersion 118"):
            mod.TpxNativeHandler(path)
    # Through the facade: no plugin, and the decoder refuses -> the plugin's
    # error, in both.
    with pytest.raises(tpr.GromacsPluginError, match="GROMACS plugin not found"):
        mt.System.from_file(path)
    with pytest.raises(ref_tpr.GromacsPluginError, match="GROMACS plugin not found"):
        molar_tpu.System.from_file(path)


@pytest.fixture(scope="module")
def stub_plugin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("gmx") / "libmolar_gromacs_stub.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{REPO / 'tests' / 'fixtures' / 'gmx_stub'}",
                    str(REPO / "molar_tpu" / "native" / "gromacs_plugin.cpp"), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    return str(out)


@pytest.fixture()
def plugin_env(stub_plugin, monkeypatch):
    monkeypatch.setenv("MOLAR_GROMACS_PLUGIN", stub_plugin)
    tpr._plugin.cache_clear()
    ref_tpr._plugin.cache_clear()
    yield
    tpr._plugin.cache_clear()
    ref_tpr._plugin.cache_clear()


def test_stub_plugin_reads_equal_the_reference(plugin_env, tmp_path):
    path = str(tmp_path / "fake.tpr")
    h, r = tpr.TprHandler(path), ref_tpr.TprHandler(path)
    assert h._native is None and r._native is None
    (top, st), (rtop, rst) = h.read(), r.read()
    same_topology(rtop, top)
    same_state(rst, st)
    assert top.n_atoms == 3 and list(top.names()) == ["OW", "HW1", "HW2"]
    with pytest.raises(EOFError):
        h.read()
    h.close()
    r.close()
    with mio.FileHandler(str(tmp_path / "state.cpt")) as fm, \
            RefFileHandler(str(tmp_path / "state.cpt")) as fr:
        st, rst = fm.read_state(), fr.read_state()
        assert fm.read_state() is None and fr.read_state() is None
    same_state(rst, st)
    assert st.velocities is not None and st.step == rst.step


def test_plugin_loader_order(stub_plugin, monkeypatch, tmp_path):
    """``MOLAR_GROMACS_PLUGIN`` first, then ``build/molar_tpu_torch/``'s
    ``libmolar_gromacs.so``, then the decoder."""
    from molar_tpu_torch import build

    monkeypatch.delenv("MOLAR_GROMACS_PLUGIN", raising=False)
    monkeypatch.setattr(build, "GROMACS_PLUGIN", pathlib.Path(stub_plugin))
    tpr._plugin.cache_clear()
    try:
        assert tpr._plugin()._name == stub_plugin
        monkeypatch.setattr(build, "GROMACS_PLUGIN", tmp_path / "none.so")
        tpr._plugin.cache_clear()
        with pytest.raises(tpr.GromacsPluginError, match="molar_tpu_torch.build gromacs-plugin"):
            tpr._plugin()
    finally:
        tpr._plugin.cache_clear()
    env = {"GROMACS_SOURCE_DIR": "", "GROMACS_BUILD_DIR": "b", "GROMACS_LIB_DIR": "c"}
    with pytest.raises(build.BuildError, match="GROMACS_SOURCE_DIR"):
        build.build_gromacs_plugin(env=env)


class Counts(WindowAnalysisTask):
    def build(self, system):
        self.sel = FrameSelection(TEXT, system.topology, system.state, device=self.device)
        self.ids, self.counts = [], []
        return lambda c, b, i: self.sel.compiled(c, b, i)[0].sum(1)

    def accumulate(self, frame_ids, results):
        self.ids += [int(i) for i in frame_ids]
        self.counts += results.tolist()


_REF_SEL = []


class RefCounts(RefTask):
    def build(self, system):
        if not _REF_SEL:
            _REF_SEL.append(RefFrameSelection(TEXT, system.topology, system.state))
        self.ids, self.counts = [], []
        return lambda c, b, i, t: np.asarray(_REF_SEL[0]._jit_window(c, b, i)).sum(1)

    def accumulate(self, frame_ids, results):
        self.ids += [int(i) for i in frame_ids]
        self.counts += np.asarray(results).tolist()


def test_window_task_over_trr_and_netcdf_equals_the_reference_and_the_xtc(scene):
    d, gro, xtc, states = scene
    paths = {"xtc": xtc, "trr": str(d / "w.trr"), "nc": str(d / "w.nc")}
    for ext in ("trr", "nc"):
        with mio.FileHandler(paths[ext], "w") as w:
            for st in states:
                w.write(None, st)
    got = {}
    for ext, path in paths.items():
        task, ref = Counts(), RefCounts()
        assert task.run(["-f", gro, path, "--window", "4"], device="cpu") == N_FRAMES
        ref.run(["-f", gro, path, "--window", "4"])
        assert task.ids == ref.ids == list(range(N_FRAMES)), ext
        assert task.counts == ref.counts, ext
        got[ext] = task.counts
    assert got["trr"] == got["xtc"] and min(got["xtc"]) > 0
    system = mt.System.from_file(gro)
    expr = SelectionExpr(TEXT)
    with mio.FileHandler(paths["nc"]) as fh:
        host = [len(expr.apply(system.topology, st)) for st in fh]
    assert got["nc"] == host
