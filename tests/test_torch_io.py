"""The port's structure-file IO and ``FileHandler`` facade against the JAX
package's, on the CPU.

Each handler round-trips, and the files the port's PDB, GRO, XYZ and NDX
writers produce are byte-equal to the JAX package's for the same topology
and state (all atoms and by indices; a box or none; GRO velocities and a
triclinic box). Multi-model PDB, CONECT records after a TER, the element
column, the empty-file and unknown-extension errors (an empty TRR and TPR
among them) are covered. On an XTC and a DCD, ``FileHandler``'s iteration
(prefetching and synchronous), seeks and skips give the JAX facade's
states.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import molar_tpu
import molar_tpu.io as ref_io
from molar_tpu.io.ndx import NdxFile as RefNdx
import molar_tpu_torch as mt
import molar_tpu_torch.io as mio
from molar_tpu_torch.io.base import EmptyFileError, FileIoError
from molar_tpu_torch.io.ndx import NdxFile

from test_torch_system import same_state, same_system, same_topology
from torch_structures import scene_pdb

TRIC = molar_tpu.PeriodicBox.from_vectors_angles(4.0, 4.2, 3.9, 75.0, 82.0, 68.0).matrix


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(JAX system, port system) of the PDB scene, with velocities, charges
    and a resid past 9,999 so the writers' wraps show."""
    path = tmp_path_factory.mktemp("io") / "scene.pdb"
    path.write_text(scene_pdb(seed=5))
    ref, mine = molar_tpu.System.from_file(str(path)), mt.System.from_file(str(path))
    vel = np.random.default_rng(1).normal(0, 0.3, (ref.n_atoms, 3)).astype(np.float32)
    for s in (ref, mine):
        s.state.velocities = vel.copy()
        s.state.time = 12.5
        s.topology.resid[-4:] = 123456
    return ref, mine


def _write(io_mod, path, system, indices=None):
    with io_mod.FileHandler(str(path), "w") as fh:
        fh.write(system.topology, system.state, indices)
    return path.read_bytes()


WRITE_CASES = {
    "pdb": ("pdb", None, "ortho"), "pdb_idx": ("pdb", "protein", "ortho"),
    "pdb_nobox": ("pdb", None, None), "pdb_tric": ("pdb", "resname LIG", "tric"),
    "ent": ("ent", "resname SOL", "ortho"),
    "gro": ("gro", None, "ortho"), "gro_idx": ("gro", "chain B", "ortho"),
    "gro_tric": ("gro", None, "tric"), "gro_novel": ("gro", "resname LIG", "novel"),
    "gro_nobox": ("gro", None, None),
    "xyz": ("xyz", None, "ortho"), "xyz_idx": ("xyz", "resname LIG or name CA", None),
}


def _with_box(system, box, ref):
    pkg = molar_tpu if ref else mt
    st = system.state.copy()
    if box == "tric":
        st.box = pkg.PeriodicBox(TRIC)
    elif box is None:
        st.box = None
    elif box == "novel":
        st.velocities = None
    return type(system)(system.topology, st)


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_writers_are_byte_equal_to_the_reference(scene, tmp_path, case):
    ext, text, box = WRITE_CASES[case]
    ref, mine = (_with_box(s, box, k == 0) for k, s in enumerate(scene))
    idx = None if text is None else ref(text).indices
    want = _write(ref_io, tmp_path / f"ref.{ext}", ref, idx)
    got = _write(mio, tmp_path / f"mine.{ext}", mine, idx)
    assert got == want
    # ... and reads back as the JAX package reads it.
    back_ref = molar_tpu.System.from_file(str(tmp_path / f"ref.{ext}"))
    back_mine = mt.System.from_file(str(tmp_path / f"mine.{ext}"))
    same_system(back_ref, back_mine)
    # Sel.save / System.save write the same bytes.
    sel_or_sys = mine if text is None else mine(text)
    sel_or_sys.save(str(tmp_path / f"save.{ext}"))
    assert (tmp_path / f"save.{ext}").read_bytes() == want


def test_round_trips_keep_what_each_format_stores(scene, tmp_path):
    _, mine = scene
    mine.save(str(tmp_path / "a.gro"))
    back = mt.System.from_file(str(tmp_path / "a.gro"))
    assert list(back.topology.names()) == list(mine.topology.names())
    np.testing.assert_allclose(back.state.coords, mine.state.coords, atol=5e-4)
    np.testing.assert_allclose(back.state.velocities, mine.state.velocities, atol=5e-5)
    assert back.state.time == 12.5 and back.state.box == mine.state.box
    mine.save(str(tmp_path / "a.pdb"))
    back = mt.System.from_file(str(tmp_path / "a.pdb"))
    np.testing.assert_allclose(back.state.coords, mine.state.coords, atol=5e-5)
    np.testing.assert_array_equal(back.topology.atomic_number, mine.topology.atomic_number)
    np.testing.assert_allclose(back.state.box.matrix, mine.state.box.matrix, atol=1e-6)
    mine.save(str(tmp_path / "a.xyz"))
    back = mt.System.from_file(str(tmp_path / "a.xyz"))
    np.testing.assert_allclose(back.state.coords, mine.state.coords, atol=1e-6)


def test_conect_after_ter_and_elements_equal_the_reference(scene):
    ref, mine = scene
    assert mine.topology.n_bonds == 9
    same_topology(ref.topology, mine.topology)
    # The element column wins over the name: OW is oxygen, not tungsten.
    np.testing.assert_array_equal(mine.topology.atomic_number[mine("name OW").indices], 8)


def _multi_model(tmp_path, n_models=3, trailing="ENDMDL"):
    rng = np.random.default_rng(9)
    body = scene_pdb(seed=2, n_water=5, n_ligand=1, chains=("strand",)).splitlines()
    atoms = [ln for ln in body if ln.startswith(("ATOM", "HETATM"))]
    lines = [body[0]]
    for m in range(n_models):
        lines.append(f"MODEL     {m + 1:4d}")
        for ln in atoms:
            x = float(ln[30:38]) + rng.normal(0, 0.2)
            lines.append(f"{ln[:30]}{x:8.3f}{ln[38:]}")
        if trailing == "ENDMDL" or m + 1 == n_models:
            lines.append("ENDMDL")
    lines += [ln for ln in body if ln.startswith("CONECT")] + ["END"]
    path = tmp_path / "multi.pdb"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("trailing", ["ENDMDL", "MODEL"])
@pytest.mark.parametrize("prefetch", [0, 3])
def test_multi_model_pdb_iterates_as_the_reference(tmp_path, trailing, prefetch):
    path = _multi_model(tmp_path, trailing=trailing)
    with ref_io.FileHandler(path) as fr, mio.FileHandler(path) as fm:
        want, got = list(fr.iter_states(prefetch)), list(fm.iter_states(prefetch))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        same_state(a, b)
    with ref_io.FileHandler(path) as fr, mio.FileHandler(path) as fm:
        same_topology(fr.read_topology(), fm.read_topology())
        same_state(fr.read_state(), fm.read_state())
        fr.skip_to_frame(1)
        fm.skip_to_frame(1)
        same_state(fr.read_state(), fm.read_state())
        assert fm.read_state() is None and fr.read_state() is None


ERRORS = {
    "empty_pdb": ("e.pdb", "", EmptyFileError),
    "empty_gro": ("e.gro", "", EmptyFileError),
    "empty_xyz": ("e.xyz", "", EmptyFileError),
    "empty_xtc": ("e.xtc", "", EmptyFileError),
    "empty_dcd": ("e.dcd", "", EmptyFileError),
    "unknown": ("x.abc", "1\n", FileIoError),
    # (the ids of the two formats the port once refused: now the errors the
    # JAX package raises for them; an empty tpr is no tpx file and there
    # is no GROMACS plugin)
    "not_ported_tpr": ("x.tpr", "", mio.tpr.GromacsPluginError),
    "not_ported_trr": ("x.trr", "", EmptyFileError),
    "bad_gro_count": ("b.gro", "t\nabc\n", mio.MalformedFileError),
    "bad_xyz_line": ("b.xyz", "2\n\nC 0 0\n", mio.MalformedFileError),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_are_the_reference_s(tmp_path, case):
    name, text, err = ERRORS[case]
    path = tmp_path / name
    path.write_text(text)
    with pytest.raises(err):
        mt.System.from_file(str(path))
    if case.startswith("unknown"):
        with pytest.raises(err, match="unsupported file extension: 'abc'"):
            mio.FileHandler(str(path))
    else:
        ref_err = getattr(ref_io, err.__name__, None) or getattr(ref_io.tpr, err.__name__)
        with pytest.raises(ref_err):
            molar_tpu.System.from_file(str(path))


@pytest.fixture(scope="module")
def trajectories(scene, tmp_path_factory):
    """An XTC and a DCD of 7 frames (times 0, 2.5, ...), written by the
    JAX package's handlers."""
    ref, _ = scene
    d = tmp_path_factory.mktemp("traj")
    rng = np.random.default_rng(4)
    states = []
    for k in range(7):
        st = ref.state.copy()
        st.coords = (st.coords + rng.normal(0, 0.05, st.coords.shape)).astype(np.float32)
        st.time, st.step = 2.5 * k, 10 * k
        st.velocities = None
        states.append(st)
    paths = {}
    for ext in ("xtc", "dcd"):
        paths[ext] = str(d / f"t.{ext}")
        with ref_io.FileHandler(paths[ext], "w") as fh:
            for st in states:
                fh.write(ref.topology, st)
    return paths


@pytest.mark.parametrize("prefetch", [0, 10])
@pytest.mark.parametrize("ext", ["xtc", "dcd"])
def test_file_handler_iterates_as_the_reference(trajectories, ext, prefetch):
    path = trajectories[ext]
    with ref_io.FileHandler(path) as fr, mio.FileHandler(path) as fm:
        want, got = list(fr.iter_states(prefetch)), list(fm.iter_states(prefetch))
        assert fm.stats.frames_processed == len(got)
    assert len(got) == len(want) == 7
    for a, b in zip(want, got):
        same_state(a, b)
    with mio.open_file(path) as fm:
        assert len(list(fm)) == 7


# Times between frames of the file (the DCD writer numbers frames 0, 1, ...).
SEEKS = {
    "frame": lambda fh: fh.seek_frame(3),
    "time": lambda fh: fh.seek_time(float(fh.handler.times[2]) + 0.1),
    "skip_frame": lambda fh: fh.skip_to_frame(5),
    "skip_time": lambda fh: fh.skip_to_time(float(fh.handler.times[4]) - 0.1),
}


@pytest.mark.parametrize("seek", sorted(SEEKS))
@pytest.mark.parametrize("ext", ["xtc", "dcd"])
def test_seeks_equal_the_reference(trajectories, ext, seek):
    path = trajectories[ext]
    with ref_io.FileHandler(path) as fr, mio.FileHandler(path) as fm:
        SEEKS[seek](fr)
        SEEKS[seek](fm)
        for _ in range(2):
            same_state(fr.read_state(), fm.read_state())
        same_state(fr.seek_last(), fm.seek_last())
        assert fm.read_state() is None
        assert fm.handler.tell_first() == fr.handler.tell_first()
        with pytest.raises(mio.SeekError):
            fm.seek_frame(7)
        with pytest.raises(mio.SeekError):
            fm.seek_time(1e6)


@pytest.mark.parametrize("ext", ["xtc", "dcd"])
def test_trajectory_writes_equal_the_reference(scene, trajectories, tmp_path, ext):
    ref, mine = scene
    idx = ref("protein").indices
    with mio.FileHandler(trajectories[ext]) as src, \
            mio.FileHandler(str(tmp_path / f"m.{ext}"), "w") as out:
        for st in src:
            out.write(None, st, idx)
            out.write_state_pick(st, idx)
    with ref_io.FileHandler(trajectories[ext]) as src, \
            ref_io.FileHandler(str(tmp_path / f"r.{ext}"), "w") as out:
        for st in src:
            out.write(None, st, idx)
            out.write_state_pick(st, idx)
    assert (tmp_path / f"m.{ext}").read_bytes() == (tmp_path / f"r.{ext}").read_bytes()
    with mio.FileHandler(str(tmp_path / f"m.{ext}")) as fh:
        assert fh.handler.n_frames == 14 and fh.handler.n_atoms == len(idx)


def test_facade_helpers_equal_the_reference(scene, tmp_path):
    ref, mine = scene
    mine.save(str(tmp_path / "s.pdb"))
    text = (tmp_path / "s.pdb").read_text()
    for fmt in ("pdb", ".pdb"):
        with mio.FileHandler.from_reader(io.StringIO(text), fmt) as fh:
            top, st = fh.read()
        same_system(molar_tpu.System(*ref_io.read_file(str(tmp_path / "s.pdb"))),
                    mt.System(top, st))
    with mio.FileHandler(str(tmp_path / "t.gro"), "w") as fh:
        fh.write_topology(mine)
        fh.write_state(mine("protein"))
        fh.write_topology(mine.topology)
        with pytest.raises(FileIoError, match="needs a topology"):
            fh.write_state(mine.state)
    with ref_io.FileHandler(str(tmp_path / "r.gro"), "w") as fh:
        fh.write_topology(ref)
        fh.write_state(ref("protein"))
        fh.write_topology(ref.topology)
    assert (tmp_path / "t.gro").read_bytes() == (tmp_path / "r.gro").read_bytes()
    with mio.open_file(str(tmp_path / "t.gro")) as fh:
        assert len(list(fh.iter_states())) == 3
    same_system(molar_tpu.System(*ref_io.read_file(str(tmp_path / "t.gro"))),
                mt.System(*mio.read_file(str(tmp_path / "t.gro"))))
    with pytest.raises(mio.NotWritableError):
        with mio.FileHandler(str(tmp_path / "t.gro")) as fh:
            fh.write_system(mine)


def test_ndx_equals_the_reference(scene, tmp_path):
    ref, mine = scene
    groups = {"Protein": "protein", "Water": "resname SOL", "LIG_near": "within 0.6 pbc of resname LIG"}
    ours = NdxFile({k: mine(t).indices for k, t in groups.items()})
    theirs = RefNdx({k: ref(t).indices for k, t in groups.items()})
    ours["one"] = [3, 1, 1]
    theirs["one"] = [3, 1, 1]
    ours.write(str(tmp_path / "m.ndx"))
    theirs.write(str(tmp_path / "r.ndx"))
    assert (tmp_path / "m.ndx").read_bytes() == (tmp_path / "r.ndx").read_bytes()
    text = "".join(mine(t).to_gromacs_ndx(k) for k, t in groups.items())
    assert text == "".join(ref(t).to_gromacs_ndx(k) for k, t in groups.items())
    (tmp_path / "sel.ndx").write_text("; comment\n" + text + "[ empty ]\n")
    back, want = NdxFile.read(str(tmp_path / "sel.ndx")), RefNdx.read(str(tmp_path / "sel.ndx"))
    assert list(back) == list(want) and len(back) == len(want) == 4 and "Water" in back
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    np.testing.assert_array_equal(NdxFile(str(tmp_path / "sel.ndx")).get_group_as_sel(
        "Water", mine).indices, ref("resname SOL").indices)
    (tmp_path / "bad.ndx").write_text("1 2 3\n")
    with pytest.raises(mio.MalformedFileError):
        NdxFile.read(str(tmp_path / "bad.ndx"))
