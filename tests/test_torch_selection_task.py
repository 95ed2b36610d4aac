"""``WindowAnalysisTask`` of the port against the JAX package's, on the CPU.

A GRO structure and an 8-frame XTC (changing boxes, 10 ps a frame) are
written by the port; a task counts four selections a frame (a hydration
shell, a slab of water, a sphere round a point, the CA atoms) in both
packages through ``run(["-f", conf.gro, traj.xtc, ...])``, and the counts,
checksums and frame ids agree, with each other and with the port's host
evaluator on every frame. ``-b/-e`` by frame and by time select the same
frames in both. The GRO reader and writer round-trip through the JAX
package's, and ``Topology.from_atoms`` builds the JAX package's columns.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.selection import FrameSelection as RefFrameSelection
from molar_tpu.tasks.trajectory import WindowAnalysisTask as RefTask
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.core.system import System
from molar_tpu_torch.io.base import EmptyFileError
from molar_tpu_torch.io.gro import read_gro, write_gro
from molar_tpu_torch.io.xtc import XtcHandler
from molar_tpu_torch.selection import FrameSelection, SelectionExpr
from molar_tpu_torch.tasks.trajectory import FrameSpec, WindowAnalysisTask

from test_torch_selection import _pdb_system, frames, port_topology

N_FRAMES, WINDOW = 8, 4
TEXTS = {
    "shell": "name OW and within 0.5 pbc of protein",
    "slab": "resname SOL and 2.0 < z < 4.0",
    "sphere": "within 1.0 pbc of [2.0, 2.0, 2.0]",
    "ca": "name CA",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain twins run many small torch ops; on a pool of threads they
    crawl when the test workers share the cores. One thread for this
    module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("task")
    ref = _pdb_system(d / "sys.pdb")
    top = port_topology(ref.topology)
    coords, boxes, _ = frames(ref.state.coords, N_FRAMES, seed=3)
    gro, xtc = str(d / "conf.gro"), str(d / "traj.xtc")
    write_gro(gro, top, State(coords=coords[0], box=PeriodicBox(boxes[0])))
    with XtcHandler(xtc, "w") as w:
        for k in range(N_FRAMES):
            w.write_raw(coords[k], boxes[k], step=k, time=10.0 * k)
    return gro, xtc


class CountTask(WindowAnalysisTask):
    """Per frame: each selection's count and uint32 checksum ``sum(idx +
    1)``, and its overflow flag; only those cross to the host."""

    task_name = "selection counts"

    def build(self, system):
        self.sels = {k: FrameSelection(t, system.topology, system.state, device=self.device)
                     for k, t in TEXTS.items()}
        self.out = {k: [] for k in TEXTS}
        self.ids = []
        n = system.n_atoms
        ids1 = torch.arange(1, n + 1, device=self.device)

        def window_fn(coords, boxes, invs):
            res = {}
            for k, fs in self.sels.items():
                if fs.tier == "static":
                    m = torch.zeros(n, dtype=torch.bool, device=self.device)
                    m[torch.as_tensor(fs.static_idx, device=self.device)] = True
                    masks = m.expand(coords.shape[0], n)
                    ofl = torch.zeros(coords.shape[0], dtype=torch.bool, device=self.device)
                else:
                    masks, ofl = fs.compiled(coords, boxes, invs)
                res[k] = torch.stack([masks.sum(1), (ids1 * masks).sum(1) & 0xFFFFFFFF,
                                      ofl.long()], 1)
            return res

        return window_fn

    def accumulate(self, frame_ids, results):
        self.ids.extend(int(i) for i in frame_ids)
        for k, r in results.items():
            r = r.cpu().numpy()
            assert not r[:, 2].any(), k
            self.out[k].append(r[:, :2])


_REF_SELS = {}


class RefCountTask(RefTask):
    """The same counts through the JAX package (its ``FrameSelection``
    window functions jitted once for the module)."""

    task_name = "selection counts"

    def build(self, system):
        if not _REF_SELS:
            _REF_SELS.update({k: RefFrameSelection(t, system.topology, system.state)
                              for k, t in TEXTS.items()})
        self.out = {k: [] for k in TEXTS}
        self.ids = []
        ids1 = np.arange(1, system.n_atoms + 1, dtype=np.int64)

        def window_fn(coords, boxes, invs, times):
            res = {}
            for k, fs in _REF_SELS.items():
                if fs.tier == "static":
                    m = np.zeros((coords.shape[0], system.n_atoms), bool)
                    m[:, fs.static_idx] = True
                else:
                    m = np.asarray(fs._jit_window(coords, boxes, invs))
                res[k] = np.stack([m.sum(1), (ids1 * m).sum(1) & 0xFFFFFFFF], 1)
            return res

        return window_fn

    def accumulate(self, frame_ids, results):
        self.ids.extend(int(i) for i in frame_ids)
        for k, r in results.items():
            self.out[k].append(r)


def test_task_counts_equal_the_reference_and_the_host(files):
    gro, xtc = files
    task = CountTask()
    assert task.run(["-f", gro, xtc, "--window", str(WINDOW)], device="cpu") == N_FRAMES
    ref = RefCountTask()
    assert ref.run(["-f", gro, xtc, "--window", str(WINDOW)]) == N_FRAMES
    assert task.ids == ref.ids == list(range(N_FRAMES))
    assert {k: fs.tier for k, fs in task.sels.items()} == {
        "shell": "device", "slab": "device", "sphere": "device", "ca": "static"}
    system = System.from_file(gro)
    with XtcHandler(xtc) as h:
        states = [h.read_frame(k) for k in range(N_FRAMES)]
    for k, text in TEXTS.items():
        got, want = np.concatenate(task.out[k]), np.concatenate(ref.out[k])
        np.testing.assert_array_equal(got, want, err_msg=k)
        expr = SelectionExpr(text)
        for f, fr in enumerate(states):
            idx = expr.apply(system.topology, State(coords=fr.coords, box=fr.box))
            assert tuple(got[f]) == (len(idx), int((idx + 1).sum()) % 2**32), (k, f)
        assert got[:, 0].min() > 0, k


def test_task_window_follows_the_stream_rows(files, monkeypatch):
    """Without ``--window`` the task takes ``auto_window`` of the file and
    of the task's ``subset`` (the rows its windows ship)."""
    gro, xtc = files
    from molar_tpu_torch.tasks import trajectory

    seen = []
    real = trajectory.auto_window
    monkeypatch.setattr(trajectory, "auto_window",
                        lambda path, subset=None, **kw: seen.append(subset) or real(path, subset,
                                                                                    **kw))

    class Subset(CountTask):
        def build(self, system):
            self.subset = system.select_indices("name OW")
            fs = FrameSelection("z > 2.0", system.topology, system.state, device=self.device)
            rows = torch.as_tensor(self.subset, device=self.device)

            def window_fn(coords, boxes, invs):
                assert coords.shape[1] == len(rows)
                full = torch.zeros((coords.shape[0], system.n_atoms, 3), device=self.device)
                full[:, rows] = coords
                return fs.compiled(full, boxes, invs)[0][:, rows].sum(1)
            return window_fn

        def accumulate(self, frame_ids, results):
            self.counts = getattr(self, "counts", []) + results.tolist()

    task = Subset()
    assert task.run(["-f", gro, xtc], device="cpu") == N_FRAMES
    assert len(seen) == 1 and np.array_equal(seen[0], task.subset) and task.window == N_FRAMES
    with XtcHandler(xtc) as h:
        want = [int((h.read_frame(k).coords[task.subset, 2] > 2.0).sum()) for k in range(N_FRAMES)]
    assert task.counts == want


class IdsTask(WindowAnalysisTask):
    def build(self, system):
        self.ids = []
        return lambda coords, boxes, invs: coords.shape[0]

    def accumulate(self, frame_ids, results):
        self.ids.extend(int(i) for i in frame_ids)


class RefIdsTask(RefTask):
    def build(self, system):
        self.ids = []
        return lambda coords, boxes, invs, times: None

    def accumulate(self, frame_ids, results):
        self.ids.extend(int(i) for i in frame_ids)


@pytest.mark.parametrize("bounds, want", [
    (["-b", "2", "-e", "5"], [2, 3, 4, 5]),
    (["-b", "3fr"], [3, 4, 5, 6, 7]),
    (["-b", "20ps", "-e", "50ps"], [2, 3, 4, 5]),
    (["-b", "0.015ns", "-e", "0.06ns", "--skip", "2"], [2, 4, 6]),
    (["-e", "45ps"], [0, 1, 2, 3, 4]),
])
def test_begin_end_select_the_reference_frames(files, bounds, want):
    gro, xtc = files
    args = ["-f", gro, xtc, "--window", "3", *bounds]
    task, ref = IdsTask(), RefIdsTask()
    task.run(args, device="cpu")
    ref.run(args)
    assert task.ids == ref.ids == want


def test_frame_spec_parses_as_the_reference():
    from molar_tpu.tasks.trajectory import FrameSpec as RefSpec

    for text in (None, "5", "12fr", "30ps", "1.5ns", "2us", " 7 "):
        got, want = FrameSpec.parse(text), RefSpec.parse(text)
        assert (got.frame, got.time) == (want.frame, want.time), text


class FirstRowTask(IdsTask):
    def build(self, system):
        self.ids, self.rows = [], []
        return lambda coords, boxes, invs: coords[:, 0]

    def accumulate(self, frame_ids, results):
        super().accumulate(frame_ids, results)
        self.rows.append(results)


def test_mesh_and_other_structure_formats_are_refused(files, tmp_path):
    # --mesh is ported: two and three shards on the CPU give the one-device
    # run's frames and rows; a negative device count is refused.
    gro, xtc = files
    one = FirstRowTask()
    one.run(["-f", gro, xtc, "--window", "3"], device="cpu")
    for shards in ("2", "3"):
        task = FirstRowTask()
        task.run(["-f", gro, xtc, "--window", "3", "--mesh", shards], device="cpu")
        assert task.ids == one.ids == list(range(N_FRAMES))
        assert torch.equal(torch.cat(task.rows), torch.cat(one.rows))
    with pytest.raises(ValueError, match="--mesh"):
        IdsTask().run(["-f", gro, xtc, "--mesh", "-1"], device="cpu")
    tpr = tmp_path / "x.tpr"
    tpr.write_text("")
    with pytest.raises(NotImplementedError, match=r"'tpr' format is not yet ported"):
        System.from_file(str(tpr))
    pdb = tmp_path / "x.pdb"
    pdb.write_text("END\n")
    with pytest.raises(EmptyFileError, match="no atoms"):
        System.from_file(str(pdb))


def test_gro_round_trips_through_the_reference(files, tmp_path):
    gro, _ = files
    top, st = read_gro(gro)
    ref = molar_tpu.System.from_file(gro)
    np.testing.assert_array_equal(top.names(), ref.topology.names())
    np.testing.assert_array_equal(top.resnames(), ref.topology.resnames())
    for col in ("resid", "resindex", "atomic_number", "mass", "chain"):
        np.testing.assert_array_equal(getattr(top, col), getattr(ref.topology, col), err_msg=col)
    np.testing.assert_array_equal(st.coords, ref.state.coords)
    np.testing.assert_array_equal(st.box.matrix, ref.state.box.matrix)
    # The JAX package's writer, read back by the port (a skewed box too).
    m = np.array([[3.0, 0, 1.5], [0, 3.0, 1.5], [0, 0, 2.1213]], np.float32)
    ref.state.box = molar_tpu.core.pbc.PeriodicBox(m)
    out = str(tmp_path / "ref.gro")
    ref.save(out)
    top2, st2 = read_gro(out)
    np.testing.assert_array_equal(top2.names(), ref.topology.names())
    np.testing.assert_array_equal(st2.coords, ref.state.coords)
    np.testing.assert_allclose(st2.box.matrix, m, atol=1e-4)
    assert jax.devices()[0].platform == "cpu"


def test_topology_from_atoms_equals_the_reference():
    """``Topology.from_atoms`` over ``Atom`` rows with the element guess, as
    the JAX package's: the same columns and decoded names."""
    from molar_tpu.core.atom import Atom as RefAtom
    from molar_tpu.core.topology import Topology as RefTopology
    from molar_tpu_torch.core.atom import Atom
    from molar_tpu_torch.core.topology import Topology

    rows = [("N", "ALA", 1, "A"), ("CA", "ALA", 1, "A"), ("CA", "CA", 2, "I"),
            ("OW", "SOL", 3, "W"), ("HW1", "SOL", 3, "W"), ("SOD", "SOD", 4, "I"),
            ("CL", "CL", 5, "I"), ("1HB", "LYS", 6, "B")]
    got = Topology.from_atoms([Atom(name=n, resname=r, resid=i, chain=c).guess_element_and_mass()
                               for n, r, i, c in rows])
    want = RefTopology.from_atoms([RefAtom(name=n, resname=r, resid=i, chain=c)
                                   .guess_element_and_mass() for n, r, i, c in rows])
    got.assign_resindex()
    want.assign_resindex()
    np.testing.assert_array_equal(got.names(), want.names())
    np.testing.assert_array_equal(got.resnames(), want.resnames())
    for col in ("resid", "resindex", "atomic_number", "mass", "chain", "charge"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col), err_msg=col)
    np.testing.assert_array_equal(got.vdw(), want.vdw())
