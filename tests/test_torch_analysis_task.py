"""The port's per-frame ``AnalysisTask`` and its any-format trajectory reader
against the JAX package's, on the CPU.

A GRO and two XTCs (the second's clock restarts at 0) are written by the
port. The same task, with zero-argument pymolar hooks and with
``AnalysisContext`` hooks and a flag of its own (``register_args``), runs
in both packages under ``-b/-e/--skip/--add-time``: the hook order, the
state ``pre_process`` sees (frame 1's), the frames' times and coordinates
must be equal. ``TrajectoryReader.iter_states`` and ``iter_windows`` over a
multi-model PDB, a DCD, a TRR and a NetCDF (serial reads) give the JAX
reader's frames, and
a ``WindowAnalysisTask`` reads its structure from a PDB.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from molar_tpu.tasks import trajectory as jtraj
import molar_tpu_torch as mt
import molar_tpu_torch.io as mio
from molar_tpu_torch.tasks import trajectory as ttraj

from test_torch_system import same_state
from torch_structures import scene_pdb

N1, N2 = 6, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """conf.gro, a.xtc (6 frames, 0..25 ps), b.xtc (5 frames, 0..20 ps: the
    clock restarts), conf.pdb, a multi-model PDB and a DCD of the frames of
    a.xtc."""
    d = tmp_path_factory.mktemp("atask")
    (d / "conf.pdb").write_text(scene_pdb(seed=7, n_water=10, n_ligand=1))
    system = mt.System.from_file(str(d / "conf.pdb"))
    system.save(str(d / "conf.gro"))
    rng = np.random.default_rng(8)
    for name, n in (("a", N1), ("b", N2)):
        with mio.FileHandler(str(d / f"{name}.xtc"), "w") as fh:
            for k in range(n):
                st = system.state.copy()
                st.coords = (st.coords + rng.normal(0, 0.03, st.coords.shape)).astype(np.float32)
                st.time, st.step = 5.0 * k, k
                fh.write(system.topology, st)
    with mio.FileHandler(str(d / "a.xtc")) as src, \
            mio.FileHandler(str(d / "multi.pdb"), "w") as pdb, \
            mio.FileHandler(str(d / "a.dcd"), "w") as dcd, \
            mio.FileHandler(str(d / "a.trr"), "w") as trr, \
            mio.FileHandler(str(d / "a.nc"), "w") as nc:
        for st in src:
            pdb.write(system.topology, st)
            dcd.write(None, st)
            trr.write(None, st)
            nc.write(None, st)
    return {k: str(d / v) for k, v in (("gro", "conf.gro"), ("pdb", "conf.pdb"),
                                       ("a", "a.xtc"), ("b", "b.xtc"),
                                       ("multi", "multi.pdb"), ("dcd", "a.dcd"),
                                       ("trr", "a.trr"), ("nc", "a.nc"))}


def _pymolar_task(base):
    """A task in pymolar's zero-argument style over the package's
    ``AnalysisTask`` ``base``: records every hook call."""

    class Task(base):
        def register_args(self, parser):
            parser.add_argument("--cutoff", type=float, default=0.5)

        def pre_process(self):
            self.log = [("pre", self.state.time, float(self.src.state.coords[0, 0]),
                         self.args.cutoff)]

        def process_frame(self):
            sel = self.src("resname LIG")
            self.log.append(("frame", self.state.time, float(sel.cog()[0]),
                             len(self.src(f"within {self.args.cutoff} pbc of resname LIG"))))

        def post_process(self):
            self.log.append(("post", len(self.log)))

    return Task()


def _ctx_task(base):
    """The same with ``AnalysisContext`` hooks."""

    class Task(base):
        def pre_process(self, ctx):
            self.log = [("pre", ctx.consumed_frames, ctx.system.state.time)]

        def process_frame(self, ctx):
            self.log.append(("frame", ctx.consumed_frames, ctx.system.time,
                             float(ctx.system("protein").com()[1])))

        def post_process(self, ctx):
            self.log.append(("post", ctx.consumed_frames))

    return Task()


ARGS = {
    "all": [],
    "begin": ["-b", "2"],
    "end": ["-e", "8"],
    "skip": ["--skip", "2"],
    "add_time": ["--add-time"],
    "add_time_end": ["--add-time", "-e", "40ps"],
    "time_window": ["-b", "10ps", "-e", "20ps"],
    "mixed": ["-b", "3fr", "--skip", "3", "--add-time", "--cutoff", "0.8"],
}


@pytest.mark.parametrize("style", ["pymolar", "ctx"])
@pytest.mark.parametrize("case", sorted(ARGS))
def test_analysis_task_equals_the_reference(files, style, case):
    make = _pymolar_task if style == "pymolar" else _ctx_task
    argv = ["-f", files["gro"], files["a"], files["b"], "--log", "4"] + ARGS[case]
    if style == "ctx" and "--cutoff" in argv:
        argv = argv[:-2]
    ref, mine = make(jtraj.AnalysisTask), make(ttraj.AnalysisTask)
    rctx, mctx = ref.run(argv), mine.run(argv)
    assert mctx.consumed_frames == rctx.consumed_frames > 0
    assert mine.log == ref.log
    assert [e[0] for e in mine.log] == ["pre"] + ["frame"] * mctx.consumed_frames + ["post"]
    same_state(ref.src.state, mine.src.state)


def test_pre_process_sees_the_first_frame(files):
    task = _pymolar_task(ttraj.AnalysisTask)
    task.run(["-f", files["gro"], files["a"], "-b", "2"])
    with mio.FileHandler(files["a"]) as fh:
        fh.seek_frame(2)
        want = fh.read_state()
    assert task.log[0][:3] == ("pre", want.time, float(want.coords[0, 0]))


READERS = {
    "multi_pdb": (["multi"], {}),
    "dcd_skip": (["dcd"], {"skip": 2}),
    "mixed_begin_end": (["multi", "dcd", "a"], {"begin": 4, "end": 14, "skip": 3}),
    "pdb_then_xtc": (["pdb", "b"], {"begin": 1}),
    "trr_nc_xtc_skip": (["trr", "nc", "b"], {"skip": 2}),
    "trr_begin_end": (["trr"], {"begin": 1, "end": 4}),
}


def _bounds(pkg, kw):
    return {"begin": pkg.FrameSpec(frame=kw.get("begin")), "end": pkg.FrameSpec(frame=kw.get("end")),
            "skip": kw.get("skip", 1)}


@pytest.mark.parametrize("case", sorted(READERS))
def test_reader_iter_states_equals_the_reference(files, case):
    keys, kw = READERS[case]
    paths = [files[k] for k in keys]
    want = list(jtraj.TrajectoryReader(paths, **_bounds(jtraj, kw)).iter_states())
    got = list(ttraj.TrajectoryReader(paths, **_bounds(ttraj, kw)).iter_states())
    assert [f for f, _ in got] == [f for f, _ in want] and len(got) > 1
    for (_, a), (_, b) in zip(want, got):
        same_state(a, b)


@pytest.mark.parametrize("window", [2, 5])
@pytest.mark.parametrize("case", sorted(READERS))
def test_reader_iter_windows_equals_the_reference(files, case, window):
    keys, kw = READERS[case]
    paths = [files[k] for k in keys]
    sub = np.arange(3, 40)
    want = list(jtraj.TrajectoryReader(paths, **_bounds(jtraj, kw)).iter_windows(window,
                                                                                subset=sub))
    got = list(ttraj.TrajectoryReader(paths, **_bounds(ttraj, kw)).iter_windows(window,
                                                                                subset=sub))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def test_window_task_reads_a_pdb_structure(files):
    class Cog(ttraj.WindowAnalysisTask):
        def build(self, system):
            self.subset = system("resname LIG").indices
            self.ids, self.cogs = [], []
            return lambda coords, boxes, invs: coords.mean(dim=1)

        def accumulate(self, ids, res):
            self.ids += ids.tolist()
            self.cogs += res.tolist()

    host = _pymolar_task(ttraj.AnalysisTask)
    host.run(["-f", files["pdb"], files["a"], files["b"], "--skip", "2"])
    task = Cog()
    assert task.run(["-f", files["pdb"], files["a"], files["b"], "--skip", "2", "--window", "2"],
                    device="cpu") == len(host.log) - 2
    assert task.ids == list(range(0, N1 + N2, 2))
    np.testing.assert_allclose([c[0] for c in task.cogs], [e[2] for e in host.log[1:-1]],
                               rtol=1e-6)
    # The structure file alone: its one model is the stream.
    task = Cog()
    assert task.run(["-f", files["multi"]], device="cpu") == N1
    with mio.FileHandler(files["multi"]) as fh:
        want = [st.coords[task.subset].mean(0) for st in fh]
    np.testing.assert_allclose(task.cogs, want, rtol=1e-6)
    # Only an XTC is sized; any other file gets the JAX package's 16 frames.
    for name, subset in (("multi", task.subset), ("dcd", None)):
        assert ttraj.auto_window(files[name], subset) == jtraj.auto_window(files[name], subset)
        assert ttraj.auto_window(files[name], subset) == 16


def test_unported_trajectory_formats_are_refused(files, tmp_path):
    """Every format of the JAX package is read now; an extension neither
    package knows is refused when the reader is made, as the JAX facade
    refuses it, and a TRR and a NetCDF of ``a.xtc``'s frames run the task
    as the XTC does (the NetCDF's Angstrom within 1e-6 nm)."""
    with pytest.raises(mio.FileIoError, match="unsupported file extension: 'abc'"):
        ttraj.TrajectoryReader([files["a"], str(tmp_path / "x.abc")])
    want = _pymolar_task(ttraj.AnalysisTask)
    want.run(["-f", files["gro"], files["a"]])
    for key in ("trr", "nc"):
        got = _pymolar_task(ttraj.AnalysisTask)
        got.run(["-f", files["gro"], files[key]])
        ref = _pymolar_task(jtraj.AnalysisTask)
        ref.run(["-f", files["gro"], files[key]])
        assert got.log == ref.log
        assert [e[:2] + e[3:] for e in got.log[1:-1]] == [e[:2] + e[3:] for e in want.log[1:-1]]
        np.testing.assert_allclose([e[2] for e in got.log[1:-1]],
                                   [e[2] for e in want.log[1:-1]], rtol=0, atol=1e-6)