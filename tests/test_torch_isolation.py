"""The port stands without JAX: the machine with the card has no JAX, and any
``molar_tpu`` import reaches the JAX package's import-time pytree
registration. A subprocess with both blocked imports every module of the
port and runs the headline slice at a tiny size on the CPU, through the
ghost and row routes and, on a rhombic dodecahedron, the correction path,
the selection workloads (the SASA one among them) over subset windows,
``ops/sasa_lr`` and ``ops/sasa`` on a small cluster, and the membrane
pipeline (``membrane/*``) with ``tasks/engine`` on a small bilayer, and the
selection language (``selection/*``, the host modules it reads, ``io/gro``,
``core/system``) through a ``WindowAnalysisTask`` on a GRO and an XTC, and
espaloma charges (``ff/*``, ``ops/perception``), trjconv (``io/dcd``,
``io/trjconv``) through the function and the ``molar-torch`` CLI, a
``FrameBatch``, a membrane spec from a TOML with its leaflets, the
headline stream sharded over two CPU devices (``parallel/mesh``), and the
user API (a PDB through ``System``/``Sel``, their measures, DSSP, SASA,
the IO facade and NDX, an ``AnalysisTask``), and the rest of the host half
(a TRR, a NetCDF and an SDF, ``perceive``, ``apply_ff``, a mesh, a TPR, a
host ``Membrane`` frame with ``MembraneDevice(membrane)``, ``molar-torch
last``); a static scan finds no JAX or ``molar_tpu`` import in the port or
in ``chip_smoke.py``.
"""

import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "molar_tpu_torch"

_RUN_WITHOUT_JAX = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["molar_tpu"] = None
    import importlib, pkgutil, tempfile, os
    import numpy as np
    import molar_tpu_torch
    for m in pkgutil.walk_packages(molar_tpu_torch.__path__, "molar_tpu_torch."):
        importlib.import_module(m.name)
    from molar_tpu_torch import headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.io.xtc import XtcHandler
    from molar_tpu_torch.ops.neighbor import grid_dims_for

    n, npro, side, cutoff = 2000, 200, 2.714, 0.5
    coords0, masses = headline.make_system(n, npro, np.diag([side] * 3))
    box = PeriodicBox(np.diag([side] * 3))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.xtc")
        headline.write_trajectory(path, coords0, box.matrix, 6)
        dims = grid_dims_for(box, cutoff)
        pidx = np.arange(npro)
        caps0 = headline.base_caps(path, box.inv, dims, pidx)
        ids, rmsd, count, check, _ = headline.run(
            path, coords0[pidx], masses[pidx], pidx, box, cutoff, dims, caps0, 4, "cpu")
        with XtcHandler(path) as h:
            last = h.read_frame(5).coords.astype(np.float64)
    d = last[:, None, :] - last[None, pidx, :]
    d -= side * np.round(d / side)
    hits = np.flatnonzero(((d * d).sum(-1) <= cutoff**2).any(1))
    assert ids.tolist() == list(range(6)), ids
    assert count[5] == len(hits) and check[5] == int((hits + 1).sum()) % 2**32
    assert np.isfinite(rmsd).all() and (rmsd > 0).all()

    # The same trajectory through the row stencil's plain twin.
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.xtc")
        headline.write_trajectory(path, coords0, box.matrix, 6)
        rows = headline.run(path, coords0[pidx], masses[pidx], pidx, box, cutoff, dims, caps0,
                            4, "cpu", search="rows")
    assert all((a == b).all() for a, b in zip(rows[:4], (ids, rmsd, count, check)))

    # A rhombic dodecahedron (d = 3 nm) through the correction path.
    dd = 3.0
    m = np.array([[dd, 0, dd / 2], [0, dd, dd / 2], [0, 0, dd * 2**0.5 / 2]], np.float32)
    tbox = PeriodicBox(m)
    tdims = grid_dims_for(tbox, cutoff)
    assert tdims == (4, 4, 4)
    tc0, tm = headline.make_system(1909, 100, m)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.xtc")
        headline.write_trajectory(path, tc0, m, 3)
        tcaps = headline.base_caps(path, tbox.inv, tdims, pidx[:100])
        _, _, tcount, _, _ = headline.run(path, tc0[:100], tm[:100], pidx[:100], tbox, cutoff,
                                          tdims, tcaps, 4, "cpu")
        with XtcHandler(path) as h:
            last = h.read_frame(2).coords.astype(np.float64)
    inv = np.linalg.inv(m.astype(np.float64))
    f = (last[:, None, :] - last[None, :100, :]) @ inv.T
    dl = (f - np.round(f)) @ m.T.astype(np.float64)
    shifts = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
                      np.float64) @ m.T.astype(np.float64)
    best = np.min([((dl + s) ** 2).sum(-1) for s in shifts], axis=0)
    assert tcount[2] == int((best <= cutoff**2).any(1).sum()), tcount
    # The selection workloads, streamed over subset windows.
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.tasks.trajectory import auto_window
    for name in ("workloads", "ops.measure", "ops.neighbor", "ops.sasa_lr", "ops.sasa",
                 "tasks.trajectory", "convert", "build"):
        assert "molar_tpu_torch." + name in sys.modules, name
    s = wl.synth_system(1500, 300)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.xtc")
        wl.write_xtc(s, path, 10)
        assert auto_window(path, s.ca) == 10
        got = {name: wl.run(name, s, path, 4, "cpu") for name in wl.WORKLOADS
               if name != "membrane"}
    assert all(n == 10 for n, _, _ in got.values())
    assert got["fused"][2]["check"] == got["ca_rmsd"][2]["check"] > 0
    assert got["fused"][2]["check_com"] == got["com_splits"][2]["check"] > 0
    assert got["fused"][2]["check_contacts"] == got["contacts"][2]["check"] > 0
    assert "sasa" in got and got["sasa"][2]["check"] > 0
    # Exact and sampled SASA of a small cluster, and the series evaluator.
    import torch
    from molar_tpu_torch.ops import sasa, sasa_lr
    rng = np.random.default_rng(7)
    c = rng.uniform(0.2, 1.8, (80, 3)).astype(np.float32)
    r = np.full(80, 0.3, np.float32)
    nbr, ofl = sasa_lr.neighbor_lists(c, r, cap=96)
    exact = sasa_lr.sasa(torch.from_numpy(c), torch.from_numpy(r), torch.from_numpy(nbr), 32)
    window, flags = sasa_lr.sasa_window(torch.from_numpy(c[None]), torch.from_numpy(r),
                                        (2.0, 2.0, 2.0), (3, 3, 3), 40, 96)
    assert not ofl and not flags.any() and torch.allclose(window[0], exact, atol=1e-6)
    nbm, _ = sasa.neighbor_matrix(c, r, cap=96)
    sampled = sasa.shrake_rupley(torch.from_numpy(c), torch.from_numpy(r), torch.from_numpy(nbm))
    assert abs(float(sampled.sum()) - float(exact.sum())) < 0.03 * float(exact.sum())
    series = sasa_lr.SasaSeries(c, r - 0.14, extents=(2.0, 2.0, 2.0), n_slices=32, device="cpu")
    assert torch.allclose(series.update(c), exact, atol=1e-6)
    # The membrane pipeline streamed over a small bilayer, and the engine.
    from molar_tpu_torch.membrane import MembraneDevice
    from molar_tpu_torch.tasks import engine
    b = wl.synth_bilayer(3, 3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.xtc")
        wl.write_membrane_xtc(b, path, 4)
        n, _, mchk = wl.run("membrane", b, path, 2, "cpu")
    assert n == 4 and mchk["check_area"] > 0
    memb = MembraneDevice(b.spec, b.coords, b.box, engine="auto")
    mout = memb.compute_window(b.frames(2)[:, b.spec.subset])
    assert memb.engine_resolved == "cpu" and mout["valid"].any()
    memb.accumulate(mout)
    assert memb.groups["all"].per_species["LIP"]["area"].n == 2
    assert engine.pick_engine(1.0) == "cpu" and engine.engine_device("host").type == "cpu"
    for name in ("membrane", "membrane.device", "membrane.spec", "membrane.stats",
                 "tasks.engine"):
        assert "molar_tpu_torch." + name in sys.modules, name
    # The membrane from a TOML on a System: the bilayer's spec again.
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.core.system import System
    from molar_tpu_torch.membrane import Membrane, MembraneSpec, split_leaflets
    nl = b.spec.n_lipids
    ltop = topology_from_numpy(["P", "G", "C1", "C2", "C3", "C4"] * nl, ["LIP"] * 6 * nl,
                               np.repeat(np.arange(1, nl + 1), 6), np.repeat(np.arange(nl), 6),
                               ["A"] * 6 * nl, np.full(6 * nl, 12.0), np.zeros(6 * nl),
                               np.ones(6 * nl), np.zeros(6 * nl), np.full(6 * nl, 6))
    lsys = System(ltop, State(coords=b.coords, box=PeriodicBox(b.box)))
    toml = "\\n".join(["cutoff = 2.0", "[lipids.LIP]", 'whole = "resname LIP"',
                      'head = "name P"', 'mid = "name G"', 'tails = ["C1-C2-C3-C4"]'])
    tspec = MembraneSpec.from_toml(lsys, toml)
    assert all(np.array_equal(getattr(tspec, f), getattr(b.spec, f))
               for f in ("subset", "first", "atom_first", "masses", "species_of"))
    assert tspec.groups == b.spec.groups
    up, down = split_leaflets(Membrane(lsys, toml))
    assert up == list(range(nl // 2)) and down == list(range(nl // 2, nl))
    # Frames sharded over two CPU "devices": the headline stream again.
    from molar_tpu_torch.parallel import MeshWindowRunner, com_gyration_sharded, frame_mesh
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.xtc")
        headline.write_trajectory(path, coords0, box.matrix, 6)
        mesh_out = headline.run(path, coords0[pidx], masses[pidx], pidx, box, cutoff, dims,
                                caps0, 4, "cpu", mesh=frame_mesh(2, devices=["cpu"] * 4))
    assert mesh_out[0].tolist() == ids.tolist() and (mesh_out[2] == count).all()
    assert (mesh_out[3] == check).all()
    com, gyr = com_gyration_sharded([["cpu", "cpu"]] * 2)(coords0[None], masses)
    assert com.shape == (1, 3) and float(gyr[0]) > 0
    assert "molar_tpu_torch.parallel.mesh" in sys.modules
    # The selection language: a GRO and an XTC through a WindowAnalysisTask
    # whose window function runs three tiers of FrameSelection.
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.io.gro import write_gro
    from molar_tpu_torch.selection import FrameSelection, SelectionExpr
    from molar_tpu_torch.tasks.trajectory import WindowAnalysisTask
    n = 600
    names = ["CA", "CB", "N"] * 20 + ["OW", "HW1", "HW2"] * 180
    resnames = ["ALA"] * 60 + ["SOL"] * 540
    resid = np.concatenate([1 + np.arange(60) // 3, 21 + np.arange(540) // 3])
    top = topology_from_numpy(names, resnames, resid, resid - 1, ["A"] * n, np.ones(n),
                              np.zeros(n), np.ones(n), np.zeros(n), np.full(n, 6))
    sc, _ = headline.make_system(n, 60, np.diag([3.0] * 3))
    texts = ("name OW and within 0.5 pbc of protein", "same residue as (x < 1.0)", "name CA")

    class Counts(WindowAnalysisTask):
        def build(self, system):
            self.sels = [FrameSelection(t, system.topology, system.state, device=self.device)
                         for t in texts]
            self.counts = []
            return lambda c, b, i: self.sels[0].compiled(c, b, i)[0].sum(1)

        def accumulate(self, ids, res):
            self.counts += res.tolist()

    with tempfile.TemporaryDirectory() as d:
        gro, xtc = os.path.join(d, "conf.gro"), os.path.join(d, "traj.xtc")
        write_gro(gro, top, State(coords=sc, box=PeriodicBox(np.diag([3.0] * 3))))
        headline.write_trajectory(xtc, sc, np.diag([3.0] * 3), 5)
        task = Counts()
        assert task.run(["-f", gro, xtc], device="cpu") == 5
        with XtcHandler(xtc) as h:
            fr = h.read_frame(4)
    st = State(coords=fr.coords, box=fr.box)
    assert [s.tier for s in task.sels] == ["device", "host", "static"]
    assert task.counts[4] == len(SelectionExpr(texts[0]).apply(top, st)) > 0
    for name in ("selection", "selection.compiled", "selection.evaluator", "selection.parser",
                 "selection.nodes", "core.topology", "core.interner", "core.periodic_table",
                 "core.atom", "core.state", "core.system", "io.gro", "ops.neighbor_host",
                 "ops.measure_host"):
        assert "molar_tpu_torch." + name in sys.modules, name
    # espaloma charges of benzene: the torch forward on the CPU, the numpy
    # walk, and written into a System's charge column.
    import contextlib, io
    import torch
    from molar_tpu_torch import cli
    from molar_tpu_torch.core.state import FrameBatch
    from molar_tpu_torch.core.system import System
    from molar_tpu_torch.ff import espaloma
    from molar_tpu_torch.io.dcd import DcdHandler
    from molar_tpu_torch.io.trjconv import trjconv
    z = np.array([6] * 6 + [1] * 6)
    bonds = [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2), (5, 0, 1)]
    bonds += [(i, i + 6, 1) for i in range(6)]
    q = espaloma.espaloma_charges(z, np.zeros(12, int), bonds, device="cpu")
    os.environ["MOLAR_ESPALOMA_BACKEND"] = "numpy"
    q_host = espaloma.espaloma_charges(z, np.zeros(12, int), bonds)
    del os.environ["MOLAR_ESPALOMA_BACKEND"]
    assert np.abs(q - q_host).max() < 1e-4 and abs(q.sum()) < 1e-4 and q[0] < 0 < q[6]
    btop = topology_from_numpy(["C"] * 6 + ["H"] * 6, ["BEN"] * 12, np.ones(12), np.zeros(12),
                               ["A"] * 12, np.ones(12), np.zeros(12), np.ones(12), np.zeros(12),
                               z, [(i, j) for i, j, _ in bonds])
    bsys = System(btop, State(coords=np.zeros((12, 3), np.float32)))
    # Without a bond-order column every bond counts as single ...
    q1 = espaloma.espaloma_charges(z, np.zeros(12, int), [(i, j, 1) for i, j, _ in bonds],
                                   device="cpu")
    assert np.array_equal(espaloma.apply_charges(bsys, device="cpu"), q1)
    assert np.array_equal(bsys.topology.charge, q1) and np.abs(q1 - q).max() > 1e-3
    # ... with one, apply_charges reads it, of a System and of a Sel.
    otop = topology_from_numpy(["C"] * 6 + ["H"] * 6, ["BEN"] * 12, np.ones(12), np.zeros(12),
                               ["A"] * 12, np.ones(12), np.zeros(12), np.ones(12), np.zeros(12),
                               z, [(i, j) for i, j, _ in bonds], [o for *_, o in bonds])
    osys = System(otop, State(coords=np.zeros((12, 3), np.float32)))
    assert np.array_equal(espaloma.apply_charges(osys, device="cpu"), q)
    assert np.array_equal(osys.apply_charges(device="cpu"), q)
    assert np.array_equal(espaloma.apply_charges(osys("all"), device="cpu"), q)
    # trjconv through the function and the CLI, read back; info; a FrameBatch.
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(out), \\
            contextlib.redirect_stderr(out):
        gro, xtc = os.path.join(d, "conf.gro"), os.path.join(d, "traj.xtc")
        write_gro(gro, top, State(coords=sc, box=PeriodicBox(np.diag([3.0] * 3))))
        headline.write_trajectory(xtc, sc, np.diag([3.0] * 3), 5)
        a, b = os.path.join(d, "a.dcd"), os.path.join(d, "b.dcd")
        assert trjconv(xtc, a, np.arange(60)) == 5
        assert cli.main(["trjconv", "-s", gro, "-f", xtc, "-o", b, "--select",
                         "resname ALA"]) == 0
        assert open(a, "rb").read() == open(b, "rb").read()
        with DcdHandler(a) as r:
            assert r.n_frames == 5 and r.read_frame(4).coords.shape == (60, 3)
        assert cli.main(["info"]) == (0 if torch.cuda.is_available() else 1)
    assert "wrote 5 frames x 60 atoms" in out.getvalue()
    fb = FrameBatch.from_states([State(coords=sc, box=PeriodicBox(np.diag([3.0] * 3)))] * 2,
                                pad_to=3).to("cpu")
    assert fb.n_frames == 3 and fb.valid.tolist() == [True, True, False]
    for name in ("cli", "ff.espaloma", "ff.onnx_mini", "ops.perception", "io.dcd",
                 "io.trjconv"):
        assert "molar_tpu_torch." + name in sys.modules, name
    # The user API: a PDB through System / Sel, the facade, DSSP, SASA and
    # an AnalysisTask over the PDB and an XTC.
    import molar_tpu_torch as mt
    from molar_tpu_torch.io import FileHandler
    from molar_tpu_torch.io.ndx import NdxFile
    from molar_tpu_torch.tasks.trajectory import AnalysisTask
    sys.path.insert(0, "tests")
    from torch_structures import scene_pdb
    with tempfile.TemporaryDirectory() as d:
        pdb, xtc = os.path.join(d, "conf.pdb"), os.path.join(d, "traj.xtc")
        open(pdb, "w").write(scene_pdb(seed=1))
        usys = mt.System.from_file(pdb)
        ca = usys("protein and name CA")
        assert isinstance(ca, mt.Sel) and len(ca) == 32 and ca.com().shape == (3,)
        assert ca.gyration() > 0 and ca.gyration(mt.PBC_FULL) > 0
        assert "HHHHHHHHHHHHHH" in usys("chain A").dssp() and usys("chain A").dss()
        near = usys("within 0.5 pbc of resname LIG")
        assert np.array_equal(near.indices, usys().within_of(
            0.5, usys("resname LIG"), mt.PBC_FULL).indices) and len(near) > 12
        assert usys("resname LIG").sasa().total_area() > 0
        for ext in ("gro", "xyz"):
            usys.save(os.path.join(d, "a." + ext))
            assert mt.System.from_file(os.path.join(d, "a." + ext)).n_atoms == usys.n_atoms
        NdxFile({"ca": ca.indices}).write(os.path.join(d, "i.ndx"))
        assert NdxFile.read(os.path.join(d, "i.ndx"))["ca"].tolist() == ca.indices.tolist()
        with FileHandler(xtc, "w") as fh:
            for k in range(3):
                usys.state.time = float(k)
                fh.write(usys.topology, usys.state)

        class Rg(AnalysisTask):
            def pre_process(self):
                self.rg = []

            def process_frame(self):
                self.rg.append(self.src("protein").gyration())

        rg = Rg()
        assert rg.run(["-f", pdb, xtc, "--log", "0"]).consumed_frames == 3 and len(rg.rg) == 3
    for name in ("io", "io.base", "io.pdb", "io.xyz", "io.ndx", "ops.dssp", "ops.dss",
                 "ops.sasa_host", "ops.seq_align"):
        assert "molar_tpu_torch." + name in sys.modules, name
    # The rest of the host half: a TRR, a NetCDF and an SDF written and read
    # back, perception and GAFF typing, a mesh, a TPR from the pure decoder, a
    # host Membrane frame folded by MembraneDevice(membrane), molar-torch last.
    from molar_tpu_torch.membrane import Membrane, MembraneDevice
    from torch_molecules import ligand_corpus, molecule_system
    import torch_gromacs
    with tempfile.TemporaryDirectory() as d:
        for ext in ("trr", "nc"):
            with FileHandler(os.path.join(d, "t." + ext), "w") as fh:
                for k in range(3):
                    usys.state.time = float(k)
                    fh.write(usys.topology, usys.state)
            with FileHandler(os.path.join(d, "t." + ext)) as fh:
                assert len(list(fh)) == 3
        lig = molecule_system(*ligand_corpus(1, seed=2)[0])
        lig.save(os.path.join(d, "l.sdf"))
        back = mt.System.from_file(os.path.join(d, "l.sdf"))
        assert len(back.apply_ff("gaff2")) == back.n_atoms and back.perceive().rings
        verts, tris = back("all").sas_mesh(spacing=0.1)
        assert len(tris) > 0
        n, _ = torch_gromacs.molecule_counts(2)
        torch_gromacs.write_tpx(os.path.join(d, "t.tpr"), np.ones((n, 3)), None,
                                np.diag([3.0] * 3), 2)
        assert mt.System.from_file(os.path.join(d, "t.tpr")).n_atoms == n
        usys.save(os.path.join(d, "s.pdb"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            assert cli.main(["last", "-f", os.path.join(d, "s.pdb"), os.path.join(d, "t.trr"), "-o",
                             os.path.join(d, "last.gro")]) == 0
        assert "wrote last frame (t=2.0)" in out.getvalue()
        memb = Membrane(lsys, toml)
        memb.compute()
        dev = MembraneDevice(memb, engine="cpu")
        dev.accumulate(dev.compute_window(lsys.state.coords[None, dev.subset]))
        assert memb.groups["all"].per_species["LIP"]["area"].n == 2
    for name in ("io.trr", "io.netcdf_amber", "io.sdf", "io.tpr", "io.tpx", "ff.gaff",
                 "ops.surface", "ops.voronoi", "membrane.membrane"):
        assert "molar_tpu_torch." + name in sys.modules, name
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu")
              and sys.modules[m] is not None]
    assert not leaked, leaked
    print("OK", int(count[5]))
    """
)


def test_port_runs_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_WITHOUT_JAX], cwd=REPO, capture_output=True,
        text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|molar_tpu)(\.|\s|$)", re.M)


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_kernel_source_is_cuda_for_hopper():
    from molar_tpu_torch import build

    for name, replaces in (("cell_bin.cu", "neighbor_pallas.py:within_ghost_pallas"),
                           ("within_ghost.cu", "neighbor_pallas.py:_ghost_kernel"),
                           ("within_rows.cu", "neighbor_pallas.py:_kernel")):
        src = (PORT / "csrc" / name).read_text()
        assert "__global__" in src and 'extern "C"' in src
        assert replaces in src
        assert PORT / "csrc" / name in build.KERNEL_SOURCES
    # Every file under csrc/ is a kernel source the build compiles and checks
    # for staleness: a header would have to enter that check with it.
    assert sorted((PORT / "csrc").iterdir()) == sorted(build.KERNEL_SOURCES)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR == REPO / "build" / "molar_tpu_torch"
