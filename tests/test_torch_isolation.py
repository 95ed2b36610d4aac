"""The port stands without JAX: the machine with the card has no JAX, and any
``molar_tpu`` import reaches the JAX package's import-time pytree
registration. A subprocess with both blocked imports every module of the
port and runs the headline slice at a tiny size on the CPU, through the
ghost and row routes and, on a rhombic dodecahedron, the correction path,
the selection workloads (the SASA one among them) over subset windows,
``ops/sasa_lr`` and ``ops/sasa`` on a small cluster, and the membrane
pipeline (``membrane/*``) with ``tasks/engine`` on a small bilayer; a
static scan finds no JAX or ``molar_tpu`` import in the port or in
``chip_smoke.py``.
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
