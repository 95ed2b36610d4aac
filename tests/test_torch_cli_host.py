"""The port's ``molar-torch`` host subcommands (``last``, ``rearrange``,
``solvate``, ``tip3to4``, ``membrane``) against ``molar_tpu.cli.main``, on
the CPU.

Each case runs both command lines on the same inputs, each writing into its
own directory: the return codes, what each prints on stdout and its
``error:`` lines on stderr are equal (with the directory names swapped), and
every file written is byte-equal. The errors: overlapping selections, no
selection, a solute without a box, no solvent file, a solute that leaves no
solvent, a structure without TIP3 waters (the empty selection's error,
raised alike), a trajectory alone (no topology) and one that cannot be read.
The port's ``solvate`` and ``membrane`` run here with ``--device cpu``
(their host route); their card route, driven on CPU tensors by replacing
the route test, writes the same solvated files and membrane files within
``workloads.MEMBRANE_TOL`` of the JAX CLI's.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu import cli as ref_cli
from molar_tpu.core import Atom as RefAtom
from molar_tpu.core import State as RefState
from molar_tpu.core import Topology as RefTopology

from molar_tpu_torch.config import set_default_device
from molar_tpu_torch import cli, config

from test_cli import _make_water_box
from test_membrane import TOML, make_bilayer
from torch_scenes import membrane_file_diffs
from torch_structures import scene_pdb


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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    (d / "conf.pdb").write_text(scene_pdb(seed=4, n_water=12, n_ligand=1))
    system = molar_tpu.System.from_file(str(d / "conf.pdb"))
    system.save(str(d / "conf.gro"))
    rng = np.random.default_rng(3)
    for ext in ("xtc", "trr", "nc"):
        with molar_tpu.io.FileHandler(str(d / f"traj.{ext}"), "w") as fh:
            for k in range(4):
                st = system.state.copy()
                st.coords = (st.coords + rng.normal(0, 0.02, st.coords.shape)).astype(np.float32)
                st.time, st.step = 2.0 * k, k
                fh.write(system.topology, st)
    _make_water_box(d / "water.gro")
    atoms = [RefAtom(name="C", resname="LIG", resid=1).guess_element_and_mass()
             for _ in range(4)]
    lig = molar_tpu.System(RefTopology.from_atoms(atoms), RefState(
        coords=np.array([[1.5, 1.5, 1.5], [1.6, 1.5, 1.5], [1.5, 1.6, 1.5], [1.5, 1.5, 1.6]],
                        np.float32), box=molar_tpu.PeriodicBox(np.diag([3.0, 3.0, 3.0]))))
    lig.save(str(d / "lig.gro"))
    lig.save(str(d / "lig.xyz"))  # no box
    # a solute filling its box: every solvent residue overlaps it
    g = (np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5)
    atoms = [RefAtom(name="C", resname="LIG", resid=1).guess_element_and_mass()
             for _ in range(len(g))]
    molar_tpu.System(RefTopology.from_atoms(atoms), RefState(
        coords=(g * 0.2).astype(np.float32),
        box=molar_tpu.PeriodicBox(np.diag([1.6] * 3)))).save(str(d / "full.gro"))
    atoms, coords = [], []
    for rid in (1, 2, 3):
        base = np.array([rid * 0.5, 0.5, 0.5])
        for name, off in (("OH2", [0, 0, 0]), ("H1", [0.095, 0, 0]),
                          ("H2", [-0.024, 0.092, 0])):
            atoms.append(RefAtom(name=name, resname="TIP3", resid=rid).guess_element_and_mass())
            coords.append(base + off)
    atoms.append(RefAtom(name="NA", resname="NA", resid=4).guess_element_and_mass())
    coords.append([2.0, 2.0, 2.0])
    top = RefTopology.from_atoms([RefAtom(name="C", resname="LIG", resid=9)
                                  .guess_element_and_mass()] + atoms)
    top.assign_resindex()
    molar_tpu.System(top, RefState(coords=np.asarray([[0.1, 0.1, 0.1]] + coords, np.float32),
                                   box=molar_tpu.PeriodicBox(np.diag([3.0] * 3)))).save(
        str(d / "tip3.gro"))
    bilayer = make_bilayer(4, 4)
    bilayer.save(str(d / "bilayer.gro"))
    with molar_tpu.io.FileHandler(str(d / "bilayer.xtc"), "w") as fh:
        for k in range(3):
            st = bilayer.state.copy()
            st.coords = (st.coords + rng.normal(0, 0.02, st.coords.shape)).astype(np.float32)
            st.time = float(k)
            fh.write(bilayer.topology, st)
    return d


def run_both(capsys, tmp_path, argv):
    """Both command lines with ``{in}`` / ``{out}`` filled in, each into its
    own output directory -> (ref, mine): (rc, stdout, error lines, files).
    The port's ``solvate`` and ``membrane`` get ``--device cpu``: their host
    route, which the JAX CLI's output is held to."""
    results = []
    for tag, main in (("ref", ref_cli.main), ("mine", cli.main)):
        out = tmp_path / tag
        out.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(out)) for a in argv]
        if tag == "mine" and args[0] in ("solvate", "membrane"):
            args += ["--device", "cpu"]
        try:
            rc = main(args)
        except Exception as e:  # the same exception in both is the same error
            rc = f"{type(e).__name__}: {e}"
        cap = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(out.iterdir()) if p.is_file()}
        results.append((rc, cap.out.replace(str(out), "OUT"),
                        [line.replace(str(out), "OUT") for line in cap.err.splitlines()
                         if line.startswith("error:")], files))
    return results


def argv_of(inputs, *parts):
    return [p.replace("{in}", str(inputs)) for p in parts]


CASES = {
    "last_xtc": ("last", "-f", "{in}/conf.gro", "{in}/traj.xtc", "-o", "{out}/last.gro"),
    "last_trr_pdb": ("last", "-f", "{in}/conf.pdb", "{in}/traj.trr", "-o", "{out}/last.pdb"),
    "last_nc_swapped": ("last", "-f", "{in}/traj.nc", "{in}/conf.gro", "-o", "{out}/last.gro"),
    "last_one_file": ("last", "-f", "{in}/conf.gro", "-o", "{out}/last.pdb"),
    "last_trr_alone_refused": ("last", "-f", "{in}/traj.trr", "-o", "{out}/last.gro"),
    "rearrange": ("rearrange", "-f", "{in}/conf.pdb", "-o", "{out}/re.pdb", "-b",
                  "resname LIG", "name CA", "-e", "resname SOL"),
    "rearrange_gro": ("rearrange", "-f", "{in}/conf.gro", "-o", "{out}/re.gro", "-e", "protein"),
    "rearrange_overlap": ("rearrange", "-f", "{in}/conf.pdb", "-o", "{out}/x.pdb", "-b",
                          "name CA", "-e", "protein"),
    "rearrange_none": ("rearrange", "-f", "{in}/conf.pdb", "-o", "{out}/x.pdb"),
    "solvate": ("solvate", "-f", "{in}/lig.gro", "-o", "{out}/solv.gro", "-s",
                "{in}/water.gro"),
    "solvate_exclude": ("solvate", "-f", "{in}/lig.gro", "-o", "{out}/solv.pdb", "-s",
                        "{in}/water.gro", "-x", "resname SOL and x < 1.0"),
    "solvate_no_box": ("solvate", "-f", "{in}/lig.xyz", "-o", "{out}/x.gro", "-s",
                       "{in}/water.gro"),
    "solvate_no_solvent": ("solvate", "-f", "{in}/lig.gro", "-o", "{out}/x.gro"),
    "solvate_nothing_left": ("solvate", "-f", "{in}/full.gro", "-o", "{out}/x.gro", "-s",
                             "{in}/water.gro"),
    "tip3to4": ("tip3to4", "-f", "{in}/tip3.gro", "-o", "{out}/tip4.gro"),
    "tip3to4_pdb": ("tip3to4", "-f", "{in}/tip3.gro", "-o", "{out}/tip4.pdb"),
    "tip3to4_empty": ("tip3to4", "-f", "{in}/conf.gro", "-o", "{out}/x.gro"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_subcommand_equals_the_reference(inputs, tmp_path, capsys, monkeypatch, case):
    monkeypatch.delenv("GMXDATA", raising=False)
    ref, mine = run_both(capsys, tmp_path, argv_of(inputs, *CASES[case]))
    assert mine == ref
    rc, out, errors, files = mine
    if case.endswith(("overlap", "none", "no_box", "no_solvent", "nothing_left")):
        assert rc == 1 and len(errors) == 1 and not files
    elif case.endswith("empty"):
        assert isinstance(rc, str) and "SelectionError" in rc
    elif case.endswith("refused"):  # a trajectory alone has no topology
        assert isinstance(rc, str) and "NotReadableError" in rc
    else:
        assert rc == 0 and files and out


def test_membrane_subcommand_equals_the_reference(inputs, tmp_path, capsys):
    for tag in ("ref", "mine"):
        (tmp_path / f"{tag}.toml").write_text(
            TOML.format(out=str(tmp_path / tag / "stats")).replace("name G", "name C1"))
    argv = ["membrane", "-f", str(inputs / "bilayer.gro"), str(inputs / "bilayer.xtc"),
            "-p", "{params}", "--vmd", "{out}/vis.tcl", "--log", "1"]
    got = []
    for tag, main in (("ref", ref_cli.main), ("mine", cli.main)):
        out = tmp_path / tag
        out.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(out)).replace("{params}", str(tmp_path / f"{tag}.toml"))
                for a in argv] + (["--device", "cpu"] if tag == "mine" else [])
        assert main(args) == 0
        text = capsys.readouterr().out.replace(str(out), "OUT")
        files = {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*"))
                 if p.is_file()}
        got.append((text, files))
    assert got[0] == got[1]
    assert "membrane analysis over 3 frames" in got[1][0]
    assert {"vis.tcl", os.path.join("stats", "stats_upper.dat"),
            os.path.join("stats", "order_lower_LIP.dat")} <= set(got[1][1])


@pytest.mark.parametrize("case", ["solvate", "solvate_exclude"])
def test_solvate_card_route_equals_the_reference(inputs, tmp_path, capsys, monkeypatch, case):
    """The overlap search through ``core/sel_device.search_pairs`` writes the
    JAX CLI's bytes."""
    monkeypatch.setattr(config, "on_host", lambda device: False)
    argv = argv_of(inputs, *CASES[case])
    out = {}
    for tag, main in (("ref", ref_cli.main), ("mine", cli.main)):
        (tmp_path / tag).mkdir()
        assert main([a.replace("{out}", str(tmp_path / tag)) for a in argv]) == 0
        out[tag] = {p.name: p.read_bytes() for p in (tmp_path / tag).iterdir()}
    assert out["mine"] == out["ref"] and out["mine"]


def test_membrane_card_route_is_within_the_bars(inputs, tmp_path, capsys, monkeypatch):
    """``MembraneDevice(membrane)`` over the windows (on CPU tensors): the
    same messages and files, their values within ``MEMBRANE_TOL`` of the
    JAX CLI's; ``--vmd``'s drawing of the last frame byte-equal to it."""
    monkeypatch.setattr(config, "on_host", lambda device: False)
    text, vmd = {}, {}
    for tag, main in (("ref", ref_cli.main), ("mine", cli.main)):
        (tmp_path / f"{tag}.toml").write_text(
            TOML.format(out=str(tmp_path / tag)).replace("name G", "name C1"))
        vis = tmp_path / f"{tag}.tcl"
        assert main(["membrane", "-f", str(inputs / "bilayer.gro"), str(inputs / "bilayer.xtc"),
                     "-p", str(tmp_path / f"{tag}.toml"), "--log", "0",
                     "--vmd", str(vis)]) == 0
        text[tag] = capsys.readouterr().out.replace(str(tmp_path / tag), "OUT")
        vmd[tag] = vis.read_bytes()
    assert text["mine"] == text["ref"] and "over 3 frames" in text["mine"]
    worst = membrane_file_diffs(str(tmp_path / "ref"), str(tmp_path / "mine"))
    assert all(v <= 1.0 for v in worst.values()), worst
    assert vmd["mine"] == vmd["ref"] and vmd["mine"]


def test_unreadable_trajectory_and_help(inputs, tmp_path, capsys):
    bad = tmp_path / "bad.trr"
    bad.write_bytes(b"\0" * 200)
    argv = ["last", "-f", str(inputs / "conf.gro"), str(bad), "-o", str(tmp_path / "x.gro")]
    errors = []
    for main in (ref_cli.main, cli.main):
        with pytest.raises(Exception) as err:
            main(argv)
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1]
    assert cli.main([]) == 1
    assert "last" in capsys.readouterr().out
