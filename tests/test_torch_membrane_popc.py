"""The all-atom CHARMM36 POPC bilayer through the port's membrane path on the
CPU, held against the benchmark's plain float64 reference
(``portbench/reference/membrane.py``).

The bilayer is ``portbench/tiny/charmm36_popc_4608.json`` (72 POPC of 134
atoms, 8 frames, the cell's TOML: cutoff 2.5 nm, ``scdcorr``, leaflets
``upper`` / ``lower``, both tails with the oleoyl C29=C210 double bond).
Its run is the cell's driver on the CPU: ``System.from_file``,
``Membrane(system, toml)``, ``split_leaflets``, ``stream_membrane`` through
``MembraneDevice``, then every frame of the sampled windows against the
reference within the cell's limits. Also: the membrane stream's spans and
counter, and a GRO of more rows than its atom-number column holds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from molar_tpu_torch.config import set_default_device
from molar_tpu_torch.core.system import System
from molar_tpu_torch.membrane import Membrane, MembraneDevice, split_leaflets
from molar_tpu_torch.tasks.trajectory import TrajectoryReader
from molar_tpu_torch.workloads import stream_membrane
from portbench.drivers import stream_membrane as driver
from portbench.drivers.common import pipelines
from portbench.frozen import systems
from portbench.harness import bilayer, spec

CONFIG = "charmm36_popc_4608"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = set_default_device("cpu")
    yield
    set_default_device(old)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cell's driver on the CPU at the tiny size, windows of 4 frames,
    after one timed second: (driver, its checks)."""
    traffic = {**spec.traffic("membrane"), "window": 4}
    drv = driver.Driver(spec.tiny_config(CONFIG), traffic, 2**31 + 5, "cpu",
                        tmp_path_factory.mktemp("popc"))
    drv.setup()
    drv.window(1.0)
    return drv, drv.check()


def test_the_port_against_the_reference(run):
    drv, checks = run
    assert drv.frames >= 8
    for c in checks:
        assert c.ok, (c.name, c.value, c.limit)


def test_what_the_lipid_forces(run):
    """Both tails' order parameters (13 and 15 values, the double bond's
    carbons among them), every lipid valid, nonzero curvature."""
    drv, _ = run
    got = next(iter(drv.answers.values()))[0]
    sn1, sn2 = got["order"]
    assert sn1.shape == (72, 13) and sn2.shape == (72, 15)
    assert np.isfinite(sn2).all() and np.abs(sn2[:, 6:8]).max() > 0
    assert got["valid"].all()
    assert np.abs(got["mean_curv"]).max() > 1e-3
    assert drv.groups["upper"].sum() == drv.groups["lower"].sum() == 36


def test_the_membrane_stream_spans_and_counter(run):
    """``stream_membrane``'s pipeline carries the fold's span, the valid
    lipid-frames counter and the window function's ``membrane.*`` stages."""
    drv, _ = run
    dev = MembraneDevice(drv.membrane, device="cpu")
    with pipelines() as made:
        frames, outs = stream_membrane(dev, TrajectoryReader([drv.xtc]), 4)
    t = made[0].timings
    assert frames == 8 and t["membrane.fold"] > 0
    assert t["membrane.valid_lipid_frames"] == sum(int(o["valid"].sum()) for o in outs)
    for stage in ("unwrap_markers", "patches", "normals", "smooth", "smooth.fit",
                  "smooth.voronoi", "order"):
        assert t[f"membrane.{stage}"] > 0, stage


def test_a_gro_past_the_atom_number_column(tmp_path):
    """800 POPC, 107,200 rows: the GRO's atom numbers wrap at 100,000; every
    row reads back, and the membrane splits into its two leaflets."""
    cfg = spec.tiny_config(CONFIG)
    side = 20
    cfg = {**cfg, "atoms": 2 * side * side * 134,
           "composition": {"POPC": 2 * side * side},
           "box": {**cfg["box"], "sides_nm": [side * 0.645 ** 0.5] * 2 + [8.0]},
           "bilayer": {**cfg["bilayer"], "lipids_a_leaflet_side": side}}
    s = bilayer.build(cfg)
    path = tmp_path / "big.gro"
    systems.write_gro(path, s["labels"], s["coords"], s["box"], "POPC")
    system = System.from_file(str(path), device="cpu")
    assert system.n_atoms == 107_200
    np.testing.assert_allclose(system.state.coords, s["coords"], atol=6e-4)
    toml = (f'cutoff = 2.5\ngroups = ["upper", "lower"]\n[lipids.POPC]\n'
            f'whole = "resname POPC"\nhead = "name P"\nmid = "name C2"\n'
            f'tails = ["{bilayer.SN1_TAIL}", "{bilayer.SN2_TAIL}"]\n')
    upper, lower = split_leaflets(Membrane(system, toml))
    assert len(upper) == len(lower) == side * side
    assert set(upper) == set(np.flatnonzero(s["leaflet"] > 0))
