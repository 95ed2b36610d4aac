"""The plain references against the port on the CPU at tiny sizes, and one
tiny run of each traffic mix through the whole harness, ``correct`` true."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench.frozen import systems
from portbench.reference import geometry
from portbench.reference import sasa as ref_sasa

from conftest import CELLS, run_cell


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_fit_rmsd_against_the_port():
    from molar_tpu_torch.ops.measure import fit_rmsd

    rng = np.random.default_rng(1)
    ref = rng.normal(size=(200, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))
    mob = (ref @ rot.T + 0.3 + rng.normal(0, 0.05, ref.shape)).astype(np.float32)
    m = rng.uniform(1, 16, 200).astype(np.float32)
    want, r, t = geometry.fit_rmsd(*(torch.as_tensor(a, dtype=torch.float64)
                                     for a in (mob, ref, m)))
    got = fit_rmsd(torch.as_tensor(mob)[None], torch.as_tensor(ref), torch.as_tensor(m))[0]
    assert float(got[0]) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(r.numpy(), rot.T, atol=0.05)


@pytest.mark.parametrize("shape", ["orthorhombic", "dodecahedron"])
def test_min_distance_against_all_images(shape):
    box = (np.diag([2.3, 2.0, 2.6]) if shape == "orthorhombic"
           else systems.dodecahedron(2.4)).astype(np.float64)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 3, (400, 3))
    src = np.arange(0, 400, 7)
    got = geometry.min_distance(torch.as_tensor(x), src, box, 0.6).numpy()
    shifts = np.array(list(itertools.product(range(-2, 3), repeat=3))) @ box.T
    d = x[:, None, None, :] - x[None, src, None, :] - shifts[None, None]
    want = np.sqrt((d * d).sum(-1)).min(axis=(1, 2))
    close = want <= 0.6
    # The matrix product's d^2 carries ~1e-15 nm^2 of cancellation: exact
    # near the cutoff, ~1e-7 nm in d only near 0.
    np.testing.assert_allclose(got[close] ** 2, want[close] ** 2, atol=1e-12)
    assert (got[~close] > 0.6).all()


def test_sasa_against_the_port():
    from molar_tpu_torch.ops import sasa_lr

    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1.6, (120, 3))
    r = rng.uniform(0.25, 0.33, 120)
    nbr, _ = sasa_lr.neighbor_lists(x, r, cap=64)
    want = sasa_lr.sasa(torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(nbr),
                        n_slices=32).numpy()
    got = ref_sasa.atom_areas(torch.as_tensor(x), torch.as_tensor(r), 32).numpy()
    # The port's arcs take pi as float32 rounds it; the reference takes pi.
    np.testing.assert_allclose(got, want, atol=1e-6)
    # A lone sphere: 32 slabs of an exact band area 2 pi R dz each.
    one = ref_sasa.atom_areas(torch.zeros(1, 3, dtype=torch.float64),
                              torch.tensor([0.3], dtype=torch.float64), 32)
    assert float(one[0]) == pytest.approx(4 * np.pi * 0.09)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct(tiny_bench, cell):
    res = run_cell(tiny_bench, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_tiny_traced_run_reads_the_untraced_rate(tiny_bench):
    """A cell with a per-layer metric read from the host clock: the traced
    run measures an untraced window first, and reports its rate (the
    cell's readers of device timings need a card, so only the host clock's
    are kept here)."""
    import contextlib
    import copy
    import io
    import json

    from portbench import run

    cell = "rnase_dodec.align_within"
    bench = copy.deepcopy(tiny_bench)
    bench["per_layer"] = [m for m in bench["per_layer"] if m["source"] == "host_clock"]
    assert any(cell in m["workloads"] for m in bench["per_layer"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "1", "--trace", "1"],
                      card_check=False, bench=bench)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"], res["checks"]
    assert res["metrics"]["stream_fps.skewed"]["value"] > 0
