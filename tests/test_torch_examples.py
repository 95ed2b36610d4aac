"""The port's six examples (``python -m molar_tpu_torch.examples.<name>``)
run end to end on generated inputs (``torch_scenes.example_inputs``), on the
CPU: the per-frame RMSDs and contact counts equal the JAX package's
``examples/`` scripts' on the same files (RMSD within 1e-5), the report,
the membrane files, the TIP4 conversion and the typed molecule are there.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import runpy
import sys

import numpy as np
import pytest
import torch

import molar_tpu_torch as mt
from molar_tpu_torch.config import set_default_device

from torch_scenes import example_argv, example_inputs

EXAMPLES = ["rmsd_trajectory", "contacts", "structure_report", "membrane_curvature",
            "tip3to4_tutorial", "assign_ff"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module, and the CPU as the device of
    ``device=None``; both restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = set_default_device("cpu")
    yield
    set_default_device(old)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return example_inputs(str(tmp_path_factory.mktemp("examples")))


def run_example(name: str, argv) -> str:
    """``main(argv)`` of the port's example -> its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert importlib.import_module(f"molar_tpu_torch.examples.{name}").main(argv) == 0
    return out.getvalue()


def run_reference(name: str, argv) -> str:
    """The JAX package's ``examples/<name>.py`` as a script -> its stdout."""
    out, old = io.StringIO(), sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
            runpy.run_path(f"examples/{name}.py", run_name="__main__")
        assert e.value.code in (0, None)
    finally:
        sys.argv = old
    return out.getvalue()


def _rows(text: str) -> np.ndarray:
    return np.array([[float(v) for v in line.split("\t")] for line in text.splitlines()
                     if "\t" in line])


@pytest.mark.parametrize("name", ["rmsd_trajectory", "contacts"])
def test_window_examples_equal_the_reference(inputs, name):
    argv = example_argv(inputs)[name]
    got, want = _rows(run_example(name, argv)), _rows(run_reference(name, argv))
    assert got.shape == want.shape == (6, 2)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    if name == "contacts":
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        assert (got[:, 1] > 0).all()
    else:
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-5)
        assert (got[:, 1] < 0.05).all()


def test_structure_report(inputs):
    out = run_example("structure_report", example_argv(inputs)["structure_report"])
    assert "SASA:" in out and "volume:" in out and "DSSP:" in out and "SES mesh:" in out
    with open(inputs["obj"]) as fh:
        assert fh.readline().startswith("# molar_tpu")


def test_membrane_curvature(inputs):
    out = run_example("membrane_curvature", example_argv(inputs)["membrane_curvature"])
    assert "3 frames" in out
    with open(f"{inputs['membrane_out']}/stats_all.dat") as fh:
        assert fh.read().count("LIP ") == 1


def test_membrane_curvature_draws_the_reference_s_last_frame(inputs, tmp_path):
    """``--vmd`` after the card's windows: the drawing of the last frame
    byte-equal to the JAX example's, which runs the host pipeline frame by
    frame."""
    argv = example_argv(inputs)["membrane_curvature"]
    run_example("membrane_curvature", [*argv, "--vmd", str(tmp_path / "mine.tcl")])
    run_reference("membrane_curvature", [*argv, "--vmd", str(tmp_path / "ref.tcl")])
    mine = (tmp_path / "mine.tcl").read_bytes()
    assert mine and mine == (tmp_path / "ref.tcl").read_bytes()


def test_tip3to4_tutorial(inputs):
    out = run_example("tip3to4_tutorial", example_argv(inputs)["tip3to4_tutorial"])
    assert "3 waters converted" in out
    conv = mt.System(inputs["tip4"])
    assert conv.n_atoms == 2 + 3 * 4
    m, o = conv("name M"), conv("resname TIP4 and name OW")
    assert len(m) == 3 and set(m.resnames) == {"TIP4"}
    np.testing.assert_allclose(np.linalg.norm(m.coords - o.coords, axis=1), 0.01546, atol=1e-3)


def test_assign_ff(inputs):
    out = run_example("assign_ff", example_argv(inputs)["assign_ff"])
    head, *atoms = out.strip().splitlines()
    assert "rings" in head and len(atoms) > 10
    assert abs(sum(float(line.split()[-1]) for line in atoms)) < 1e-2


def test_every_example_is_covered():
    import molar_tpu_torch.examples as ex
    import pkgutil

    assert sorted(m.name for m in pkgutil.iter_modules(ex.__path__)) == sorted(EXAMPLES)
