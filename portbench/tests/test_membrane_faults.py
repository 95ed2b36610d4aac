"""The membrane cell's comparison sees the faults it can have: each is planted
under a tiny CPU run of the cell, and the run must come out not correct.
The faults: in ``MembraneWindow.forward``, a window that returns the
previous window's outputs (a stale window) and one lipid's area altered
where it is produced; in ``MembraneDevice.accumulate``, a fold that leaves
out one valid lipid a frame, while the outputs the stream returns are
right."""

from __future__ import annotations

import pytest
import torch

from conftest import run_cell

CELL = "charmm36_popc_4608.membrane"


@pytest.fixture(autouse=True)
def _small_windows(monkeypatch):
    """Windows of 4 frames, so that a stale window differs from its own."""
    from portbench.harness import spec

    traffic = spec.traffic
    monkeypatch.setattr(spec, "traffic", lambda name: {**traffic(name), "window": 4})
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _broken(forward, fault):
    last = []

    def broken(self, *args):
        out = forward(self, *args)
        if fault == "stale":
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        area = out["area"].clone()
        area[:, 0] += 0.01  # 1.5 % of a lipid's area, on one lipid a frame
        return {**out, "area": area}

    return broken


def _fold_missing_a_lipid(accumulate):
    def broken(self, outs):
        valid = outs["valid"].copy()
        valid[:, 0] = False
        return accumulate(self, {**outs, "valid": valid})

    return broken


@pytest.mark.parametrize("fault", ["stale", "altered", "fold"])
def test_membrane_faults(tiny_bench, monkeypatch, fault):
    from molar_tpu_torch.membrane.device import MembraneDevice, MembraneWindow

    if fault == "fold":
        monkeypatch.setattr(MembraneDevice, "accumulate",
                            _fold_missing_a_lipid(MembraneDevice.accumulate))
    else:
        monkeypatch.setattr(MembraneWindow, "forward", _broken(MembraneWindow.forward, fault))
    res = run_cell(tiny_bench, CELL)
    assert not res["correct"], res["checks"]
    failed = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    if fault == "altered":
        assert "area_err_nm2" in failed
    if fault == "fold":  # only the fold's checks see it
        assert "group_count_err" in failed
        assert all(k.startswith("group_") for k in failed), failed
