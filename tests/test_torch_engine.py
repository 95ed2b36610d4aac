"""tasks.engine: engine selection from the crossover measured on the card.

The port's counterpart of ``tests/test_engine.py``: the floor, the window
that amortises it, the device each engine maps to, a ``"host"`` verdict
that lands on the CPU (never on the card, whatever device the caller
named), and ``MembraneDevice(engine="auto")`` equal to ``engine="device"``.
No JAX here: the membrane comes from ``workloads.synth_bilayer``.
"""

import numpy as np
import pytest
import torch

from molar_tpu_torch import workloads as wl
from molar_tpu_torch.membrane import MembraneDevice, MembraneError
from molar_tpu_torch.tasks import engine
from molar_tpu_torch.tasks.engine import (
    DEVICE_FLOPS_FLOOR, accelerator_device, cpu_device, engine_device, pick_engine,
)


@pytest.fixture
def with_card(monkeypatch):
    """Pretend a card is there (for the verdict only: nothing runs on it)."""
    monkeypatch.setattr(engine, "accelerator_device", lambda: torch.device("cuda", 0))


def test_pick_engine_thresholds(with_card):
    assert pick_engine(DEVICE_FLOPS_FLOOR / 10) == "cpu"
    assert pick_engine(DEVICE_FLOPS_FLOOR) == "device"
    assert pick_engine(DEVICE_FLOPS_FLOOR * 10) == "device"


def test_pick_engine_without_a_card_is_cpu():
    assert accelerator_device() is None
    assert pick_engine(DEVICE_FLOPS_FLOOR * 10) == "cpu"


def test_pick_engine_window_amortization(with_card):
    f = DEVICE_FLOPS_FLOOR / 3
    assert pick_engine(f, 1) == "cpu"
    assert pick_engine(f, 4) == "device"
    assert pick_engine(f, 0) == "cpu"  # a window has at least one frame


def test_engine_device_mapping():
    assert engine_device("host") == engine_device("cpu") == cpu_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_device("device")
    for name in ("auto", "gpu"):
        with pytest.raises(ValueError):
            engine_device(name)


@pytest.fixture(scope="module")
def bilayer():
    b = wl.synth_bilayer(3, 3)
    window = b.frames(4)[:, b.spec.subset]
    return b, window


def _device(b, engine_name, device="cpu"):
    return MembraneDevice(b.spec, b.coords, b.box, engine=engine_name, device=device)


def _flat(outs):
    for k in sorted(outs):
        v = outs[k]
        if isinstance(v, dict):
            for sp in sorted(v):
                yield from ((f"{k}.{sp}.{i}", t) for i, t in enumerate(v[sp]))
        else:
            yield k, v


def test_membrane_auto_engine_matches_device(bilayer, capsys):
    b, window = bilayer
    outs = {}
    for name in ("device", "auto"):
        dev = _device(b, name)
        assert dev.engine_resolved == (None if name == "auto" else "device")
        outs[name] = dev.compute_window(window)
        if name == "auto":
            # 18 lipids x 4 frames is far below the floor (and there is no card)
            assert dev.engine_resolved == "cpu" and dev.device == torch.device("cpu")
            assert "engine auto -> cpu" in capsys.readouterr().err
    got, want = dict(_flat(outs["auto"])), dict(_flat(outs["device"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_host_verdict_lands_on_the_cpu(bilayer, monkeypatch):
    """The reference's ``"host"`` verdict left its arrays on the
    accelerator; here a host verdict runs on the CPU even when the caller
    named a card."""
    b, window = bilayer
    monkeypatch.setattr(engine, "pick_engine", lambda flops, frames: "host")
    dev = _device(b, "auto", device="cuda")
    out = dev.compute_window(window)
    assert dev.engine_resolved == "host" and dev.device == torch.device("cpu")
    want = _device(b, "cpu").compute_window(window)
    np.testing.assert_array_equal(out["area"], want["area"])


def test_membrane_engine_rejects_unknown(bilayer):
    b, _ = bilayer
    with pytest.raises(MembraneError):
        _device(b, "fastest")


def test_per_frame_flops_is_the_references_estimate(bilayer):
    b, _ = bilayer
    dev = _device(b, "cpu")
    L, K = dev.n_lipids, dev.patch_cap
    assert dev._per_frame_flops() == L * (10.0 * L + 40.0 * K * K + 1000.0)
