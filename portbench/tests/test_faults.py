"""The comparison that decides ``correct`` sees the faults a cell can have:
each is planted in the program under a tiny CPU run, and the run must come
out not correct. The faults: a step that returns its state unchanged (the
previous window's answers), half of the batch left out (the rest's mean in
its place), and an answer altered where it is produced. A one-chip cell
has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from conftest import run_cell

FAULTS = ("stale", "half", "altered")


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


def _broken_window(forward, fault):
    """``forward`` of a window module with ``fault`` planted in its answers
    (a tuple of per-frame tensors, the first the one altered)."""
    last = []

    def broken(self, *args):
        out = forward(self, *args)
        if fault == "stale":
            prev = last[0] if last and last[0][0].shape == out[0].shape else out
            last[:] = [out]
            return prev
        if fault == "half":
            h = max(1, out[0].shape[0] // 2)
            first = out[0][:h]
            fill = first.float().mean(dim=0, keepdim=True).to(first.dtype)
            head = torch.cat([first, fill.expand(out[0].shape[0] - h, *first.shape[1:])])
            return (head, *out[1:])
        new = out[0].clone()
        new.view(new.shape[0], -1)[0, 0] += 1e-3 if new.is_floating_point() else 1
        return (new, *out[1:])

    return broken


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["apoa1_92k.align_within", "rnase_dodec.align_within"])
def test_fit_within_faults(tiny_bench, monkeypatch, cell, fault):
    from molar_tpu_torch.headline import FitWithinWindow

    monkeypatch.setattr(FitWithinWindow, "forward",
                        _broken_window(FitWithinWindow.forward, fault))
    assert not run_cell(tiny_bench, cell)["correct"]


def test_fit_within_search_answer_altered(tiny_bench, monkeypatch):
    """One atom's membership changed in the mask the window produces."""
    from molar_tpu_torch.headline import FitWithinWindow

    masks = FitWithinWindow.masks

    def broken(self, *args):
        m, ofl = masks(self, *args)
        m = m.clone()
        m[0, -1] = ~m[0, -1]
        return m, ofl

    monkeypatch.setattr(FitWithinWindow, "masks", broken)
    res = run_cell(tiny_bench, "apoa1_92k.align_within")
    assert not res["correct"] and res["checks"]["within_frames_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_sasa_faults(tiny_bench, monkeypatch, fault):
    from molar_tpu_torch.workloads import Sasa

    monkeypatch.setattr(Sasa, "forward", _broken_window(Sasa.forward, fault))
    assert not run_cell(tiny_bench, "apoa1_92k.sasa")["correct"]
