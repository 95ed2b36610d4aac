"""Share of the roofline of the membrane analysis that
``membrane.device.MembraneWindow.forward`` takes on a resident window: the
least time the card could take (the larger of the bytes over the HBM peak
and the FLOPs over the float32 peak; the work counted from the window's
head markers and patches by ``harness/membrane_work.py``) over the time of
the call (CUDA events)."""

from portbench.harness.roofline import share


def read(run):
    return share(run, "membrane", "membrane_roofline_pct")
