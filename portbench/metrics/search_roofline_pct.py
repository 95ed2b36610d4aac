"""Share of the roofline of the within search that ``FitWithinWindow.masks``
takes on a resident window: the least time the card could take (the larger
of the bytes over the HBM peak and the FLOPs over the float32 peak; the
work counted from the frames by ``harness/work.py``) over the time of the
call (CUDA events)."""

from portbench.harness.roofline import share


def read(run):
    return share(run, "search", "search_roofline_pct")
