"""Share of the roofline of Lee-Richards SASA that ``workloads.Sasa.forward``
takes on a resident window: the least time the card could take (FLOPs of
the overlapping pairs times the slices over the float32 peak, or the bytes
over the HBM peak) over the time of the call (CUDA events)."""

from portbench.harness.roofline import share


def read(run):
    return share(run, "sasa", "sasa_roofline_pct")
