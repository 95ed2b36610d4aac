"""Stream ms a frame of the neighbour-list stage of ``workloads.Sasa``:
the program's span ``sasa.lists``, the stream time between its two CUDA
events (``sasa.lists@device``), over the window's frames. That is the
stage's device time plus the idle between its kernels, where the device
runs behind the host, as in the SASA cell."""


def read(run):
    if "sasa.lists@device" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["sasa.lists@device"] / run.frames
