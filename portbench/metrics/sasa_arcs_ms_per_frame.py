"""Stream ms a frame of the arc stage of ``workloads.Sasa`` (the
``ops.sasa_lr.sasa`` call: exposed arcs, their sort and union): the
program's span ``sasa.arcs``, the stream time between its two CUDA events
(``sasa.arcs@device``), over the window's frames. That is the stage's
device time plus the idle between its kernels, where the device runs
behind the host, as in the SASA cell."""


def read(run):
    if "sasa.arcs@device" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["sasa.arcs@device"] / run.frames
