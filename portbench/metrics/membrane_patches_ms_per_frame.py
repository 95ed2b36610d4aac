"""Stream ms a frame of the patch search of ``membrane.device.MembraneWindow``
(the head markers' adjacency within the cutoff and its top-K table): the
program's span ``membrane.patches``, the stream time between its two CUDA
events (``membrane.patches@device``), over the window's frames. That is the
stage's device time plus the idle between its kernels where the device runs
behind the host, as in the membrane cell."""


def read(run):
    if "membrane.patches@device" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["membrane.patches@device"] / run.frames
