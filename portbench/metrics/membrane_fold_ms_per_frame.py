"""Host ms a frame that ``workloads.stream_membrane`` spends folding each
window into the leaflets' statistics once the window's device work has
finished (its outputs copied to the host, then ``MembraneDevice.accumulate``):
the program's span ``membrane.fold`` over the window's frames. The device
waits for it: the next window is enqueued after the fold."""


def read(run):
    if "membrane.fold" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["membrane.fold"] / run.frames
