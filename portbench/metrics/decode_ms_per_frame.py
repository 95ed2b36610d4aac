"""Host ms a frame in the XTC codec (``io.xtc``, the feeder thread's decode):
``TrajectoryReader.timings["decode"]`` over the window's frames."""


def read(run):
    if "decode" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["decode"] / run.frames
