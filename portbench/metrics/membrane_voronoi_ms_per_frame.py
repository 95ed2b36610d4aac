"""Stream ms a frame of the Voronoi stage of ``membrane.device.MembraneWindow``
(each lipid's cell among its patch by candidate vertices, its edges and its
lifted area): the program's span ``membrane.smooth.voronoi``, the stream
time between its two CUDA events (``membrane.smooth.voronoi@device``), over
the window's frames."""


def read(run):
    if "membrane.smooth.voronoi@device" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["membrane.smooth.voronoi@device"] / run.frames
