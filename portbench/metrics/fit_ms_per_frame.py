"""Device ms a frame of ``ops.measure.fit_rmsd`` on a resident window of the
cell's frames (CUDA events over many calls)."""


def read(run):
    return run.device_ms("fit")
