"""Frames a second of the cell's stream over an untraced window, as the
end-to-end rate ``fps`` takes it (frames whose results reached the host over
the window's seconds), read per layer where the rate spreads too widely
from run to run to hold a bound: the traced run measures that window before
its traced one."""


def read(run):
    return run.untraced.get("fps")
