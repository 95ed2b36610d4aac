"""Host ms a frame the within search takes to enqueue inside the window
module: the program's span ``fit_within.search`` (the whole
``FitWithinWindow.masks`` call, the correction route's frame-by-frame
launches included) over the window's frames."""


def read(run):
    if "fit_within.search" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["fit_within.search"] / run.frames
