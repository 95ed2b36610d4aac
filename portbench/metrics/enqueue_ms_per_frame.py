"""Host ms a frame the window module's host side takes to enqueue its work
(``WindowPipeline``'s ``enqueue``: the call of ``FitWithinWindow`` or
``workloads.Sasa`` on each window), over the window's frames."""


def read(run):
    if "enqueue" not in run.spans or not run.frames:
        return None
    return 1e3 * run.spans["enqueue"] / run.frames
