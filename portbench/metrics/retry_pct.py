"""Share of the window that the overflow retry takes: the program's span
``retry`` (``run_with_overflow_retry`` re-reading, copying and re-running
the windows whose tier overflowed, after the pipeline) over the window."""


def read(run):
    if "retry" not in run.spans or not run.window_s:
        return None
    return 100.0 * run.spans["retry"] / run.window_s
