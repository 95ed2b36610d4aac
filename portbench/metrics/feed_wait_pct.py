"""Share of the window in which the consumer of ``WindowPipeline`` waited for
the next window (its ``get_wait``): above half, the feeder sets the pace."""


def read(run):
    if "get_wait" not in run.spans or not run.window_s:
        return None
    return 100.0 * run.spans["get_wait"] / run.window_s
