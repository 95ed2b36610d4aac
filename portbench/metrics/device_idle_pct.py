"""Share of the traced window in which no operation ran on the device: 100 x
(1 - the union of the device operations' intervals / the window)."""


def read(run):
    if run.busy_s is None or not run.traced_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
