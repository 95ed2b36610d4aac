"""The caching allocator's ``cudaMalloc`` calls a window: the program's
counter ``device_allocs`` (read from ``torch.cuda.memory_stats`` at the
start and the end of ``run_with_overflow_retry``) over its ``windows``.
Start-up allocations are in the count, so over one window (the traced
run of the dodecahedron cell) it is the call's start-up cost, not a rate."""


def read(run):
    if "device_allocs" not in run.spans or not run.spans.get("windows"):
        return None
    return run.spans["device_allocs"] / run.spans["windows"]
