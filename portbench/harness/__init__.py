"""The harness's general parts: the benchmark file, traces, work counts, checks."""
