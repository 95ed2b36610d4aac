"""What the drivers share: the timed stream's end, the pipeline's own timings,
device timing of a resident window, and the object that per-layer readers
read."""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.profiler import record_function

#: Copies of the seeded file a timed stream may run through; it ends at its
#: deadline long before (a file of 256 frames at 10,000 frames/s for 51 s).
MAX_PASSES = 2000


def deadline_reader(paths, deadline: Optional[float], begin=None, end=None,
                    max_windows: Optional[int] = None):
    """A ``TrajectoryReader`` over ``paths`` (frames ``begin`` to ``end``)
    whose windows stop coming once ``deadline`` (``time.perf_counter()``)
    has passed, or after ``max_windows`` windows: the stream's client stops
    sending frames when the measured time is up. Each window's read is a
    ``portbench:read_window`` span."""
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader

    class DeadlineReader(TrajectoryReader):
        def iter_windows(self, *args, **kwargs):
            inner = super().iter_windows(*args, **kwargs)
            try:
                for k in itertools.count(1):
                    with record_function("portbench:read_window"):
                        item = next(inner, None)
                    if item is None:
                        return
                    yield item
                    if deadline is not None and time.perf_counter() >= deadline:
                        return
                    if max_windows is not None and k >= max_windows:
                        return
            finally:
                inner.close()

    return DeadlineReader(paths, begin=begin, end=end)


def seeded_order(seed: int, n_frames: int):
    """Frame 0, then the other frames of one walk in an order drawn from
    ``seed``. Which frames outgrow the program's tier-0 caps (and are run
    again) depends on the walk, so a walk of each seed's own would change
    the work with the seed; one walk in another order does not."""
    import numpy as np

    rest = np.random.default_rng([seed % (1 << 63), 1]).permutation(n_frames - 1)
    return np.concatenate([[0], 1 + rest])


def write_trajectory(path, config: dict, system: dict, seed: int) -> None:
    """The configuration's trajectory for a run of ``seed``: one walk from
    the structure (``frozen.codec.write_walk``, drawn from the
    configuration's ``structure_seed`` + 1), its frames in the seed's
    order."""
    from ..frozen import codec

    tr = config["trajectory"]
    codec.write_walk(path, system["coords"], system["box"], int(tr["frames"]),
                     float(tr["sigma_nm"]), seed=int(config["structure_seed"]) + 1,
                     precision=float(tr["xtc_precision"]), held=system["protein"],
                     held_rms=float(tr["protein_rms_nm"]),
                     order=seeded_order(seed, int(tr["frames"])))


def warm_ranges(n_file: int, window: int) -> list[tuple[int, int]]:
    """Frame ranges (first, last) whose windows have every shape a stream of
    the file in ``window``-frame windows has: two whole windows, and the
    file's shorter last window where there is one."""
    out = [(0, min(n_file, 2 * window) - 1)]
    if n_file % window and n_file > 2 * window:
        out.append((n_file - n_file % window, n_file - 1))
    return out


@contextlib.contextmanager
def pipelines():
    """Yield a list that receives every ``WindowPipeline`` the program makes
    inside the block, so that its ``timings`` (the program's own spans) can
    be read after a run; the class is restored on exit."""
    from molar_tpu_torch.tasks import trajectory

    made = []
    base = trajectory.WindowPipeline

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    trajectory.WindowPipeline = Recorded
    try:
        yield made
    finally:
        trajectory.WindowPipeline = base


@contextlib.contextmanager
def tf32():
    """Float32 matrix products on the tensor cores (TF32) inside the block:
    the precision of the correctness controls, one step below the float32
    with TF32 off that the port pins."""
    old = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn: Callable, device, min_seconds: float = 0.5, max_repeats: int = 50) -> float:
    """Milliseconds of one call of ``fn`` on the card, between two CUDA events
    over enough calls to fill ``min_seconds`` (at least 3), after one
    unmeasured call."""
    fn()
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    n = int(min(max_repeats, max(3, math.ceil(min_seconds * 1e3 / one))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@dataclass
class LayerRun:
    """What a per-layer metric's reader reads of one traced run.

    ``frames`` and ``window_s`` of the timed window; ``spans``: host seconds
    by name (the program's own timings and the benchmark's spans);
    ``busy_s`` and ``traced_s``: the device's busy seconds and the length of
    the traced window; ``card``: the card's name and power limit;
    ``device_ms(part)`` and ``work(part)``: a part of the program timed on
    the card on a resident window, and the work that window owes it
    (``flops``, ``bytes``), or None where this run has no such part;
    ``notes``: lines for standard error."""

    frames: int
    window_s: float
    spans: dict = field(default_factory=dict)
    busy_s: Optional[float] = None
    traced_s: Optional[float] = None
    card: str = ""
    parts: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    def device_ms(self, part: str) -> Optional[float]:
        entry = self.parts.get(part)
        return None if entry is None else entry()[0]

    def work(self, part: str) -> Optional[dict]:
        entry = self.parts.get(part)
        return None if entry is None else entry()[1]


def memo(fn):
    """``fn()`` once, its answer kept."""
    box = []

    def get():
        if not box:
            box.append(fn())
        return box[0]

    return get


@dataclass
class Window:
    """The timed window: end-to-end values by metric name, frames attempted,
    frames without a result, and lines for standard error."""

    e2e: dict
    attempted: int
    failed: int = 0
    notes: list = field(default_factory=list)

