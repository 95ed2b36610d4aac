"""The end of a stream over several files, port against the JAX package.

Two 10-frame XTCs written by ``headline.write_trajectory`` (times 0-9 ps
each, so the times restart in the second file). The stream ends at its
first frame past ``-e``, in frame order across the files, as
``molar_tpu``'s ``TrajectoryReader.iter_states`` (the per-frame harness,
and the Rust runner it mirrors) does: the port's ``iter_windows`` at
windows of 1, 4 and 64 and its ``WindowAnalysisTask`` give the frame ids
of ``iter_states``, exactly. The JAX package's own ``iter_windows`` masks
each file on its own and keeps frames 10-15 too: a fault of the reference
that the port does not copy, pinned here. A frame-index end and every
begin already agree in all three; one case each keeps them so.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from molar_tpu.tasks.trajectory import FrameSpec as RefSpec
from molar_tpu.tasks.trajectory import TrajectoryReader as RefReader
from molar_tpu_torch.config import set_default_device
from molar_tpu_torch import headline
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.io.gro import write_gro
from molar_tpu_torch.tasks.trajectory import FrameSpec, TrajectoryReader, WindowAnalysisTask

N_ATOMS, N_PROTEIN, SIDE, N_FRAMES = 300, 30, 2.0, 10

# (-b, -e, --skip) -> the frame ids iter_states gives (checked below too).
CASES = {
    "end_5ps": (None, "5ps", 1, [0, 1, 2, 3, 4, 5]),
    "end_5ps_skip2": (None, "5ps", 2, [0, 2, 4]),
    "begin_3ps_end_5ps": ("3ps", "5ps", 1, [3, 4, 5]),
    "end_frame_12": (None, "12", 1, list(range(13))),
    "begin_frame_8_skip3": ("8", None, 3, [8, 11, 14, 17]),
    "begin_7ps": ("7ps", None, 1, [7, 8, 9, 17, 18, 19]),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for the module (the test workers share the cores),
    and the CPU as the device of ``device=None`` (the port's entry points
    take the card unless asked for the CPU); both restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = set_default_device("cpu")
    yield
    set_default_device(old)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("end")
    box = np.diag([SIDE] * 3).astype(np.float32)
    coords, _ = headline.make_system(N_ATOMS, N_PROTEIN, box)
    paths = [str(d / "a.xtc"), str(d / "b.xtc")]
    for seed, p in enumerate(paths):
        headline.write_trajectory(p, coords, box, N_FRAMES, seed=seed + 1)
    gro = str(d / "conf.gro")
    write_gro(gro, headline.label_topology(N_ATOMS, N_PROTEIN),
              State(coords=coords, box=PeriodicBox(box)))
    return gro, paths


def _ref_states(paths, begin, end, skip):
    reader = RefReader(paths, begin=RefSpec.parse(begin), end=RefSpec.parse(end), skip=skip)
    return [int(fr) for fr, _ in reader.iter_states()]


@pytest.mark.parametrize("window", [1, 4, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_iter_windows_ends_where_iter_states_does(files, case, window):
    _, paths = files
    begin, end, skip, want = CASES[case]
    assert _ref_states(paths, begin, end, skip) == want
    reader = TrajectoryReader(paths, begin=FrameSpec.parse(begin), end=FrameSpec.parse(end),
                              skip=skip)
    got = [int(i) for w in reader.iter_windows(window, quantized=True) for i in w[4]]
    assert got == want


class IdsTask(WindowAnalysisTask):
    def build(self, system):
        self.ids = []
        return lambda coords, boxes, invs: coords[:, 0]

    def accumulate(self, frame_ids, results):
        self.ids.extend(int(i) for i in frame_ids)


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_task_ends_where_iter_states_does(files, case):
    gro, paths = files
    begin, end, skip, want = CASES[case]
    argv = ["-f", gro, *paths, "--window", "4", "--skip", str(skip)]
    argv += ["-b", begin] if begin else []
    argv += ["-e", end] if end else []
    task = IdsTask()
    assert task.run(argv, device="cpu") == len(want)
    assert task.ids == want


def test_reference_iter_windows_keeps_frames_past_the_end(files):
    """The JAX package's ``iter_windows`` masks each file on its own: with
    ``-e 5ps`` it keeps frames 10-15 of the second file (with ``--skip 2``,
    10, 12 and 14), which ``iter_states`` drops. Pinned: the port does not
    copy it."""
    _, paths = files
    for skip, want in ((1, [0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14, 15]),
                       (2, [0, 2, 4, 10, 12, 14])):
        reader = RefReader(paths, end=RefSpec.parse("5ps"), skip=skip)
        got = [int(i) for w in reader.iter_windows(4, quantized=True) for i in w[4]]
        assert got == want
        assert _ref_states(paths, None, "5ps", skip) == [i for i in want if i < 10]
