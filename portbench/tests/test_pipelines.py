"""``drivers.common.pipelines`` records every ``WindowPipeline`` the program
builds inside its block, whatever name the building module imported the
class under, and leaves the class as it was after the block."""

from __future__ import annotations

import pytest
import torch

from portbench.drivers.common import pipelines


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_a_pipeline_built_under_an_imported_name_is_recorded(tmp_path):
    """The membrane stream builds its pipeline from the name that
    ``molar_tpu_torch.workloads`` imported; its timings are readable."""
    from molar_tpu_torch import workloads
    from molar_tpu_torch.membrane.device import MembraneDevice
    from molar_tpu_torch.tasks.trajectory import TrajectoryReader, WindowPipeline

    init = WindowPipeline.__init__
    bilayer = workloads.synth_bilayer(2, 2)
    xtc = str(tmp_path / "membrane.xtc")
    workloads.write_membrane_xtc(bilayer, xtc, 4)
    dev = MembraneDevice(bilayer.spec, bilayer.coords, bilayer.box, device="cpu")
    with pipelines() as made:
        frames, _ = workloads.stream_membrane(dev, TrajectoryReader([xtc]), 2)
    assert frames == 4 and len(made) == 1
    assert made[0].timings["windows"] == 2
    assert made[0].timings["decode"] > 0 and made[0].timings["enqueue"] > 0
    assert WindowPipeline.__init__ is init and workloads.WindowPipeline is WindowPipeline
    workloads.WindowPipeline(None, 2, None, "cpu")
    assert len(made) == 1


def test_the_class_is_restored_when_the_block_raises():
    from molar_tpu_torch.tasks.trajectory import WindowPipeline

    init = WindowPipeline.__init__
    with pytest.raises(RuntimeError), pipelines():
        assert WindowPipeline.__init__ is not init
        raise RuntimeError("inside the block")
    assert WindowPipeline.__init__ is init
