"""Engine selection from a measured crossover: torch on the CPU or the card.

The counterpart of ``molar_tpu.tasks.engine``. The port has no separate
numpy host pipeline: torch on the CPU is its host engine, so the
reference's ``"host"`` and ``"cpu"`` verdicts are both ``"cpu"`` here, and
``engine_device("host")`` is the CPU. The reference's ``JIT_FLOPS_FLOOR``
(below it, the dispatch of a jitted program cost more than the work) has
no counterpart: torch dispatches each operation eagerly, with no program
to compile or to amortise.

:data:`DEVICE_FLOPS_FLOOR` is the work of a window (operations a frame
times frames) at which the card starts to beat torch on the host's CPU. It
comes from the membrane engine sweep of ``chip_smoke.py`` on an NVIDIA H100
80GB HBM3 (700 W) against torch on its host's 8 CPU threads, a 16-frame
window through ``compute_window``: the card won at every size, 72 lipids
(4.9e7 operations a window) 816 against 99 fps up to 4,608 lipids 154
against 0.86, so the floor sits below the smallest size run.
"""

from __future__ import annotations

import torch

from .. import config

__all__ = [
    "accelerator_device",
    "cpu_device",
    "pick_engine",
    "engine_device",
    "DEVICE_FLOPS_FLOOR",
]

#: Work of a window (``per_frame_flops * frames``) from which the card wins.
DEVICE_FLOPS_FLOOR = 2.5e7


def cpu_device() -> torch.device:
    return torch.device("cpu")


def accelerator_device():
    """The first CUDA device, or None without one."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else None


def pick_engine(per_frame_flops: float, frames_per_call: int = 1) -> str:
    """``"cpu"`` or ``"device"`` for a window function: ``"device"`` when
    the window's work (``per_frame_flops`` x ``frames_per_call``) reaches
    :data:`DEVICE_FLOPS_FLOOR` and there is a card, else ``"cpu"``."""
    work = float(per_frame_flops) * max(1, int(frames_per_call))
    if work < DEVICE_FLOPS_FLOOR:
        return "cpu"
    return "device" if accelerator_device() is not None else "cpu"


def engine_device(engine: str) -> torch.device:
    """The torch device of an engine: ``"host"`` and ``"cpu"`` the CPU,
    ``"device"`` the first CUDA device (raises without one)."""
    if engine in ("host", "cpu"):
        return cpu_device()
    if engine == "device":
        return config.default_device()
    raise ValueError(f"unknown engine {engine!r} (host/cpu/device)")
