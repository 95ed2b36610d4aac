"""Precision and device configuration of the port.

``FLOAT``/``INDEX`` match ``molar_tpu.config`` (f32 geometry, int32 atom
indices); ``NP_FLOAT``/``NP_INDEX`` are their numpy forms. Importing this
module pins every float32 product to full fp32: Hopper's TF32 tensor-core
path keeps ~10 mantissa bits, which breaks the 1e-5 RMSD contract the same
way the TPU's default bf16 MXU passes did.

The device rule: every entry point that takes ``device=None`` resolves it
through :func:`resolve_device`, at its first computing call (never at import
and never while a file is read). ``None`` is the card
(:func:`default_device`), which raises where there is none; the CPU runs
only when the caller asks for it, by ``device="cpu"`` or once for the
process by :func:`set_default_device` (the CPU tests do). Nothing falls
back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: Dtype of all geometric data (coords, boxes, masses).
FLOAT = torch.float32

#: Dtype of atom indices and cell ids.
INDEX = torch.int32

#: The numpy dtypes of the host half (topology columns, host states): the
#: same f32 geometry and int32 indices.
NP_FLOAT = np.float32
NP_INDEX = np.int32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


#: The device ``None`` stands for when a caller has set one for the process
#: (:func:`set_default_device`); None is the card.
_default_device: Optional[torch.device] = None


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("molar_tpu_torch: no CUDA device is available")
    return torch.device("cuda", 0)


def set_default_device(device) -> Optional[torch.device]:
    """Make ``device`` (``"cpu"``, say) what ``device=None`` means for the
    rest of the process; None gives it back to the card. Returns the
    previous setting, so a caller can restore it."""
    global _default_device
    old = _default_device
    _default_device = None if device is None else torch.device(device)
    return old


def default_device() -> torch.device:
    """The device of ``device=None``: the one :func:`set_default_device`
    set, else the first CUDA device (raises without one)."""
    return _default_device if _default_device is not None else require_cuda()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None through :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def on_host(device: torch.device) -> bool:
    """Whether a computing call on ``device`` takes the host's numpy
    functions (the CPU) rather than the card's torch ones. The one place
    ``Sel`` and the CLI decide their route (a test may substitute it to
    drive the card's functions on CPU tensors)."""
    return device.type == "cpu"
