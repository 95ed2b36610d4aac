"""Precision and device configuration of the port.

``FLOAT``/``INDEX`` match ``molar_tpu.config`` (f32 geometry, int32 atom
indices); ``NP_FLOAT``/``NP_INDEX`` are their numpy forms. Importing this
module pins every float32 product to full fp32: Hopper's TF32 tensor-core
path keeps ~10 mantissa bits, which breaks the 1e-5 RMSD contract the same
way the TPU's default bf16 MXU passes did.
"""

from __future__ import annotations

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


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("molar_tpu_torch: no CUDA device is available")
    return torch.device("cuda", 0)
