"""molar_tpu_torch — the PyTorch/CUDA port of molar_tpu for NVIDIA Hopper.

The package mirrors ``molar_tpu``'s module layout (``core``, ``io``, ``ops``,
``tasks``) so each piece has an obvious counterpart, and imports neither
JAX nor ``molar_tpu``: the machine with the card has no JAX, and any
``molar_tpu`` import reaches ``core/state.py``'s JAX pytree registration.

Slice covered: the trajectory headline — XTC delta windows, on-device
decode, mass-weighted Kabsch RMSD, and the PBC ``within`` search through the
hand-written ghost-slab CUDA kernels (``csrc/cell_bin.cu`` and
``csrc/within_ghost.cu``, two launches a window), the per-pair min-image
kernel over the same binning (``csrc/within_rows.cu``, two launches a
window) or the triclinic correction path.
"""

from . import config
from .config import FLOAT, INDEX, require_cuda

__all__ = ["config", "FLOAT", "INDEX", "require_cuda"]
