"""molar_tpu_torch — the PyTorch/CUDA port of molar_tpu for NVIDIA Hopper.

The package mirrors ``molar_tpu``'s module layout (``core``, ``io``, ``ops``,
``tasks``) so each piece has an obvious counterpart, and imports neither
JAX nor ``molar_tpu``: the machine with the card has no JAX, and any
``molar_tpu`` import reaches ``core/state.py``'s JAX pytree registration.

Slice covered: the trajectory headline — XTC windows of raw i16 ints, on-device
decode, mass-weighted Kabsch RMSD, and the PBC ``within`` search through the
hand-written ghost-slab CUDA kernels (``csrc/cell_bin.cu`` and
``csrc/within_ghost.cu``, two launches a window), the per-pair min-image
kernel over the same binning (``csrc/within_rows.cu``, two launches a
window) or the triclinic correction path. And the selection workloads
(``workloads``): CA-RMSD, per-residue COM and gyration, contact lists and
the three fused, streamed over windows of the selections' rows, in plain
torch (``ops.measure``, ``ops.neighbor.contact_pairs*``). And SASA: exact
Lee-Richards (``ops.sasa_lr``: lists built on the device, the interval
union by a sort and a running maximum), Shrake-Rupley (``ops.sasa``) and
the per-residue SASA workload, in plain torch.
"""

from . import config
from .config import FLOAT, INDEX, require_cuda

__all__ = ["config", "FLOAT", "INDEX", "require_cuda"]
