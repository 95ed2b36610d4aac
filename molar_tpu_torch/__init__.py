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
the per-residue SASA workload, in plain torch. And the membrane pipeline
(``membrane``), the selection language (``selection``) with
``tasks.trajectory.WindowAnalysisTask``, espaloma partial charges
(``ff.espaloma``: the model file's GNN as a torch module), trjconv
(``io.trjconv`` over the XTC prefix decode and ``io.dcd``), the
``molar-torch`` command line (``cli``: ``info``, ``trjconv``), and frames
sharded over several devices (``parallel.mesh``: one process, a list of
devices, behind ``WindowPipeline``, the overflow retry, ``--mesh`` and the
workloads). And the user API of the host half: ``System`` / ``Sel`` /
``Particle`` (``core.system``), the structure and trajectory files behind
``io.FileHandler`` (PDB, GRO, XYZ, XTC, DCD; NDX groups), every ``Sel``
measure, DSSP / dss, host SASA and the per-frame ``tasks.trajectory.AnalysisTask``.
The top-level names are the JAX package's; importing them does no CUDA work.

Units: nm (length), ps (time), amu (mass), e (charge).
"""

from . import config
from .config import FLOAT, INDEX, require_cuda
from .core.atom import Atom, BondOrder
from .core.pbc import PBC_FULL, PBC_NONE, PbcDims, PeriodicBox, PeriodicBoxError
from .core.state import FrameBatch, State
from .core.system import Particle, Sel, SelectionError, System, distance_search
from .core.topology import Topology
from .selection import SelectionExpr, SelectionSyntaxError

__version__ = "0.5.0"

__all__ = [
    "config", "FLOAT", "INDEX", "require_cuda", "Atom", "BondOrder", "FrameBatch", "PBC_FULL",
    "PBC_NONE", "PbcDims", "PeriodicBox", "PeriodicBoxError", "State", "Topology", "Particle",
    "Sel", "SelectionError", "System", "distance_search", "SelectionExpr",
    "SelectionSyntaxError", "fit_transform", "fit_transform_matching", "rmsd_py", "rmsd_mw",
]


# pymolar's module-level entry points over two selections (molar.pyi:203-208);
# natively they are Sel methods.


def fit_transform(sel1: Sel, sel2: Sel):
    """(rotation, translation) fitting ``sel1`` onto ``sel2``."""
    return sel1.fit_transform(sel2)


def fit_transform_matching(sel1: Sel, sel2: Sel):
    return sel1.fit_transform_matching(sel2)


def rmsd_py(sel1: Sel, sel2: Sel) -> float:
    """Unweighted RMSD (pymolar naming; natively ``sel1.rmsd(sel2)``)."""
    return sel1.rmsd(sel2)


def rmsd_mw(sel1: Sel, sel2: Sel) -> float:
    return sel1.rmsd_mw(sel2)
