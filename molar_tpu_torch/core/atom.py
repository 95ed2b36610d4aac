"""The owned per-atom row.

:class:`Atom` is the detached construction/interchange type (reference:
molar/src/atom.rs:135-167): IO readers and test fixtures assemble ``Atom``s and
:meth:`~molar_tpu.core.topology.Topology.from_atoms` scatters them into columns.
Bulk code never touches ``Atom`` — it reads the columns directly.

The port's own copy of the parts of ``molar_tpu.core.atom`` that
:class:`~molar_tpu_torch.core.topology.Topology` and the GRO reader need
(``Atom`` and its element guess; the port's topology carries no bond
orders, so ``BondOrder`` is not copied).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from . import periodic_table as pt


@dataclass
class Atom:
    """One atom's properties (reference field set: molar/src/atom.rs:135-167).

    ``resid`` may be negative and repeat; ``resindex`` is the 0-based contiguous
    -run index assigned by ``Topology.assign_resindex``. Optional force-field /
    chemistry fields default to ``None`` ("never assigned").
    """

    name: str = ""
    resname: str = "UNK"
    resid: int = 1
    resindex: int = 0
    atomic_number: int = 0
    mass: float = 0.0
    charge: float = 0.0
    chain: str = " "
    bfactor: float = 0.0
    occupancy: float = 0.0
    type_name: Optional[str] = None
    type_id: Optional[int] = None
    formal_charge: Optional[int] = None
    flags: Optional[int] = None

    def guess_element_and_mass(self) -> "Atom":
        """Guess Z (and mass) from the atom name; see
        :func:`molar_tpu.core.periodic_table.guess_element_from_name`."""
        z = pt.guess_element_from_name(self.name, self.resname)
        return replace(self, atomic_number=z, mass=pt.mass_of(z))
