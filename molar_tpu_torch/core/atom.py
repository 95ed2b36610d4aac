"""The owned per-atom row.

:class:`Atom` is the detached construction/interchange type (reference:
molar/src/atom.rs:135-167): IO readers and test fixtures assemble ``Atom``s and
:meth:`~molar_tpu.core.topology.Topology.from_atoms` scatters them into columns.
Bulk code never touches ``Atom`` — it reads the columns directly.

The port's own copy of ``molar_tpu.core.atom`` (numpy only).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional

from . import periodic_table as pt

IN_RING = 0x1
AROMATIC = 0x2


class BondOrder(enum.IntEnum):
    """Chemical bond order; formats that don't record it yield UNSPECIFIED
    (reference: molar/src/bond.rs:14-22)."""

    UNSPECIFIED = 0
    SINGLE = 1
    DOUBLE = 2
    TRIPLE = 3
    AROMATIC = 4


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

    def guess_element(self) -> "Atom":
        """Guess only Z, keeping an existing (file-provided) mass."""
        z = pt.guess_element_from_name(self.name, self.resname)
        return replace(self, atomic_number=z)

    @property
    def vdw(self) -> float:
        return pt.vdw_radius(self.atomic_number)

    @property
    def element_symbol(self) -> str:
        return pt.element_symbol(self.atomic_number)
